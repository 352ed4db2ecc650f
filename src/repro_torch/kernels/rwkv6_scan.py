"""The RWKV6 WKV recurrence: the CUDA kernel and its plain version.

:func:`rwkv6_scan` launches the kernel of ``csrc/rwkv6_scan.cu`` (a
block per (batch, head, group of value columns) walking the whole
sequence, the columns split by shape so that the heads fill the SMs,
each thread holding a tile of the state in registers, steps staged
through a ring in shared memory) for CUDA tensors, which replaces
the TPU kernel of the JAX package (``rwkv6_scan_pallas``), and runs
:func:`rwkv6_scan_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.backend import float_code, launch, use_kernel
from repro_torch.kernels.ref import rwkv6_scan_plain

#: head sizes the kernel is built for: the smoke configs' and
#: rwkv6-1.6b's
HEAD_SIZES = (32, 64)

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "HEAD_SIZES"]


def _check(r, k, v, w, bonus, initial_state) -> int:
    """Raise unless the kernel takes these tensors (shapes, types,
    contiguity, and the alignment its vector loads need); returns the
    float type code of r/k/v/w."""
    if r.ndim != 4 or not r.shape == k.shape == v.shape == w.shape:
        raise ValueError("r, k, v and w must share one (B, T, H, dh) shape")
    b, t, h, dh = r.shape
    if t < 1 or b < 1 or h < 1:
        raise ValueError(f"empty sequence batch {tuple(r.shape)}")
    if dh not in HEAD_SIZES:
        raise ValueError(f"head size {dh}; the kernel is built for "
                         f"{HEAD_SIZES}")
    if bonus.shape != (h, dh):
        raise ValueError(f"bonus has shape {tuple(bonus.shape)}, "
                         f"expected ({h}, {dh})")
    code = float_code(r, k, v, w)
    if (r.data_ptr() | k.data_ptr() | v.data_ptr() | w.data_ptr()) % 16:
        raise ValueError("r, k, v and w must be 16-byte aligned")
    if initial_state is not None:
        if initial_state.shape != (b, h, dh, dh):
            raise ValueError(f"initial_state has shape "
                             f"{tuple(initial_state.shape)}, expected "
                             f"({b}, {h}, {dh}, {dh})")
        if (initial_state.dtype != torch.float32
                or not initial_state.is_contiguous()):
            raise TypeError("initial_state must be contiguous float32")
    return code


def _outputs(r: torch.Tensor):
    """y in r's type and shape, and the final state (B, H, dh, dh)
    fp32."""
    b, _, h, dh = r.shape
    return torch.empty_like(r), torch.empty((b, h, dh, dh),
                                            dtype=torch.float32,
                                            device=r.device)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, bonus: torch.Tensor,
               initial_state: Optional[torch.Tensor] = None):
    """The WKV recurrence over r/k/v/w (B, T, H, dh), T >= 1, with bonus
    (H, dh) and an fp32 initial state (B, H, dh, dh) (None: zeros).
    Returns (y (B, T, H, dh) in r's type, final state (B, H, dh, dh)
    fp32).  CUDA tensors (r/k/v/w contiguous, 16-byte aligned, of one
    type of fp32 / bf16; dh in :data:`HEAD_SIZES`) launch the kernel and
    add one to ``rwkv6_scan.launches``; they raise
    ``NotImplementedError`` under grad mode when an input requires a
    gradient (the kernel has no backward yet).  CPU tensors run
    :func:`rwkv6_scan_plain`, which autograd differentiates."""
    if not (use_kernel(r, k, v, w, bonus) if initial_state is None
            else use_kernel(r, k, v, w, bonus, initial_state)):
        return rwkv6_scan_plain(r, k, v, w, bonus, initial_state)
    if torch.is_grad_enabled() and (
            r.requires_grad or k.requires_grad or v.requires_grad
            or w.requires_grad or bonus.requires_grad
            or (initial_state is not None and initial_state.requires_grad)):
        raise NotImplementedError(
            "rwkv6_scan has no backward kernel yet: rwkv6 training on the "
            "card waits for it (ROADMAP.md section 1, item 7)")
    code = _check(r, k, v, w, bonus, initial_state)
    if bonus.dtype != torch.float32 or not bonus.is_contiguous():
        bonus = bonus.to(torch.float32).contiguous()
    y, state = _outputs(r)
    b, t, h, dh = r.shape
    launch("rwkv6_scan", r.get_device(), r.data_ptr(), k.data_ptr(),
           v.data_ptr(), w.data_ptr(), bonus.data_ptr(),
           None if initial_state is None else initial_state.data_ptr(),
           y.data_ptr(), state.data_ptr(), b, t, h, dh, code)
    rwkv6_scan.launches += 1
    return y, state


#: kernel launches since the count was last set to 0
rwkv6_scan.launches = 0
