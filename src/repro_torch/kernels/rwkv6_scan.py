"""The RWKV6 WKV recurrence and its backward: the CUDA kernels and their
plain versions.

:func:`rwkv6_scan` launches the kernel of ``csrc/rwkv6_scan.cu`` (a
block per (batch, head, group of value columns) walking the whole
sequence, the columns split by shape so that the heads fill the SMs,
each thread holding a tile of the state in registers, steps staged
through a ring in shared memory) for CUDA tensors, which replaces
the TPU kernel of the JAX package (``rwkv6_scan_pallas``), and runs
:func:`rwkv6_scan_plain` for CPU tensors.

Under autograd on the card the forward launch also writes the fp32
state every :data:`CKPT` steps (:func:`rwkv6_scan_checkpoints`), and
the backward launches ``csrc/rwkv6_scan_bwd.cu`` (:func:`rwkv6_scan_bwd`),
which recomputes each chunk's states from those checkpoints and runs the
reverse recurrence: it replaces ``jax.grad`` of the JAX package's
chunked scan, which no Pallas kernel covers.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import FLOAT_CODES, aligned, float_code, \
    launch, use_kernel
from repro_torch.kernels.ref import rwkv6_scan_bwd_plain, rwkv6_scan_plain

#: head sizes the kernel is built for: the smoke configs' and
#: rwkv6-1.6b's
HEAD_SIZES = (32, 64)
#: steps between two state checkpoints of the forward under autograd: a
#: multiple of the forward's stage (1024 / dh steps) and of 16, at most
#: 256 (the backward walks 8-step sub-chunks and keeps a chunk's
#: sub-checkpoints in shared memory: at 64, four of its blocks share an
#: SM).  They take B * H * ceil(T / CKPT) * dh * dh * 4 bytes: 64 MB a
#: layer at rwkv6-1.6b's training shape (4, 2048, 32, 64), alive from a
#: layer's forward to its backward.  The results do not depend on it.
CKPT = 64

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "rwkv6_scan_checkpoints",
           "rwkv6_scan_bwd", "rwkv6_scan_bwd_plain", "bwd_scratch_floats",
           "HEAD_SIZES", "CKPT"]


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


def _check_every(every: int, dh: int) -> None:
    if every <= 0 or every > 256 or every % 16 or every % (1024 // dh):
        raise ValueError(f"checkpoints every {every} steps: the kernels "
                         f"take a multiple of 16 and of {1024 // dh} up to "
                         f"256")


def _outputs(r: torch.Tensor):
    """y in r's type and shape, and the final state (B, H, dh, dh)
    fp32."""
    b, _, h, dh = r.shape
    return torch.empty_like(r), torch.empty((b, h, dh, dh),
                                            dtype=torch.float32,
                                            device=r.device)


def _forward(r, k, v, w, bonus, initial_state, every: Optional[int]):
    """One launch of the forward kernel: (y, final state, checkpoints or
    None)."""
    code = _check(r, k, v, w, bonus, initial_state)
    if bonus.dtype != torch.float32 or not bonus.is_contiguous():
        bonus = bonus.to(torch.float32).contiguous()
    b, t, h, dh = r.shape
    y, state = _outputs(r)
    ckpt = None
    if every is not None:
        _check_every(every, dh)
        ckpt = torch.empty((b, h, -(-t // every), dh, dh),
                           dtype=torch.float32, device=r.device)
    launch("rwkv6_scan", r.get_device(), r.data_ptr(), k.data_ptr(),
           v.data_ptr(), w.data_ptr(), bonus.data_ptr(),
           None if initial_state is None else initial_state.data_ptr(),
           y.data_ptr(), state.data_ptr(),
           None if ckpt is None else ckpt.data_ptr(), b, t, h, dh, code,
           0 if every is None else every)
    rwkv6_scan.launches += 1
    return y, state, ckpt


class _WKVScan(torch.autograd.Function):
    """The WKV recurrence under autograd: the checkpointing forward, then
    :func:`rwkv6_scan_bwd`.  Both route by device, so on CPU tensors this
    runs the plain forward and the plain reverse recurrence (what the CPU
    tests hold to the JAX package's gradients)."""

    @staticmethod
    def forward(ctx, r, k, v, w, bonus, initial_state):
        y, state, ckpt = rwkv6_scan_checkpoints(r, k, v, w, bonus,
                                                initial_state)
        ctx.save_for_backward(r, k, v, w, bonus, ckpt)
        ctx.set_materialize_grads(False)
        ctx.has_initial_state = initial_state is not None
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, bonus, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else aligned(dy)
        if dstate is not None:
            dstate = aligned(dstate)
        dr, dk, dv, dw, du, ds0 = rwkv6_scan_bwd(r, k, v, w, bonus, ckpt,
                                                 dy, dstate)
        return (dr, dk, dv, dw, du.to(bonus.dtype),
                ds0 if ctx.has_initial_state else None)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, bonus: torch.Tensor,
               initial_state: Optional[torch.Tensor] = None):
    """The WKV recurrence over r/k/v/w (B, T, H, dh), T >= 1, with bonus
    (H, dh) and an fp32 initial state (B, H, dh, dh) (None: zeros).
    Returns (y (B, T, H, dh) in r's type, final state (B, H, dh, dh)
    fp32).  CUDA tensors (r/k/v/w contiguous, 16-byte aligned, of one
    type of fp32 / bf16; dh in :data:`HEAD_SIZES`) launch the kernel and
    add one to ``rwkv6_scan.launches``; under grad mode with an input
    that requires a gradient (fp32 only: bf16 raises) the launch also
    writes checkpoints and the result carries a gradient, which
    :func:`rwkv6_scan_bwd` computes.  CPU tensors run
    :func:`rwkv6_scan_plain`, which autograd differentiates."""
    if not (use_kernel(r, k, v, w, bonus) if initial_state is None
            else use_kernel(r, k, v, w, bonus, initial_state)):
        return rwkv6_scan_plain(r, k, v, w, bonus, initial_state)
    if torch.is_grad_enabled() and (
            r.requires_grad or k.requires_grad or v.requires_grad
            or w.requires_grad or bonus.requires_grad
            or (initial_state is not None and initial_state.requires_grad)):
        if r.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan under autograd takes fp32 r, k, v "
                            f"and w (the model casts them so), got "
                            f"{r.dtype}: the backward kernel is fp32 only")
        return _WKVScan.apply(r, k, v, w, bonus, initial_state)
    y, state, _ = _forward(r, k, v, w, bonus, initial_state, None)
    return y, state


def _checkpoints_plain(r, k, v, w, bonus, initial_state, every):
    """The plain forward in chunks of ``every`` steps, keeping the state
    before each: what the kernel writes."""
    b, t, h, dh = r.shape
    state = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=r.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys, ckpts = [], []
    for t0 in range(0, t, every):
        ckpts.append(state)
        sl = slice(t0, t0 + every)
        y, state = rwkv6_scan_plain(r[:, sl], k[:, sl], v[:, sl], w[:, sl],
                                    bonus, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state, torch.stack(ckpts, dim=2)


def rwkv6_scan_checkpoints(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor,
                           bonus: torch.Tensor,
                           initial_state: Optional[torch.Tensor] = None,
                           every: int = CKPT):
    """:func:`rwkv6_scan` with the state before every ``every``-th step
    kept: returns (y, final state, checkpoints (B, H, ceil(T / every),
    dh, dh) fp32), checkpoint c the state before step c * every (0: the
    initial state).  CUDA tensors: one launch of the forward kernel,
    counted in ``rwkv6_scan.launches``; y and the final state equal the
    serving launch's bit for bit.  CPU tensors run the plain version
    chunk by chunk."""
    state_in = () if initial_state is None else (initial_state,)
    if not use_kernel(r, k, v, w, bonus, *state_in):
        return _checkpoints_plain(r, k, v, w, bonus, initial_state, every)
    return _forward(r, k, v, w, bonus, initial_state, every)


def bwd_scratch_floats(b: int, h: int, dh: int) -> int:
    """The backward kernel's device scratch, in floats: du's partial of
    each (batch, head), B * H * dh, whatever T is (dv is summed across a
    head's row groups in the cluster's shared memory)."""
    return b * h * dh


def bwd_resident_blocks(dh: int, every: int = CKPT) -> int:
    """Blocks of the backward kernel at head size ``dh`` that the current
    CUDA device holds at once with checkpoints ``every`` steps apart (its
    clusters of dh / 16 blocks; a call on the card, building the kernel at
    first use)."""
    _check_every(every, dh)
    n = build.entry("rwkv6_scan_bwd", "rwkv6_scan_bwd_resident",
                    [ctypes.c_int, ctypes.c_int])(dh, every)
    if n <= 0:
        raise RuntimeError(f"occupancy query of the WKV backward at dh {dh}, "
                           f"every {every} failed")
    return n


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, bonus: torch.Tensor,
                   checkpoints: torch.Tensor, dy: torch.Tensor,
                   dstate: Optional[torch.Tensor] = None,
                   every: int = CKPT):
    """The gradients of :func:`rwkv6_scan` at r, k, v, w, bonus from the
    checkpoints :func:`rwkv6_scan_checkpoints` wrote (``every`` steps
    apart), against y's gradient ``dy`` and the final state's ``dstate``
    (None: zeros).  Returns (dr, dk, dv, dw (B, T, H, dh), dbonus (H, dh),
    the initial state's gradient (B, H, dh, dh)), all fp32.  CUDA tensors
    (fp32, contiguous, 16-byte aligned) launch the backward kernel and add
    one to ``rwkv6_scan_bwd.launches``; CPU tensors run
    :func:`rwkv6_scan_bwd_plain` from the first checkpoint."""
    state_in = () if dstate is None else (dstate,)
    if not use_kernel(r, k, v, w, bonus, checkpoints, dy, *state_in):
        return rwkv6_scan_bwd_plain(r, k, v, w, bonus,
                                    checkpoints[:, :, 0], dy, dstate)
    if _check(r, k, v, w, bonus, None) != FLOAT_CODES[torch.float32]:
        raise TypeError("the WKV backward kernel takes fp32 r, k, v, w")
    b, t, h, dh = r.shape
    _check_every(every, dh)
    float_code(r, dy, checkpoints, *state_in)
    if dy.shape != r.shape:
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected "
                         f"{tuple(r.shape)}")
    if checkpoints.shape != (b, h, -(-t // every), dh, dh):
        raise ValueError(f"checkpoints of shape {tuple(checkpoints.shape)} "
                         f"are not every {every} steps of {t}")
    if dstate is not None and dstate.shape != (b, h, dh, dh):
        raise ValueError(f"dstate has shape {tuple(dstate.shape)}, "
                         f"expected ({b}, {h}, {dh}, {dh})")
    bonus = bonus.to(torch.float32).contiguous()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(bonus)
    ds0 = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    scratch = torch.empty(bwd_scratch_floats(b, h, dh), dtype=torch.float32,
                          device=r.device)
    if any(x.data_ptr() % 16 for x in (dy, checkpoints, bonus) + state_in):
        raise ValueError("the WKV backward reads 16-byte aligned tensors")
    launch("rwkv6_scan_bwd", r.get_device(), r.data_ptr(), k.data_ptr(),
           v.data_ptr(), w.data_ptr(), bonus.data_ptr(),
           checkpoints.data_ptr(), dy.data_ptr(),
           None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
           ds0.data_ptr(), scratch.data_ptr(), b, t, h, dh, every)
    rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


#: kernel launches since the count was last set to 0
rwkv6_scan.launches = 0
rwkv6_scan_bwd.launches = 0
