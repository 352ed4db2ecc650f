"""Mamba's selective scan and its backward: the CUDA kernels and their
plain versions.

:func:`selective_scan` launches the kernel of ``csrc/selective_scan.cu``
(a thread per (batch row, channel) holding the channel's d_state fp32
states in registers and walking the sequence; a block's 128 channels
share each step's b and c, staged in shared memory; the skip
``y + x * d_skip`` fused) for CUDA tensors and runs
:func:`selective_scan_plain` for CPU tensors.  It replaces the JAX
package's chunked ``lax.scan`` of ``repro.models.mamba._ssm_step`` (and
its skip), which no Pallas kernel covers: walked step by step on the
card it would be thousands of launches a layer.

Under autograd on the card the forward launch also writes the fp32 state
every :data:`CKPT` steps (:func:`selective_scan_checkpoints`), and the
backward launches ``csrc/selective_scan_bwd.cu``
(:func:`selective_scan_bwd`): per chunk, in the reverse order, it
recomputes the chunk's states from its checkpoint into shared memory and
carries the state's gradient back; db and dc (sums over the channels)
and da and dd_skip (sums over the batch) leave per-block partials that a
second kernel sums in a fixed order (no atomics).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.backend import aligned, launch, use_kernel
from repro_torch.kernels.ref import (selective_scan_bwd_plain,
                                     selective_scan_plain)

#: the state sizes the kernels are built for: the smoke config's and
#: jamba's (``MambaConfig.d_state``)
STATE_SIZES = (8, 16)
#: channels of a block: d_inner must be a multiple of it
BLOCK_CHANNELS = 128
#: steps between two state checkpoints of the forward under autograd (the
#: backward holds a chunk's states in shared memory, CKPT * d_state * 128
#: floats a block); they take B * ceil(T / CKPT) * D * N * 4 bytes, twice
#: an fp32 (B, T, D) tensor at d_state 16, alive from a layer's forward to
#: its backward.  The results do not depend on it.
CKPT = 8

__all__ = ["selective_scan", "selective_scan_plain",
           "selective_scan_checkpoints", "selective_scan_bwd",
           "selective_scan_bwd_plain", "bwd_scratch_floats", "STATE_SIZES",
           "BLOCK_CHANNELS", "CKPT"]


def _check(dt, a, b, c, x, d_skip, initial_state) -> None:
    """Raise unless the kernels take these tensors: fp32, contiguous,
    16-byte aligned, d_state in :data:`STATE_SIZES` and d_inner a multiple
    of :data:`BLOCK_CHANNELS`."""
    if dt.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"dt {tuple(dt.shape)} and x {tuple(x.shape)} must "
                         f"share one (B, T, D) shape")
    bsz, t, d = dt.shape
    if bsz < 1 or t < 1:
        raise ValueError(f"empty sequence batch {tuple(dt.shape)}")
    n = a.shape[-1]
    if n not in STATE_SIZES:
        raise ValueError(f"d_state {n}; the kernels are built for "
                         f"{STATE_SIZES}")
    if d % BLOCK_CHANNELS:
        raise ValueError(f"d_inner {d}: the kernels take a multiple of "
                         f"{BLOCK_CHANNELS}")
    for name, v, shape in (("a", a, (d, n)), ("b", b, (bsz, t, n)),
                           ("c", c, (bsz, t, n)), ("d_skip", d_skip, (d,)),
                           ("initial_state", initial_state, (bsz, d, n))):
        if v is not None and tuple(v.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"{shape}")
    inputs = [v for v in (dt, a, b, c, x, d_skip, initial_state)
              if v is not None]
    if any(v.dtype != torch.float32 for v in inputs):
        raise TypeError(f"the selective scan kernels take fp32 inputs (the "
                        f"model casts them so), got "
                        f"{sorted({str(v.dtype) for v in inputs})}")
    if any(not v.is_contiguous() or v.data_ptr() % 16 for v in inputs):
        raise ValueError("the selective scan kernels take contiguous, "
                         "16-byte aligned tensors")


def _forward(dt, a, b, c, x, d_skip, initial_state, checkpoints: bool):
    """One launch of the forward kernel: (y, final state, checkpoints or
    None)."""
    _check(dt, a, b, c, x, d_skip, initial_state)
    bsz, t, d = dt.shape
    n = a.shape[1]
    y = torch.empty_like(dt)
    state = torch.empty((bsz, d, n), dtype=torch.float32, device=dt.device)
    ckpt = (torch.empty((bsz, -(-t // CKPT), d, n), dtype=torch.float32,
                        device=dt.device) if checkpoints else None)
    launch("selective_scan", dt.get_device(), dt.data_ptr(), a.data_ptr(),
           b.data_ptr(), c.data_ptr(), x.data_ptr(), d_skip.data_ptr(),
           None if initial_state is None else initial_state.data_ptr(),
           y.data_ptr(), state.data_ptr(),
           None if ckpt is None else ckpt.data_ptr(), bsz, t, d, n)
    selective_scan.launches += 1
    return y, state, ckpt


class _SelectiveScan(torch.autograd.Function):
    """The scan under autograd: the checkpointing forward, then
    :func:`selective_scan_bwd`.  Both route by device, so on CPU tensors
    this runs the plain forward and the plain reverse recurrence."""

    @staticmethod
    def forward(ctx, dt, a, b, c, x, d_skip, initial_state):
        y, state, ckpt = selective_scan_checkpoints(dt, a, b, c, x, d_skip,
                                                    initial_state)
        ctx.save_for_backward(dt, a, b, c, x, d_skip, ckpt)
        ctx.set_materialize_grads(False)
        ctx.has_initial_state = initial_state is not None
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        dt, a, b, c, x, d_skip, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(dt) if dy is None else aligned(dy)
        if dstate is not None:
            dstate = aligned(dstate)
        ddt, da, db, dc, dx, dds, ds0 = selective_scan_bwd(
            dt, a, b, c, x, d_skip, ckpt, dy, dstate)
        return (ddt, da, db, dc, dx, dds,
                ds0 if ctx.has_initial_state else None)


def selective_scan(dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, x: torch.Tensor, d_skip: torch.Tensor,
                   initial_state: Optional[torch.Tensor] = None):
    """The selective scan of Mamba over dt, x (B, T, D) with a (D, N),
    b, c (B, T, N), the skip d_skip (D) and an fp32 initial state
    (B, D, N) (None: zeros).  Returns (y (B, T, D) with the skip added,
    final state (B, D, N)), fp32.  CUDA tensors (fp32, contiguous, 16-byte
    aligned; N in :data:`STATE_SIZES`; D a multiple of
    :data:`BLOCK_CHANNELS`) launch the kernel and add one to
    ``selective_scan.launches``; under grad mode with an input that
    requires a gradient the launch also writes checkpoints and the result
    carries a gradient, which :func:`selective_scan_bwd` computes.  CPU
    tensors run :func:`selective_scan_plain`, which autograd
    differentiates."""
    inputs = (dt, a, b, c, x, d_skip) + (
        () if initial_state is None else (initial_state,))
    if not use_kernel(*inputs):
        return selective_scan_plain(dt, a, b, c, x, d_skip, initial_state)
    if torch.is_grad_enabled() and any(v.requires_grad for v in inputs):
        return _SelectiveScan.apply(dt, a, b, c, x, d_skip, initial_state)
    y, state, _ = _forward(dt, a, b, c, x, d_skip, initial_state, False)
    return y, state


def _checkpoints_plain(dt, a, b, c, x, d_skip, initial_state):
    """The plain forward in chunks of :data:`CKPT` steps, keeping the
    state before each: what the kernel writes."""
    bsz, t, d = dt.shape
    state = (torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32,
                         device=dt.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys, ckpts = [], []
    for t0 in range(0, t, CKPT):
        ckpts.append(state)
        sl = slice(t0, t0 + CKPT)
        y, state = selective_scan_plain(dt[:, sl], a, b[:, sl], c[:, sl],
                                        x[:, sl], d_skip, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state, torch.stack(ckpts, dim=1)


def selective_scan_checkpoints(dt: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor, c: torch.Tensor,
                               x: torch.Tensor, d_skip: torch.Tensor,
                               initial_state: Optional[torch.Tensor] = None):
    """:func:`selective_scan` with the state before every :data:`CKPT`-th
    step kept: returns (y, final state, checkpoints (B, ceil(T / CKPT), D,
    N) fp32), checkpoint k the state before step k * CKPT (0: the initial
    state).  CUDA tensors: one launch of the forward kernel, counted in
    ``selective_scan.launches``; y and the final state equal the serving
    launch's bit for bit.  CPU tensors run the plain version chunk by
    chunk."""
    inputs = (dt, a, b, c, x, d_skip) + (
        () if initial_state is None else (initial_state,))
    if not use_kernel(*inputs):
        return _checkpoints_plain(dt, a, b, c, x, d_skip, initial_state)
    return _forward(dt, a, b, c, x, d_skip, initial_state, True)


def bwd_scratch_floats(b: int, t: int, d: int, n: int) -> int:
    """The backward kernel's device scratch, in floats: each block's
    partial sums of db and dc over its 128 channels, (D / 128) * B * T *
    2N (a quarter of an fp32 (B, T, D) tensor at d_state 16), and each
    batch row's of da and dd_skip, B * D * (N + 1)."""
    return (d // BLOCK_CHANNELS) * b * t * 2 * n + b * d * (n + 1)


def selective_scan_bwd(dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, x: torch.Tensor, d_skip: torch.Tensor,
                       checkpoints: torch.Tensor, dy: torch.Tensor,
                       dstate: Optional[torch.Tensor] = None):
    """The gradients of :func:`selective_scan` from the checkpoints
    :func:`selective_scan_checkpoints` wrote, against y's gradient ``dy``
    and the final state's ``dstate`` (None: zeros).  Returns (ddt, da
    (D, N), db, dc (B, T, N), dx, dd_skip (D), the initial state's gradient
    (B, D, N)), all fp32.  CUDA tensors launch the backward kernel (two
    kernels: the reverse recurrence, then the fixed order sums of the
    partials) and add one to ``selective_scan_bwd.launches``; CPU tensors
    run :func:`selective_scan_bwd_plain` from the first checkpoint."""
    extra = () if dstate is None else (dstate,)
    if not use_kernel(dt, a, b, c, x, d_skip, checkpoints, dy, *extra):
        return selective_scan_bwd_plain(dt, a, b, c, x, d_skip,
                                        checkpoints[:, 0], dy, dstate)
    _check(dt, a, b, c, x, d_skip, dstate)
    bsz, t, d = dt.shape
    n = a.shape[1]
    if checkpoints.shape != (bsz, -(-t // CKPT), d, n):
        raise ValueError(f"checkpoints of shape {tuple(checkpoints.shape)} "
                         f"are not every {CKPT} steps of {t}")
    _check(dy, a, b, c, x, d_skip, None)
    if (checkpoints.dtype != torch.float32 or not checkpoints.is_contiguous()
            or checkpoints.data_ptr() % 16):
        raise ValueError("checkpoints must be contiguous, aligned fp32")
    ddt, dx = torch.empty_like(dt), torch.empty_like(dt)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da, dds = torch.empty_like(a), torch.empty_like(d_skip)
    ds0 = torch.empty((bsz, d, n), dtype=torch.float32, device=dt.device)
    scratch = torch.empty(bwd_scratch_floats(bsz, t, d, n),
                          dtype=torch.float32, device=dt.device)
    launch("selective_scan_bwd", dt.get_device(), dt.data_ptr(),
           a.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(),
           d_skip.data_ptr(), checkpoints.data_ptr(), dy.data_ptr(),
           None if dstate is None else dstate.data_ptr(), ddt.data_ptr(),
           da.data_ptr(), db.data_ptr(), dc.data_ptr(), dx.data_ptr(),
           dds.data_ptr(), ds0.data_ptr(), scratch.data_ptr(), bsz, t, d, n)
    selective_scan_bwd.launches += 1
    return ddt, da, db, dc, dx, dds, ds0


#: kernel launches since the count was last set to 0
selective_scan.launches = 0
selective_scan_bwd.launches = 0
