"""Mamba's selective scan and its backward: the CUDA kernels and their
plain versions.

:func:`selective_scan` launches the kernel of ``csrc/selective_scan.cu``
in its fp32 mode (a block per (batch row, 128 channels), a channel's
d_state fp32 states split over 1, 2 or 4 lanes by :func:`plan`, the
steps staged 8 at a time through shared memory; the skip ``y + x *
d_skip`` fused) for CUDA tensors and runs :func:`selective_scan_plain`
for CPU tensors.  :func:`selective_scan_gated` launches the same kernel
in its gated mode, which also takes dt's softplus from its raw
projection and bias and gates the output with ``silu(z)``, reading and
writing the model type: what the model runs when no input needs a
gradient (prefill and decode).  They replace the JAX package's chunked
``lax.scan`` of ``repro.models.mamba._ssm_step`` (and its skip), which
no Pallas kernel covers: walked step by step on the card it would be
thousands of launches a layer.

Under autograd on the card the fp32 forward launch also writes the fp32
state every :data:`CKPT` steps (:func:`selective_scan_checkpoints`), and
the backward launches ``csrc/selective_scan_bwd.cu``
(:func:`selective_scan_bwd`): two channels a thread, a channel pair's
states over 8 lanes; per chunk, in the reverse order, it recomputes the
chunk's states and exponentials from its checkpoint into registers and
carries the state's gradient back; db and dc (sums over the channels)
and da and dd_skip (sums over the batch) leave per-block partials that
a second kernel sums in a fixed order (no atomics).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.backend import (aligned, float_code, launch,
                                         sm_count, use_kernel)
from repro_torch.kernels.ref import (selective_scan_bwd_plain,
                                     selective_scan_gated_plain,
                                     selective_scan_plain)

#: the state sizes the kernels are built for: the smoke config's and
#: jamba's (``MambaConfig.d_state``)
STATE_SIZES = (8, 16)
#: channels of a block: d_inner must be a multiple of it
BLOCK_CHANNELS = 128
#: the lanes a channel's states may be split over (``plan``)
LANE_SPLITS = (1, 2, 4)
#: threads an SM that :func:`plan` asks of the grid: four warps a
#: scheduler, less an eighth (jamba's batched prefill, 4 x 16384
#: channels on 132 SMs, reads 3.9 warps a scheduler at one lane)
WANT_THREADS_PER_SM = 448
#: steps between two state checkpoints of the forward under autograd (the
#: backward holds a chunk's states and exponentials in registers, 2 * CKPT
#: floats a state a lane); they take B * ceil(T / CKPT) * D * N * 4 bytes,
#: twice an fp32 (B, T, D) tensor at d_state 16, alive from a layer's
#: forward to its backward.  The results do not depend on it.
CKPT = 8

__all__ = ["selective_scan", "selective_scan_plain",
           "selective_scan_gated", "selective_scan_gated_plain",
           "selective_scan_checkpoints", "selective_scan_bwd",
           "selective_scan_bwd_plain", "bwd_scratch_floats", "plan",
           "STATE_SIZES", "BLOCK_CHANNELS", "LANE_SPLITS", "CKPT"]


def plan(b: int, d: int, sms: int) -> int:
    """The lanes a channel's states are split over at batch ``b`` and
    d_inner ``d`` on a card of ``sms`` SMs: the fewest of
    :data:`LANE_SPLITS` whose grid gives :data:`WANT_THREADS_PER_SM`
    threads an SM (fewer lanes repeat less of a step's work), else the
    most.  One lane at jamba's batch 4, four at one agent's prefill."""
    for lanes in LANE_SPLITS:
        if b * d * lanes >= WANT_THREADS_PER_SM * sms:
            return lanes
    return LANE_SPLITS[-1]


def _check(dt, a, b, c, x, d_skip, initial_state,
           io_dtype=torch.float32) -> None:
    """Raise unless the kernels take these tensors: dt and x of
    ``io_dtype``, the rest fp32, all contiguous and 16-byte aligned,
    d_state in :data:`STATE_SIZES` and d_inner a multiple of
    :data:`BLOCK_CHANNELS`."""
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
    fp32 = [v for v in (a, b, c, d_skip, initial_state) if v is not None]
    if (dt.dtype != io_dtype or x.dtype != io_dtype
            or any(v.dtype != torch.float32 for v in fp32)):
        raise TypeError(f"the selective scan kernels take dt and x in "
                        f"{io_dtype} and the rest in fp32 (the model casts "
                        f"them so), got dt {dt.dtype}, x {x.dtype}, "
                        f"{sorted({str(v.dtype) for v in fp32})}")
    if any(not v.is_contiguous() or v.data_ptr() % 16
           for v in [dt, x] + fp32):
        raise ValueError("the selective scan kernels take contiguous, "
                         "16-byte aligned tensors")


def _launch(dt, dt_bias, a, b, c, x, z, d_skip, initial_state, y, ckpt,
            code: int):
    """One launch of the forward kernel, fp32 (``dt_bias`` None) or gated;
    returns the final state."""
    bsz, t, d = x.shape
    n = a.shape[1]
    device = x.get_device()
    state = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    launch("selective_scan", device, dt.data_ptr(),
           None if dt_bias is None else dt_bias.data_ptr(), a.data_ptr(),
           b.data_ptr(), c.data_ptr(), x.data_ptr(),
           None if z is None else z.data_ptr(), d_skip.data_ptr(),
           None if initial_state is None else initial_state.data_ptr(),
           y.data_ptr(), state.data_ptr(),
           None if ckpt is None else ckpt.data_ptr(), bsz, t, d, n,
           plan(bsz, d, sm_count(device)),
           0 if z is None else z.stride(0), 0 if z is None else z.stride(1),
           int(dt_bias is not None), code)
    selective_scan.launches += 1
    return state


def _forward(dt, a, b, c, x, d_skip, initial_state, checkpoints: bool):
    """One launch of the fp32 forward kernel: (y, final state,
    checkpoints or None)."""
    _check(dt, a, b, c, x, d_skip, initial_state)
    bsz, t, d = dt.shape
    y = torch.empty_like(dt)
    ckpt = (torch.empty((bsz, -(-t // CKPT), d, a.shape[1]),
                        dtype=torch.float32, device=dt.device)
            if checkpoints else None)
    state = _launch(dt, None, a, b, c, x, None, d_skip, initial_state, y,
                    ckpt, 0)
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


def _check_gated(dt_raw, dt_bias, a, b, c, x, z, d_skip,
                 initial_state) -> int:
    """Raise unless the gated mode takes these tensors: dt_raw, x and z
    (B, T, D) of one model type (bf16 or fp32), dt_raw and x contiguous,
    z with a unit channel stride and 16-byte aligned rows; the rest as
    :func:`_check`.  Returns the type code."""
    code = float_code(x)
    _check(dt_raw, a, b, c, x, d_skip, initial_state, x.dtype)
    d = x.shape[2]
    if z.shape != x.shape or z.dtype != x.dtype:
        raise TypeError(f"z {tuple(z.shape)} {z.dtype} must match x "
                        f"{tuple(x.shape)} {x.dtype}")
    vec = 16 // z.element_size()
    if (z.stride(2) != 1 or z.stride(1) % vec or z.stride(0) % vec
            or z.stride(0) >= 2 ** 31 or z.data_ptr() % 16):
        raise ValueError(f"the gated scan reads z with a unit channel "
                         f"stride and 16-byte aligned rows, got strides "
                         f"{z.stride()}")
    if (dt_bias.shape != (d,) or dt_bias.dtype != torch.float32
            or not dt_bias.is_contiguous() or dt_bias.data_ptr() % 16):
        raise ValueError(f"dt_bias must be a contiguous, aligned fp32 "
                         f"({d},), got {tuple(dt_bias.shape)} "
                         f"{dt_bias.dtype}")
    return code


def selective_scan_gated(dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         x: torch.Tensor, z: torch.Tensor,
                         d_skip: torch.Tensor,
                         initial_state: Optional[torch.Tensor] = None):
    """Mamba's scan between its projections, as the model runs it when no
    input needs a gradient: dt = softplus(dt_raw + dt_bias) in fp32, the
    scan of :func:`selective_scan` on x in fp32, then ``y`` cast to x's
    type times ``silu(z)``.  dt_raw, x, z (B, T, D) in the model type
    (bf16 or fp32; z may be the strided half of the input projection),
    dt_bias (D) and the rest fp32.  Returns (the gated output (B, T, D) in
    x's type, final state (B, D, N) fp32).  CUDA tensors launch the
    kernel's gated mode and add one to ``selective_scan.launches``; under
    grad mode with an input that requires a gradient they raise (the
    model takes :func:`selective_scan` then).  CPU tensors run
    :func:`selective_scan_gated_plain`."""
    inputs = (dt_raw, dt_bias, a, b, c, x, z, d_skip) + (
        () if initial_state is None else (initial_state,))
    if not use_kernel(*inputs):
        return selective_scan_gated_plain(dt_raw, dt_bias, a, b, c, x, z,
                                          d_skip, initial_state)
    if torch.is_grad_enabled() and any(v.requires_grad for v in inputs):
        raise NotImplementedError("the gated scan has no backward: under "
                                  "autograd run selective_scan")
    code = _check_gated(dt_raw, dt_bias, a, b, c, x, z, d_skip,
                        initial_state)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = _launch(dt_raw, dt_bias, a, b, c, x, z, d_skip, initial_state,
                    out, None, code)
    return out, state


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
    kernels: the reverse recurrence, a channel pair's states over 8
    lanes, then the fixed order sums of the partials) and add one to
    ``selective_scan_bwd.launches``; CPU tensors run
    :func:`selective_scan_bwd_plain` from the first checkpoint."""
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
