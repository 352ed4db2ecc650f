"""Fused RMSNorm and its backward: the CUDA kernels and their plain
versions.

:func:`rmsnorm` launches the kernel of ``csrc/rmsnorm.cu`` (a warp or a
few per row on a persistent grid, 16-byte loads, fp32 reduction, the
weight multiplied in fp32 before the cast) for CUDA tensors, which
replaces the TPU kernel of the JAX package (``rmsnorm_pallas``), and
runs :func:`rmsnorm_plain` for CPU tensors.

When grad mode is on and an input requires a gradient, the CUDA route
goes through an autograd function whose backward launches
:func:`rmsnorm_bwd` (``csrc/rmsnorm_bwd.cu``: a persistent grid whose
blocks stream contiguous row ranges through a shared-memory ring filled
by the bulk copy engine, dweight summed in registers over a block's
range, then the blocks' partial rows in block order; :func:`bwd_plan`
sizes the grid and the ring), which replaces ``jax.grad`` of the JAX
package's norm.  CPU tensors differentiate the plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.backend import (float_code, launch, sm_count,
                                         use_kernel)
from repro_torch.kernels.ref import (rmsnorm_bwd_plain,
                                     rmsnorm_cast_first_plain, rmsnorm_plain)

#: the widest row the kernel takes (8 warps x 8 vectors of 16 bytes, fp32)
MAX_D = 8192
#: the backward's block: its computing threads (8 warps; one more warp
#: fills the ring)
BWD_THREADS = 256
#: bytes of x and dy a ring stage aims at, the most rows a stage holds,
#: and the most stages a ring holds
BWD_STAGE_BYTES = 32 * 1024
BWD_MAX_STAGE_ROWS = 256
BWD_MAX_STAGES = 4
#: Hopper's shared memory: an SM's (228 KB), what each resident block
#: reserves of it, and the most one block may take (227 KB)
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
MAX_BLOCK_SMEM = 232448

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_plain",
           "rmsnorm_cast_first_plain", "rmsnorm_bwd_plain", "MAX_D",
           "BwdPlan", "bwd_plan", "bwd_smem", "row_range"]


class BwdPlan(NamedTuple):
    """The backward's launch at a shape: ``blocks`` (its persistent
    grid, also the partial rows of dweight), ``rows_per_stage`` and
    ``stages`` of each block's ring, the blocks an SM holds, a block's
    shared memory and the fp32 scratch of the partial rows."""
    blocks: int
    rows_per_stage: int
    stages: int
    blocks_per_sm: int
    smem_bytes: int
    scratch_floats: int


def _row_bytes(d: int, itemsize: int) -> int:
    """A row's bytes in shared memory: d up to a 16-byte vector."""
    return -(-d * itemsize // 16) * 16


def bwd_smem(d: int, itemsize: int, rows_per_stage: int,
             stages: int) -> int:
    """A backward block's shared memory (``csrc/rmsnorm_bwd.cu``'s
    ``layout``, which ``rmsnorm_bwd_smem`` reports on the card): the ring
    (or, if larger, the row groups' fp32 dweight partials that reuse it),
    w, each stage's rows' two sums a part (a row's vectors in
    8 / rows_per_stage parts where a stage has fewer rows than the 8
    computing warps), two mbarriers a stage."""
    row = _row_bytes(d, itemsize)
    vectors = row // 16
    groups = BWD_THREADS // vectors if vectors < BWD_THREADS else 1
    parts = max(1, BWD_THREADS // 32 // rows_per_stage)
    ring = stages * 2 * rows_per_stage * row
    combine = groups * (row // itemsize) * 4 if groups > 1 else 0
    return max(ring, combine) + row + stages * rows_per_stage * parts * 8 + (
        2 * stages * 8)


@functools.lru_cache(maxsize=None)
def bwd_plan(d: int, itemsize: int, sms: int) -> BwdPlan:
    """The backward's plan for rows of ``d`` elements of ``itemsize``
    bytes on a card of ``sms`` SMs.

    A stage holds the rows of x and of dy that come nearest
    ``BWD_STAGE_BYTES`` (bf16 d 2048: 4; d 128: 64); a ring holds up to
    ``BWD_MAX_STAGES`` stages and at least 2.  Two blocks an SM where two
    such rings fit the SM's shared memory, else one (fp32 rows above 16
    KB) with as many stages as fit 227 KB.  The grid is that many blocks
    an SM, whatever the rows (a block may have none), so dweight's order
    of summation is fixed per card and width."""
    row = _row_bytes(d, itemsize)
    per_stage = max(1, min(BWD_MAX_STAGE_ROWS, BWD_STAGE_BYTES // (2 * row)))
    for per_sm in (2, 1):
        room = min(SM_SMEM // per_sm - BLOCK_RESERVED_SMEM, MAX_BLOCK_SMEM)
        stages = BWD_MAX_STAGES
        while stages > 2 and bwd_smem(d, itemsize, per_stage, stages) > room:
            stages -= 1
        if bwd_smem(d, itemsize, per_stage, stages) <= room:
            break
    blocks = per_sm * sms
    return BwdPlan(blocks, per_stage, stages, per_sm,
                   bwd_smem(d, itemsize, per_stage, stages), blocks * d)


def row_range(block: int, rows: int, blocks: int) -> range:
    """The rows block ``block`` of the backward's grid takes, as the
    kernel computes them: contiguous, balanced to within a row."""
    return range(block * rows // blocks, (block + 1) * rows // blocks)


def _check(x, weight) -> int:
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight has shape {tuple(weight.shape)}, "
                         f"expected ({d},)")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rows of {d} values; the kernel takes 1..{MAX_D}")
    return float_code(x, weight)


def _forward(x, weight, eps, cast_first):
    code = _check(x, weight)
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows:
        launch("rmsnorm", x.get_device(), x.data_ptr(), weight.data_ptr(),
               out.data_ptr(), rows, d, float(eps), int(cast_first), code)
        rmsnorm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    """The CUDA route under autograd."""

    @staticmethod
    def forward(ctx, x, weight, eps, cast_first):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.cast_first = eps, cast_first
        return _forward(x, weight, eps, cast_first)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, weight, dy.contiguous(), ctx.eps,
                             ctx.cast_first)
        return dx, dw, None, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            cast_first: bool = False) -> torch.Tensor:
    """RMSNorm of ``x`` (..., d) with ``weight`` (d,); same shape and
    type as ``x``, rounded in the TPU kernel's order or, ``cast_first``,
    the JAX package's model's.  CUDA tensors (contiguous, one type of
    fp32 / bf16, d <= 8192; any alignment) launch the kernel and add one
    to ``rmsnorm.launches``; under grad mode with an input that requires
    a gradient the result carries one, which :func:`rmsnorm_bwd`
    computes.  CPU tensors run :func:`rmsnorm_plain` (``cast_first``:
    :func:`rmsnorm_cast_first_plain`)."""
    if not use_kernel(x, weight):
        plain = rmsnorm_cast_first_plain if cast_first else rmsnorm_plain
        return plain(x, weight, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps, cast_first)
    return _forward(x, weight, eps, cast_first)


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6, cast_first: bool = False):
    """(dx, dweight) of :func:`rmsnorm` (in the same cast order) at
    ``x``, ``weight`` against the output's gradient ``dy``, in x's and
    weight's types.  CUDA tensors (as the forward takes them, ``dy``
    contiguous of x's type and shape) launch the backward kernel and add
    one to ``rmsnorm_bwd.launches``; CPU tensors differentiate the plain
    version."""
    if not use_kernel(x, weight, dy):
        return rmsnorm_bwd_plain(x, weight, dy, eps, cast_first)
    code = _check(x, weight)
    float_code(x, dy)
    if dy.shape != x.shape:
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    rows = x.numel() // d
    dx, dw = torch.empty_like(x), torch.empty_like(weight)
    if not rows:
        return dx, dw.zero_()
    index = x.get_device()
    plan = bwd_plan(d, x.element_size(), sm_count(index))
    partial = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=x.device)
    launch("rmsnorm_bwd", index, x.data_ptr(), weight.data_ptr(),
           dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
           rows, d, float(eps), plan.blocks, plan.rows_per_stage,
           plan.stages, int(cast_first), code)
    rmsnorm_bwd.launches += 1
    return dx, dw


#: kernel launches since the count was last set to 0
rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
