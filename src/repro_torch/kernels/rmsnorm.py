"""Fused RMSNorm and its backward: the CUDA kernels and their plain
versions.

:func:`rmsnorm` launches the kernel of ``csrc/rmsnorm.cu`` (a warp or a
few per row on a persistent grid, 16-byte loads, fp32 reduction, the
weight multiplied in fp32 before the cast) for CUDA tensors, which
replaces the TPU kernel of the JAX package (``rmsnorm_pallas``), and
runs :func:`rmsnorm_plain` for CPU tensors.

When grad mode is on and an input requires a gradient, the CUDA route
goes through an autograd function whose backward launches
:func:`rmsnorm_bwd` (``csrc/rmsnorm_bwd.cu``: dx row by row, dweight as
per-block fp32 partials summed in a fixed order), which replaces
``jax.grad`` of the JAX package's norm.  CPU tensors differentiate the
plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import float_code, launch, use_kernel
from repro_torch.kernels.ref import (rmsnorm_bwd_plain,
                                     rmsnorm_cast_first_plain, rmsnorm_plain)

#: the widest row the kernel takes (8 warps x 8 vectors of 16 bytes, fp32)
MAX_D = 8192
#: the most blocks the backward's persistent grid runs: its dweight
#: partials take this many fp32 rows of scratch at most
MAX_BWD_BLOCKS = 1024

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_plain",
           "rmsnorm_cast_first_plain", "rmsnorm_bwd_plain", "MAX_D",
           "MAX_BWD_BLOCKS"]


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
    blocks = min(MAX_BWD_BLOCKS, rows)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    launch("rmsnorm_bwd", x.get_device(), x.data_ptr(), weight.data_ptr(),
           dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
           rows, d, float(eps), blocks, int(cast_first), code)
    rmsnorm_bwd.launches += 1
    return dx, dw


#: kernel launches since the count was last set to 0
rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
