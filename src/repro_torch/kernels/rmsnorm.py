"""Fused RMSNorm: the CUDA kernel and its plain version.

:func:`rmsnorm` launches the kernel of ``csrc/rmsnorm.cu`` (a warp or a
few per row on a persistent grid, 16-byte loads, fp32 reduction, the
weight multiplied in fp32 before the cast) for CUDA tensors, which
replaces the TPU kernel of the JAX package (``rmsnorm_pallas``), and
runs :func:`rmsnorm_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import float_code, launch, use_kernel
from repro_torch.kernels.ref import rmsnorm_plain

#: the widest row the kernel takes (8 warps x 8 vectors of 16 bytes, fp32)
MAX_D = 8192

__all__ = ["rmsnorm", "rmsnorm_plain", "MAX_D"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x`` (..., d) with ``weight`` (d,); same shape and
    type as ``x``.  CUDA tensors (contiguous, one type of fp32 / bf16,
    d <= 8192; any alignment) launch the kernel and add one to
    ``rmsnorm.launches``; CPU tensors run :func:`rmsnorm_plain`."""
    if not use_kernel(x, weight):
        return rmsnorm_plain(x, weight, eps)
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight has shape {tuple(weight.shape)}, "
                         f"expected ({d},)")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rows of {d} values; the kernel takes 1..{MAX_D}")
    code = float_code(x, weight)
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        launch("rmsnorm", x.get_device(), x.data_ptr(), weight.data_ptr(),
               out.data_ptr(), rows, d, float(eps), code)
        rmsnorm.launches += 1
    return out


#: kernel launches since the count was last set to 0
rmsnorm.launches = 0
