"""Flash attention (prefill, GQA): the CUDA kernels and their plain version.

:func:`flash_attention` launches a kernel of ``csrc/flash_attention.cu``
for CUDA tensors, which replaces the TPU kernel of the JAX package
(``flash_attention_pallas``), and runs :func:`attention_plain` for CPU
tensors.  The input type chooses the kernel: bf16 runs on the tensor
cores (wgmma on 128-row q tiles, K/V fed by TMA through a ring in shared
memory, online fp32 softmax, P fed as two bf16 terms so the product
keeps fp32-grade P), fp32 on the CUDA cores (FA-2 schedule, 64-row q
tiles), since a tensor-core fp32 product is TF32.  Both skip causal
tiles past the diagonal and mask ragged lengths.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.backend import (FLOAT_CODES, float_code, launch,
                                         use_kernel)
from repro_torch.kernels.ref import attention_plain

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)

__all__ = ["flash_attention", "attention_plain", "HEAD_DIMS"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of q (B, Hq, Lq, D) over k, v (B, Hkv, Lk, D),
    query head ``h`` reading kv head ``h // (Hq // Hkv)``; causal rows
    are the last Lq of Lk positions.  Returns (B, Hq, Lq, D) in q's
    type.  CUDA tensors (contiguous, one type of fp32 / bf16, D in
    :data:`HEAD_DIMS`, any Lq <= Lk) launch the kernel and add one to
    ``flash_attention.launches``; CPU tensors run
    :func:`attention_plain`."""
    if not use_kernel(q, k, v):
        return attention_plain(q, k, v, causal=causal, scale=scale)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, Hq, Lq, D) and k, v one "
                         "(B, Hkv, Lk, D) shape")
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"differ in batch or head dim, or Hq % Hkv != 0")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
    if causal and lq > lk:
        raise ValueError("causal attention needs Lq <= Lk")
    code = float_code(q, k, v)
    out = torch.empty_like(q)
    if code == FLOAT_CODES[torch.bfloat16] and any(
            t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("bf16 attention reads its inputs by TMA, which "
                         "needs 16-byte aligned tensors")
    if out.numel() == 0:
        return out
    scale = d ** -0.5 if scale is None else float(scale)
    launch("flash_attention", q.get_device(), q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), b, hq, hkv, lq, lk, d, int(causal),
           scale, code)
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
