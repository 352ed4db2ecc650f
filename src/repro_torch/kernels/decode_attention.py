"""Flash decode (one-token GQA over a KV cache): the CUDA kernel and its
plain version.

:func:`decode_attention` launches the kernel of
``csrc/decode_attention.cu`` (split-K flash-decoding: the cache length
is split into 64-key blocks across the card, each writing a partial
softmax, then a second pass merges them) for CUDA tensors, which
replaces the TPU kernel of the JAX package (``decode_attention_pallas``),
and runs :func:`decode_attention_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import float_code, use_kernel
from repro_torch.kernels.ref import decode_attention_plain

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)
#: the largest query group (Hq / Hkv) one block keeps in registers
MAX_GROUP = 8
#: cache keys per block of the split pass
SPLIT_KEYS = 64

__all__ = ["decode_attention", "decode_attention_plain", "HEAD_DIMS",
           "MAX_GROUP", "SPLIT_KEYS"]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query token per batch row, q (B, Hq, D), over head-major
    caches (B, Hkv, L, D), keys at positions < ``kv_len[b]`` (B,) (each
    at least 1; None: all L).  Returns (B, Hq, D) in q's type.  CUDA
    tensors (contiguous, one type of fp32 / bf16, D in
    :data:`HEAD_DIMS`, Hq / Hkv <= 8) launch the kernel and add one to
    ``decode_attention.launches``; CPU tensors run
    :func:`decode_attention_plain`."""
    on = (q, k_cache, v_cache) + (() if kv_len is None else (kv_len,))
    if not use_kernel(*on):
        return decode_attention_plain(q, k_cache, v_cache, kv_len, scale)
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("q must be (B, Hq, D) and the caches one "
                         "(B, Hkv, L, D) shape")
    b, hq, d = q.shape
    hkv, lmax = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0
            or hq % hkv):
        raise ValueError(f"q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} differ in batch or head "
                         f"dim, or Hq % Hkv != 0")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
    group = hq // hkv
    if group > MAX_GROUP:
        raise ValueError(f"query group {group}; the kernel takes up to "
                         f"{MAX_GROUP}")
    code = float_code(q, k_cache, v_cache)
    if kv_len is None:
        lens = torch.full((b,), lmax, dtype=torch.int32, device=q.device)
    else:
        if tuple(kv_len.shape) != (b,):
            raise ValueError(f"kv_len has shape {tuple(kv_len.shape)}, "
                             f"expected ({b},)")
        # a length past the cache masks nothing, as in the plain version
        lens = torch.clamp(kv_len.to(torch.int32), max=lmax).contiguous()
    n_splits = -(-lmax // SPLIT_KEYS)
    slots = b * hkv * n_splits * group
    part_o = torch.empty(slots * d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(slots * 2, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    scale = d ** -0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        err = build.kernel("decode_attention")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), part_o.data_ptr(),
            part_ml.data_ptr(), b, hq, hkv, lmax, d, scale, code,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
decode_attention.launches = 0
