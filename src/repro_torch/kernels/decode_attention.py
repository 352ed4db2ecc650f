"""Flash decode (one-token GQA over a KV cache): the CUDA kernel and its
plain version.

:func:`decode_attention` launches the kernel of
``csrc/decode_attention.cu`` for CUDA tensors, which replaces the TPU
kernel of the JAX package (``decode_attention_pallas``): one launch that
splits the cache across the card in clusters of 8, 4, 2 or 1 blocks
(:func:`plan`), streams 32-key K/V tiles into padded shared-memory rows
by 16-byte ``cp.async`` through a ring of stages, runs bf16 on the tensor
cores (fp32 on the CUDA cores), and merges the splits' partial softmaxes
inside the same launch, in a fixed order, behind ticket counters that
this module keeps per stream.  CPU tensors run
:func:`decode_attention_plain`.  The key and value caches may differ in
head dim (:data:`HEAD_DIMS`): MLA's expanded latent cache has a key of
192 (128 + 64 rope) and a value of 128.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import (FLOAT_CODES, float_code, launch,
                                        use_kernel)
from repro_torch.kernels.ref import decode_attention_plain

#: the (q and key cache, value cache) head-dim pairs the kernel is built for
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
#: the largest query group (Hq / Hkv) one block keeps in registers
MAX_GROUP = 8
#: cache keys per shared-memory tile
TILE_KEYS = 32

__all__ = ["decode_attention", "decode_attention_plain", "plan",
           "HEAD_DIMS", "MAX_GROUP", "TILE_KEYS"]

_PLANS: dict = {}
#: (device index, raw stream handle) -> zeroed int32 ticket counters
_TICKETS: dict = {}


def plan(b: int, hq: int, hkv: int, lmax: int, d: int, dtype: torch.dtype,
         device) -> tuple:
    """How a launch on CUDA ``device`` splits (b, hkv, lmax, d) caches:
    ``(split_keys, n_splits, scratch_floats, tickets)``, the keys of one
    split, the splits of one (batch, kv head) (clusters of 8 the card
    holds at once shared out over the pairs, or with many pairs one
    cluster of 4, 2 or 1 a pair), the fp32 scratch the launch needs and
    its merge's ticket counters.  Read once per shape and device from the
    kernel's library."""
    return _plan(b, hq, hkv, lmax, d, d, FLOAT_CODES[dtype],
                 torch.device(device).index)


def _plan(*key) -> tuple:
    found = _PLANS.get(key)
    if found is None:
        fn = build.entry("decode_attention", "decode_attention_plan",
                         [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3,
                         ctypes.c_int64)
        split_keys, n_splits, tickets = (ctypes.c_int() for _ in range(3))
        with torch.cuda.device(key[-1]):
            floats = fn(*key[:-1], ctypes.byref(split_keys),
                        ctypes.byref(n_splits), ctypes.byref(tickets))
        if floats < 0:
            raise ValueError(f"the decode kernel refuses (B, Hq, Hkv, L, D, "
                             f"Dv, type code) = {key[:-1]}")
        found = _PLANS[key] = (split_keys.value, n_splits.value, floats,
                               tickets.value)
    return found


def _tickets(index: int, n: int, device: torch.device) -> int:
    """The address of at least ``n`` zeroed ticket counters for launches
    on the current stream of CUDA device ``index``.  A launch leaves its
    counters at 0, so launches in one stream's order share one buffer;
    launches on another stream get their own, so two decode calls that
    run at once never take each other's tickets."""
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[key] = torch.zeros(n, dtype=torch.int32,
                                          device=device)
    return buf.data_ptr()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query token per batch row, q (B, Hq, D), over head-major
    caches, keys (B, Hkv, L, D) and values (B, Hkv, L, Dv), keys at
    positions < ``kv_len[b]`` (B,) (a
    length above L masks nothing; a length of 0 masks every key and
    gives that row NaN, as the reference's softmax over no key does;
    None: all L); ``scale`` defaults to D ** -0.5.  Returns
    (B, Hq, Dv) in q's type.  CUDA tensors (contiguous, q and the caches
    16-byte aligned, one type of fp32 / bf16, (D, Dv) in :data:`HEAD_DIMS`,
    Hq / Hkv <= 8, kv_len int32) launch the kernel, and nothing else, and
    add one to ``decode_attention.launches``; they raise
    ``NotImplementedError`` under grad mode when an input requires a
    gradient (the kernel has no backward).  CPU tensors run
    :func:`decode_attention_plain`."""
    on = (q, k_cache, v_cache) + (() if kv_len is None else (kv_len,))
    if not use_kernel(*on):
        return decode_attention_plain(q, k_cache, v_cache, kv_len, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        raise NotImplementedError(
            "decode_attention has no backward kernel: training runs the "
            "prefill path (ROADMAP.md section 1, item 7)")
    if (q.ndim != 3 or k_cache.ndim != 4 or v_cache.ndim != 4
            or k_cache.shape[:3] != v_cache.shape[:3]):
        raise ValueError("q must be (B, Hq, D) and the caches (B, Hkv, L, "
                         "D) and (B, Hkv, L, Dv)")
    b, hq, d = q.shape
    hkv, lmax, d_v = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0
            or hq % hkv):
        raise ValueError(f"q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} differ in batch or head "
                         f"dim, or Hq % Hkv != 0")
    if (d, d_v) not in HEAD_DIMS:
        raise ValueError(f"head dims (D, Dv) = {(d, d_v)}; the kernel is "
                         f"built for {HEAD_DIMS}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"query group {hq // hkv}; the kernel takes up "
                         f"to {MAX_GROUP}")
    code = float_code(q, k_cache, v_cache)
    lens = 0
    if kv_len is not None:
        if (kv_len.dtype != torch.int32 or kv_len.shape != (b,)
                or not kv_len.is_contiguous()):
            raise ValueError(f"kv_len must be a contiguous int32 ({b},) "
                             f"tensor, got {kv_len.dtype} "
                             f"{tuple(kv_len.shape)}")
        lens = kv_len.data_ptr()
    index = q.get_device()
    _, _, floats, tickets = _plan(b, hq, hkv, lmax, d, d_v, code, index)
    scratch = q.new_empty(floats, dtype=torch.float32) if floats else None
    out = q.new_empty((b, hq, d_v))
    launch("decode_attention", index, q.data_ptr(),
           k_cache.data_ptr(), v_cache.data_ptr(), lens, out.data_ptr(),
           0 if scratch is None else scratch.data_ptr(),
           _tickets(index, tickets, q.device) if tickets else 0, b, hq,
           hkv, lmax, d, d_v, d ** -0.5 if scale is None else float(scale),
           code)
    decode_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
decode_attention.launches = 0
