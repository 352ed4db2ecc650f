"""Public model-kernel entry points, with the JAX package's signatures
(``repro.kernels.ops``).

Each routes by the one rule of ``kernels/backend.py``: CUDA tensors
launch the hand-written kernel, CPU tensors run its plain version.  The
block sizes are the TPU kernels' tiling; the CUDA kernels tile on their
own (64-row q tiles, 64-key K/V tiles, 64-key decode splits), so the
arguments are accepted for the signature and do not change the result.
``rwkv6_scan`` drops the TPU kernel's ``chunk`` (the CUDA kernel walks
the whole sequence in one block per head).
"""

from __future__ import annotations

from repro_torch.kernels.decode_attention import (
    decode_attention as _decode_attention)
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_attention)
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _rwkv6_scan


def rmsnorm(x, weight, eps: float = 1e-6, block_rows: int = 128):
    """RMSNorm over the last axis (``kernels/rmsnorm.py``)."""
    return _rmsnorm(x, weight, eps)


def flash_attention(q, k, v, causal: bool = True, scale=None,
                    block_q: int = 128, block_k: int = 128):
    """GQA prefill attention (``kernels/flash_attention.py``)."""
    return _flash_attention(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, kv_len=None, scale=None,
                     block_k: int = 256):
    """One-token GQA decode (``kernels/decode_attention.py``)."""
    return _decode_attention(q, k_cache, v_cache, kv_len, scale=scale)


def rwkv6_scan(r, k, v, w, bonus, initial_state=None):
    """The RWKV6 WKV recurrence; returns (y, final state)
    (``kernels/rwkv6_scan.py``)."""
    return _rwkv6_scan(r, k, v, w, bonus, initial_state)
