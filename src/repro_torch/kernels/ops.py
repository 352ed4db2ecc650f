"""Public kernel entry points, with the JAX package's signatures
(``repro.kernels.ops``).

Each routes by the one rule of ``kernels/backend.py``: CUDA tensors
launch the hand-written kernel, CPU tensors run its plain version.  The
block sizes and ``rwkv6_scan``'s ``chunk`` are the TPU kernels' tiling;
the CUDA kernels tile on their own, so those arguments are accepted for
the signature and do not change the result:

* bf16 flash attention runs 128-row q tiles on ``wgmma`` (fp32 on the
  CUDA cores);
* decode streams 32-key K/V tiles, in splits sized to the card and
  merged in the same launch;
* ``rwkv6_scan`` walks the whole sequence in a block per (batch, head,
  group of value columns), the columns split by shape so the heads fill
  the SMs, each thread holding a tile of the state (8 x 2 values in a
  whole head of 64, 4 x 2 in a split one);
* the MESI tick runs a group of lanes per simulation (a direct path
  where n or m exceeds 32), whatever ``block_sims`` says.
"""

from __future__ import annotations

from repro_torch.kernels.decode_attention import (
    decode_attention as _decode_attention)
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_attention)
from repro_torch.kernels.mesi_transition import mesi_tick as _mesi_tick
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


def rwkv6_scan(r, k, v, w, bonus, initial_state=None, chunk: int = 64):
    """The RWKV6 WKV recurrence; returns (y, final state)
    (``kernels/rwkv6_scan.py``)."""
    return _rwkv6_scan(r, k, v, w, bonus, initial_state)


def mesi_tick(state, version, last_sync, reads_since_fetch, acts, arts,
              writes, artifact_tokens: int, eager: bool = False,
              access_k: int = 0, signal_tokens: int = 12,
              block_sims: int = 128):
    """One batched MESI tick, functional: returns ``(state', version',
    sync', reads', counters (B, 8), miss (B, n))``
    (``kernels/mesi_transition.py``)."""
    return _mesi_tick(state, version, last_sync, reads_since_fetch, acts,
                      arts, writes, artifact_tokens=artifact_tokens,
                      eager=eager, access_k=access_k,
                      signal_tokens=signal_tokens)
