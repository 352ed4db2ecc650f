"""GQA / MQA self-attention with qk-norm, for prefill and cached decode,
the encoder's bidirectional self-attention, cross-attention and
DeepSeek-V2's multi-head latent attention (MLA), with the JAX package's
names (``repro.models.attention``).

Attention runs through the hand-written kernels (``kernels.ops``):

* prefill from an empty cache (``s > 1`` at offset 0, what
  ``transformer.prefill`` passes) and the cache-free forward: causal
  ``flash_attention`` over the fresh q/k/v, whose k/v are then written
  into the cache;
* a cached prefill at an offset (``s > 1`` with a (B,) ``cache_len``, or
  an int other than 0): the new k/v are written at each row's offset,
  clamped as the reference's ``dynamic_update_slice`` clamps it (start
  ``min(cache_len[b], Lmax - s)``), then causal ``flash_attention`` over
  the whole cache with ``q_offset = cache_len`` and
  ``kv_len = cache_len + s``;
* decode (``s == 1``): the new k/v are written at each row's
  ``min(cache_len, Lmax - 1)`` (a full cache overwrites its last slot,
  as the reference's ``dynamic_update_slice`` clamps it), then
  ``decode_attention`` reads the cache with ``kv_len = cache_len + 1``,
  which the kernel clamps to Lmax;
* the encoder (``encoder_attn_apply``): non-causal ``flash_attention``
  over the frames, Lq = Lk;
* cross-attention (``cross_attn_apply``): q from x, k/v from the context
  (encoder states or vision embeddings) or from the write-once cross
  cache; non-causal ``flash_attention`` with Lq != Lk for a prompt, and
  ``decode_attention`` over the whole cross cache for one token;
* MLA (``mla_apply``): a q head of nope + rope (192 at deepseek-v2-lite)
  against a key of the latent's up-projection and one rope key shared by
  every head, a value head of its own width (128); the latent ``c_kv``
  and the shared rope key are what the cache keeps.  Each call expands
  the latent into per-head k and v, as the reference does, and runs the
  kernels at the (192, 128) head-dim pair with the scale
  (nope + rope) ** -0.5: causal ``flash_attention`` for a prefill from an
  empty cache and the cache-free forward, ``decode_attention`` over the
  whole expanded cache (``kv_len = cache_len + 1``) for one token, and
  causal ``flash_attention`` over the whole expanded cache at per-row
  offsets for a cached prefill at an offset.

Under tensor parallelism (``runtime.tensor_parallel.using``) the
weights hold a rank's heads, whose count is read from them, and the
output projection's partial products are summed over 'model' before
the bias is added and before the cross gate multiplies.

The GQA and cross caches are head-major, ``(B, Hkv, Lmax, D)`` per layer
(the JAX package keeps ``(B, Lmax, Hkv, D)``), so the decode kernel reads
them without a copy; MLA's latent caches have no head axis and keep the
reference's ``(B, Lmax, rank)`` and ``(B, Lmax, rope)``.  Caches are
updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (dense_init, norm_apply, norm_init,
                                       rope_angles, rope_apply)
from repro_torch.runtime import tensor_parallel as tp


# --------------------------- GQA attention ---------------------------

def gqa_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.kv_head_dim()
    p = {
        "wq": dense_init(gen, d, hq * hd, dtype, device),
        "wk": dense_init(gen, d, hkv * hd, dtype, device),
        "wv": dense_init(gen, d, hkv * hd, dtype, device),
        "wo": dense_init(gen, hq * hd, d, dtype, device),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = norm_init(hd, "rmsnorm", dtype, device)
        p["k_norm"] = norm_init(hd, "rmsnorm", dtype, device)
    if cfg.use_bias:
        for name, n in (("bq", hq * hd), ("bk", hkv * hd),
                        ("bv", hkv * hd), ("bo", d)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _heads(p, cfg: ModelConfig) -> tuple:
    """The q and K / V heads the weights hold: the config's, or a
    tensor-parallel rank's share of them."""
    hd = cfg.kv_head_dim()
    return p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd


def _project_qkv(p, cfg: ModelConfig, x):
    """(B, s, H, D) q, k, v, qk-normed where the config says so."""
    b, s, _ = x.shape
    hd = cfg.kv_head_dim()
    hq, hkv = _heads(p, cfg)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.use_qk_norm:
        q = norm_apply(p["q_norm"], q)
        k = norm_apply(p["k_norm"], k)
    return q, k, v


def _head_major(x):
    """(B, s, H, D) -> contiguous (B, H, s, D)."""
    return x.transpose(1, 2).contiguous()


def _from_empty(cache_len) -> bool:
    """Whether a cached prefill starts from an empty cache: ``cache_len``
    is the int 0, what ``transformer.prefill`` passes."""
    return isinstance(cache_len, int) and cache_len == 0


def _decode_lengths(cache_len, b: int, device):
    """A decode step's (B,) int32 write positions (an int for a one-token
    prompt)."""
    if isinstance(cache_len, int):
        return torch.full((b,), cache_len, dtype=torch.int32, device=device)
    return cache_len


def _offset_rows(cache_len, b: int, s: int, lmax: int, device):
    """A cached prefill's (B,) int32 offsets and the (B, s) cache
    positions its s new rows are written to: from ``min(cache_len[b],
    Lmax - s)``, as ``jax.lax.dynamic_update_slice`` clamps the start so
    that the update fits (the reference's ``_scatter_time``)."""
    lens = _decode_lengths(cache_len, b, device).to(torch.int32)
    start = lens.clamp(0, lmax - s)
    return lens, start[:, None] + torch.arange(s, device=device)


def gqa_apply(p, cfg: ModelConfig, x, positions, cache_kv=None,
              cache_len=None):
    """Self-attention of x (B, s, d) at ``positions`` (1 or B, s).

    * ``cache_kv is None``: causal attention over x alone; returns
      ``(y, (k, v))`` with k, v head-major.
    * ``cache_kv = (k, v)``, each (B, Hkv, Lmax, D), written in place:
      with ``s > 1`` and ``cache_len == 0`` (the int) a prefill from an
      empty cache; with ``s > 1`` and a (B,) ``cache_len`` a cached
      prefill at per-row offsets over the whole cache; with ``s == 1`` a
      decode step at the (B,) positions ``cache_len``.
      Returns ``(y, (k, v))`` with the same cache tensors.
    """
    b, s, _ = x.shape
    hd = cfg.kv_head_dim()
    q, k, v = _project_qkv(p, cfg, x)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = rope_apply(q, cos, sin)
    k = rope_apply(k, cos, sin)

    if cache_kv is None or (s > 1 and _from_empty(cache_len)):
        k_hm, v_hm = _head_major(k), _head_major(v)
        out = ops.flash_attention(_head_major(q), k_hm, v_hm, causal=True)
        out = out.transpose(1, 2)                       # (B, s, Hq, D)
        if cache_kv is None:
            new_cache = (k_hm, v_hm)
        else:
            ck, cv = cache_kv
            ck[:, :, :s] = k_hm
            cv[:, :, :s] = v_hm
            new_cache = (ck, cv)
    elif s > 1:
        ck, cv = cache_kv
        lens, at = _offset_rows(cache_len, b, s, ck.shape[2], x.device)
        rows = torch.arange(b, device=x.device)[:, None]
        ck[rows, :, at] = k
        cv[rows, :, at] = v
        out = ops.flash_attention(_head_major(q), ck, cv, causal=True,
                                  q_offset=lens,
                                  kv_len=lens + s).transpose(1, 2)
        new_cache = (ck, cv)
    else:
        ck, cv = cache_kv
        cache_len = _decode_lengths(cache_len, b, x.device)
        at = cache_len.clamp(max=ck.shape[2] - 1)
        rows = torch.arange(b, device=x.device)
        ck[rows, :, at] = k[:, 0]
        cv[rows, :, at] = v[:, 0]
        out = ops.decode_attention(q[:, 0].contiguous(), ck, cv,
                                   kv_len=cache_len + 1)[:, None]
        new_cache = (ck, cv)
    y = tp.reduce(out.reshape(b, s, q.shape[2] * hd) @ p["wo"])
    if "bo" in p:
        y = y + p["bo"]
    return y, new_cache


def encoder_attn_apply(p, cfg: ModelConfig, x):
    """The encoder's bidirectional self-attention of x (B, T, d): the
    projections (biases and qk-norm where the config has them), no rope,
    non-causal attention, the output projection and its bias."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    out = ops.flash_attention(_head_major(q), _head_major(k), _head_major(v),
                              causal=False).transpose(1, 2)
    y = out.reshape(b, t, -1) @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y


# -------------------------- cross-attention --------------------------

def cross_attn_init(gen, cfg: ModelConfig, dtype, device,
                    kv_dim: int = 0) -> dict:
    """No biases, whatever ``use_bias``; the tanh ``gate`` a 0-d fp32
    leaf, 0 at init (the layer starts as the identity)."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.kv_head_dim()
    kv_dim = kv_dim or d
    p = {
        "wq": dense_init(gen, d, hq * hd, dtype, device),
        "wk": dense_init(gen, kv_dim, hkv * hd, dtype, device),
        "wv": dense_init(gen, kv_dim, hkv * hd, dtype, device),
        "wo": dense_init(gen, hq * hd, d, dtype, device),
        "gate": torch.zeros((), dtype=torch.float32, device=device),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = norm_init(hd, "rmsnorm", dtype, device)
        p["k_norm"] = norm_init(hd, "rmsnorm", dtype, device)
    return p


def cross_attn_apply(p, cfg: ModelConfig, x, context, cached_kv=None):
    """Cross-attention of x (B, s, d) over a context (B, T, kv_dim) of
    frozen encoder or vision states, or, with ``cached_kv = (k, v)``
    (each (B, Hkv, T, D), the projected context a prefill returned), over
    those.  Returns ``(y, (k, v))``, k and v head-major.  As in the JAX
    package, qk-norm normalizes a cached k again, and the output is
    multiplied by ``tanh(gate)`` cast to its type.  A prompt runs
    non-causal ``flash_attention``; one token over a cache runs
    ``decode_attention`` with ``kv_len = T`` for every row; an empty
    context (T = 0) attends to nothing and gives 0, as the reference's
    einsum over no key does."""
    b, s, _ = x.shape
    hd = cfg.kv_head_dim()
    hq, hkv = _heads(p, cfg)
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    if cached_kv is None:
        t = context.shape[1]
        k = _head_major((context @ p["wk"]).reshape(b, t, hkv, hd))
        v = _head_major((context @ p["wv"]).reshape(b, t, hkv, hd))
    else:
        k, v = cached_kv
        t = k.shape[2]
    if cfg.use_qk_norm:
        q = norm_apply(p["q_norm"], q)
        k = norm_apply(p["k_norm"], k)
    if t == 0:
        out = q.new_zeros(q.shape)
    elif cached_kv is not None and s == 1:
        out = ops.decode_attention(
            q[:, 0].contiguous(), k, v,
            kv_len=torch.full((b,), t, dtype=torch.int32,
                              device=x.device))[:, None]
    else:
        out = ops.flash_attention(_head_major(q), k, v,
                                  causal=False).transpose(1, 2)
    y = tp.reduce(out.reshape(b, s, hq * hd) @ p["wo"])
    gate = torch.tanh(p["gate"]).to(y.dtype)
    return y * gate, (k, v)


# ------------------------------- MLA ---------------------------------

def mla_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    """DeepSeek-V2 multi-head latent attention with a full-rank q
    projection (``q_lora_rank = 0``): the reference's leaves and shapes."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, d, h * qk_head, dtype, device),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype, device),
        "kv_norm": norm_init(m.kv_lora_rank, "rmsnorm", dtype, device),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim,
                           dtype, device),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dtype,
                           device),
        "wo": dense_init(gen, h * m.v_head_dim, d, dtype, device),
    }


def _mla_expand(p, cfg: ModelConfig, c_kv, k_pe):
    """The latent stream (B, T, rank) and shared rope key (B, T, rope) as
    head-major k (B, H, T, nope + rope), the rope key broadcast over the
    heads after each head's nope part, and v (B, H, T, v_head)."""
    m = cfg.mla
    b, t, _ = c_kv.shape
    h = cfg.n_heads
    k_nope = (c_kv @ p["w_uk"]).reshape(b, t, h, m.qk_nope_head_dim)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        b, t, h, m.qk_rope_head_dim)], dim=-1)
    v = (c_kv @ p["w_uv"]).reshape(b, t, h, m.v_head_dim)
    return _head_major(k), _head_major(v)


def mla_apply(p, cfg: ModelConfig, x, positions, cache_ckv=None,
              cache_len=None):
    """MLA of x (B, s, d) at ``positions`` (1 or B, s), softmax in fp32
    at the scale (nope + rope) ** -0.5.

    * ``cache_ckv is None``: causal attention over x alone; returns
      ``(y, (c_kv, k_pe))``, the normed latent (B, s, rank) and the roped
      shared key (B, s, rope).
    * ``cache_ckv = (ckv, kpe)``, (B, Lmax, rank) and (B, Lmax, rope),
      written in place: with ``s > 1`` and ``cache_len == 0`` (the int) a
      prefill from an empty cache; with ``s > 1`` and a (B,)
      ``cache_len`` a cached prefill at per-row offsets over the whole
      cache expanded, keys at positions < ``cache_len + s``; with
      ``s == 1`` a decode step at the (B,) positions ``cache_len``, over
      the whole cache expanded, keys at positions < ``cache_len + 1``.
      Returns ``(y, (ckv, kpe))`` with the same cache tensors.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, rank = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    q = (x @ p["w_dq"]).reshape(b, s, h, nope + rope)
    dkv = x @ p["w_dkv"]
    c_kv = norm_apply(p["kv_norm"], dkv[..., :rank].contiguous())
    cos, sin = rope_angles(positions, rope, cfg.rope_theta)
    q = torch.cat([q[..., :nope], rope_apply(q[..., nope:], cos, sin)],
                  dim=-1)
    k_pe = rope_apply(dkv[..., rank:], cos, sin)     # one head, shared
    scale = (nope + rope) ** -0.5

    if cache_ckv is None or (s > 1 and _from_empty(cache_len)):
        k, v = _mla_expand(p, cfg, c_kv, k_pe)
        out = ops.flash_attention(_head_major(q), k, v, causal=True,
                                  scale=scale).transpose(1, 2)
        if cache_ckv is None:
            new_cache = (c_kv, k_pe)
        else:
            ckv, kpe = cache_ckv
            ckv[:, :s] = c_kv
            kpe[:, :s] = k_pe
            new_cache = (ckv, kpe)
    elif s > 1:
        ckv, kpe = cache_ckv
        lens, at = _offset_rows(cache_len, b, s, ckv.shape[1], x.device)
        rows = torch.arange(b, device=x.device)[:, None]
        ckv[rows, at] = c_kv
        kpe[rows, at] = k_pe
        k, v = _mla_expand(p, cfg, ckv, kpe)
        out = ops.flash_attention(_head_major(q), k, v, causal=True,
                                  scale=scale, q_offset=lens,
                                  kv_len=lens + s).transpose(1, 2)
        new_cache = (ckv, kpe)
    else:
        ckv, kpe = cache_ckv
        cache_len = _decode_lengths(cache_len, b, x.device)
        at = cache_len.clamp(max=ckv.shape[1] - 1)
        rows = torch.arange(b, device=x.device)
        ckv[rows, at] = c_kv[:, 0]
        kpe[rows, at] = k_pe[:, 0]
        k, v = _mla_expand(p, cfg, ckv, kpe)
        out = ops.decode_attention(q[:, 0].contiguous(), k, v,
                                   kv_len=cache_len + 1,
                                   scale=scale)[:, None]
        new_cache = (ckv, kpe)
    y = out.reshape(b, s, h * m.v_head_dim) @ p["wo"]
    return y, new_cache
