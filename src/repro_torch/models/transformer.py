"""Config-driven model assembly in PyTorch, with the JAX package's names
(``repro.models.transformer``), for the dense family - GQA / MQA
attention with a GLU feed-forward (gemma, qwen3, yi, command-r's layer
kind) -, the MoE feed-forward behind GQA attention (olmoe-1b-7b) or
behind MLA (deepseek-v2-lite-16b: multi-head latent attention, its
first layer dense at the MoE config's ``dense_d_ff``), RWKV6
(an rwkv time-mix with a channel-mix, rwkv6-1.6b), the hybrid family
(jamba: Mamba mixers with one attention layer in ``attn_period``, the
MoE on every ``layer_stride``-th layer, the rest dense at
``dense_d_ff``) and the two context
families: llama-3.2-vision's cross-attention layers over vision
embeddings, and whisper's encoder-decoder (a bidirectional encoder over
stub frame embeddings, each decoder layer a cross-attention sublayer
over its output, a plain GELU feed-forward, layernorm with biases).

The layer sequence is an optional unstacked prefix followed by a
repeating superblock whose params are stacked on a leading axis, as in
the JAX package, so a JAX parameter tree carries across leaf for leaf.
Superblocks run as a Python loop.  Modes:

  train    full causal forward -> mean loss (``forward_train``); each
           superblock, each encoder layer and each sequence chunk of
           the loss checkpointed, so the backward recomputes their
           interiors
  prefill  full causal forward over a prompt -> last-token logits, and
           the KV cache filled (with a context, the cross caches too)
  decode   one token per row against the cache

The attention cache is head-major, ``(n_super, B, Hkv, Lmax, D)`` per
stacked layer; an rwkv layer caches its two token-shift vectors ``tm``
and ``cm`` (B, d) and its fp32 WKV state ``wkv`` (B, H, dh, dh), and a
mamba layer its conv state ``conv`` (B, d_conv - 1, d_inner) in the
model type and its fp32 scan state ``ssm`` (B, d_inner, d_state),
whatever ``max_len``; an MLA layer its latent ``ckv`` (B, Lmax, rank)
and shared rope key ``kpe`` (B, Lmax, rope); a cross layer caches the
projected context as ``xk``/``xv`` (``enc_k``/``enc_v`` for whisper's
cross sublayer), head-major
``(B, Hkv, ctx_len, D)``, written by a prefill with a context and read
by every later step.  Prefill and decode update the cache in place.  An
MoE layer's aux loss is summed over the layers into the training loss.
On the card, training runs through the attention, RMSNorm, WKV, causal
conv and selective scan kernels' backward kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (cross_entropy, dtype_of, embed_init,
                                       glu_mlp_apply, glu_mlp_init,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init, stack_layers, tree_leaves,
                                       tree_map)
from repro_torch.runtime import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # attn | mla | mamba | rwkv | cross
    moe: bool
    cross: bool         # additional cross-attn sublayer (whisper dec)


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    specs = []
    for i in range(cfg.n_layers):
        if cfg.is_cross_layer(i):
            mixer = "cross"
        elif cfg.mla is not None:
            mixer = "mla"
        else:
            mixer = cfg.layer_kind(i)
        specs.append(LayerSpec(mixer=mixer, moe=cfg.is_moe_layer(i),
                               cross=(cfg.encoder_layers > 0)))
    return specs


def split_pattern(specs: list[LayerSpec]) -> tuple[int, int]:
    """Return (prefix_len, period) minimizing the unstacked size
    (prefix + period), as the JAX package does."""
    n = len(specs)
    best: tuple[int, int] | None = None
    for prefix in range(0, n):
        rest = specs[prefix:]
        m = len(rest)
        for period in range(1, m + 1):
            if m % period:
                continue
            if all(rest[i] == rest[i % period] for i in range(m)):
                cand = (prefix, period)
                if best is None or (cand[0] + cand[1], cand[1]) < (
                        best[0] + best[1], best[1]):
                    best = cand
                break  # larger periods at this prefix are never better
    return best if best is not None else (n, 1)


# ----------------------------- layer ---------------------------------

def layer_init(gen, cfg: ModelConfig, spec: LayerSpec, dtype,
               device) -> dict:
    rwkv = spec.mixer == "rwkv"
    p = {"norm1": norm_init(cfg.d_model, cfg.norm, dtype, device,
                            cfg.use_bias)}
    if rwkv:
        p["mixer"] = rwkv_mod.rwkv_time_mix_init(gen, cfg, dtype, device)
    elif spec.mixer == "cross":
        p["mixer"] = attn.cross_attn_init(gen, cfg, dtype, device)
    elif spec.mixer == "mla":
        p["mixer"] = attn.mla_init(gen, cfg, dtype, device)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_mod.mamba_init(gen, cfg, dtype, device)
    else:
        p["mixer"] = attn.gqa_init(gen, cfg, dtype, device)
    if spec.cross:
        p["cross_norm"] = norm_init(cfg.d_model, cfg.norm, dtype, device,
                                    cfg.use_bias)
        p["cross"] = attn.cross_attn_init(gen, cfg, dtype, device)
    p["norm2"] = norm_init(cfg.d_model, cfg.norm, dtype, device,
                           cfg.use_bias)
    # a dense layer of an MoE model takes the config's dense width
    d_ff = (cfg.moe.dense_d_ff if cfg.moe is not None
            and cfg.moe.dense_d_ff else cfg.d_ff)
    if spec.moe:
        p["ffn"] = moe_mod.moe_init(gen, cfg, dtype, device)
    elif rwkv:
        p["ffn"] = rwkv_mod.rwkv_channel_mix_init(gen, cfg, dtype, device)
    elif cfg.family == "audio":
        p["ffn"] = mlp_init(gen, cfg.d_model, d_ff, dtype, device,
                            use_bias=True)
    else:
        p["ffn"] = glu_mlp_init(gen, cfg.d_model, d_ff, dtype, device,
                                cfg.use_bias)
    return p


def cache_init_layer(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, ctx_len: int, dtype, device) -> dict:
    """Empty cache entry for one layer: head-major k/v for attention, the
    latent ``ckv`` and rope key ``kpe`` for MLA (no head axis: the
    reference's layout), the token shifts and WKV state for rwkv, the
    conv and scan states for mamba, the ``ctx_len``-long
    projected context of a cross mixer (``xk``/``xv``) and of a cross
    sublayer (``enc_k``/``enc_v``)."""

    def kv(length):
        shape = (batch, cfg.n_kv_heads, length, cfg.kv_head_dim())
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    c: dict[str, Any] = {}
    if spec.mixer == "rwkv":
        st = rwkv_mod.rwkv_state_init(cfg, batch, dtype, device)
        c.update(tm=st.tm_shift, cm=st.cm_shift, wkv=st.wkv)
    elif spec.mixer == "mamba":
        st = mamba_mod.mamba_state_init(cfg, batch, dtype, device)
        c.update(conv=st.conv, ssm=st.ssm)
    elif spec.mixer == "cross":
        c["xk"], c["xv"] = kv(ctx_len)
    elif spec.mixer == "mla":
        m = cfg.mla
        c["ckv"] = torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                               device=device)
        c["kpe"] = torch.zeros((batch, max_len, m.qk_rope_head_dim),
                               dtype=dtype, device=device)
    else:
        c["k"], c["v"] = kv(max_len)
    if spec.cross:
        c["enc_k"], c["enc_v"] = kv(ctx_len)
    return c


def _cross(p, cfg: ModelConfig, h, context, cache, names):
    """A cross-attention over ``context``, or over the cache entries
    ``names`` when no context is given; a context's projected k/v are
    written into those entries (in place) when there is a cache."""
    build = cache is not None
    cached = (cache[names[0]], cache[names[1]]) \
        if build and context is None else None
    y, (k, v) = attn.cross_attn_apply(p, cfg, h, context, cached_kv=cached)
    if build and context is not None:
        cache[names[0]].copy_(k)
        cache[names[1]].copy_(v)
    return y


def layer_apply(p, cfg: ModelConfig, spec: LayerSpec, x, *, positions,
                context=None, cache=None, cache_len=None):
    """Returns (x, new_cache, aux_loss); the cache is updated in
    place.  Under tensor parallelism a model with a part that does not
    split over 'model' raises ``NotImplementedError``."""
    if tp.active() is not None:
        tp.refuse(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict[str, Any] = {}
    build = cache is not None
    h = norm_apply(p["norm1"], x, cfg.norm)
    if spec.mixer == "rwkv":
        y, tm_out, wkv_out = rwkv_mod.rwkv_time_mix_apply(
            p["mixer"], cfg, h, cache["tm"] if build else None,
            cache["wkv"] if build else None)
        if build:
            new_cache["tm"] = cache["tm"].copy_(tm_out)
            new_cache["wkv"] = cache["wkv"].copy_(wkv_out)
    elif spec.mixer == "mamba":
        st = (mamba_mod.MambaState(cache["conv"], cache["ssm"]) if build
              else None)
        y, st_out = mamba_mod.mamba_apply(p["mixer"], cfg, h, st)
        if build:
            new_cache["conv"] = cache["conv"].copy_(st_out.conv)
            new_cache["ssm"] = cache["ssm"].copy_(st_out.ssm)
    elif spec.mixer == "cross":
        y = _cross(p["mixer"], cfg, h, context, cache, ("xk", "xv"))
    elif spec.mixer == "mla":
        ckv = (cache["ckv"], cache["kpe"]) if build else None
        y, kv_out = attn.mla_apply(p["mixer"], cfg, h, positions,
                                   cache_ckv=ckv, cache_len=cache_len)
        if build:
            new_cache["ckv"], new_cache["kpe"] = kv_out
    else:
        kv = (cache["k"], cache["v"]) if build else None
        y, kv_out = attn.gqa_apply(p["mixer"], cfg, h, positions,
                                   cache_kv=kv, cache_len=cache_len)
        if build:
            new_cache["k"], new_cache["v"] = kv_out
    x = x + y
    if spec.cross:
        h = norm_apply(p["cross_norm"], x, cfg.norm)
        x = x + _cross(p["cross"], cfg, h, context, cache,
                       ("enc_k", "enc_v"))
    h = norm_apply(p["norm2"], x, cfg.norm)
    if spec.moe:
        y, aux = moe_mod.moe_apply(p["ffn"], cfg, h, cfg.hidden_act)
    elif spec.mixer == "rwkv":
        y, cm_out = rwkv_mod.rwkv_channel_mix_apply(
            p["ffn"], cfg, h, cache["cm"] if build else None)
        if build:
            new_cache["cm"] = cache["cm"].copy_(cm_out)
    elif cfg.family == "audio":
        y = mlp_apply(p["ffn"], h, "gelu")
    else:
        y = glu_mlp_apply(p["ffn"], h, cfg.hidden_act)
    x = x + y
    return x, new_cache, aux


# --------------------------- whole model ------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights drawn from ``seed`` on ``device`` (``None``:
    CUDA; ``"meta"``: shapes only), with the JAX package's tree."""
    dev = torch.device("meta") if device == "meta" else \
        resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    specs = layer_specs(cfg)
    prefix, period = split_pattern(specs)
    n_super = (cfg.n_layers - prefix) // period
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev,
                                cfg.use_bias),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, dev)
    for i in range(prefix):
        params[f"prefix_{i}"] = layer_init(gen, cfg, specs[i], dtype, dev)

    def superblock_init(g):
        return {f"sub{j}": layer_init(g, cfg, specs[prefix + j], dtype, dev)
                for j in range(period)}

    params["blocks"] = stack_layers(gen, n_super, superblock_init)
    if cfg.encoder_layers:
        params["encoder"] = {
            "blocks": stack_layers(
                gen, cfg.encoder_layers,
                lambda g: layer_init(g, cfg, ENCODER_SPEC, dtype, dev)),
            "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev,
                                    cfg.use_bias),
        }
    return params


#: an encoder layer: bidirectional self-attention and the feed-forward
ENCODER_SPEC = LayerSpec(mixer="attn", moe=False, cross=False)


def _sinusoid(positions, d: int):
    """(T,) positions -> (T, d) fp32 sinusoid embedding, sines then
    cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encoder_layer_apply(p, cfg: ModelConfig, x):
    """One encoder layer: bidirectional self-attention, then the GELU
    feed-forward, each behind its norm and added to x."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    x = x + attn.encoder_attn_apply(p["mixer"], cfg, h)
    h = norm_apply(p["norm2"], x, cfg.norm)
    return x + mlp_apply(p["ffn"], h, "gelu")


def encode(params, cfg: ModelConfig, frames):
    """Whisper-style encoder over stub frame embeddings (B, T, d): the
    frames cast to the model type plus the fp32 sinusoid cast to it, the
    layers, the final norm.  Under autograd with a parameter that
    requires a gradient, each layer runs under ``torch.utils.checkpoint``
    (the JAX package remats it), so only the layer boundaries are kept
    for the backward.  Under tensor parallelism it raises
    ``NotImplementedError`` (the encoder does not split)."""
    if tp.active() is not None:
        tp.refuse(cfg)
    dtype = dtype_of(cfg.dtype)
    enc = params["encoder"]
    t = frames.shape[1]
    pos = torch.arange(t, device=frames.device)
    x = frames.to(dtype) + _sinusoid(pos, cfg.d_model).to(dtype)
    train = torch.is_grad_enabled() and any(
        leaf.requires_grad for leaf in tree_leaves(enc))
    layers = tree_map(lambda a: a.unbind(0), enc["blocks"])
    for i in range(cfg.encoder_layers):
        layer_p = tree_map(lambda a: a[i], layers)
        if train:
            x = checkpoint(encoder_layer_apply, layer_p, cfg, x,
                           use_reentrant=False)
        else:
            x = encoder_layer_apply(layer_p, cfg, x)
    return norm_apply(enc["final_norm"], x, cfg.norm)


def _context(params, cfg: ModelConfig, context):
    """The context the cross layers read: ``frames`` through the encoder
    for an encoder-decoder model, else the vision embeddings cast to the
    model type (None stays None)."""
    if context is None:
        return None
    if cfg.encoder_layers:
        return encode(params, cfg, context)
    return context.to(dtype_of(cfg.dtype))


def _embed_tokens(params, cfg: ModelConfig, tokens):
    """The tokens' embeddings (vocab-parallel under tensor parallelism),
    scaled where the config says so."""
    x = tp.embed(params["embed"], tokens)
    if cfg.embed_scale:
        # sqrt(d_model) cast to the model type first, as in the JAX
        # package (45.25 in bf16 for d = 2048)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params, cfg: ModelConfig, x):
    """Logits over the whole vocab; under tensor parallelism each rank's
    vocab slice of them, gathered."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return tp.gather_vocab(x @ head.T)


def _run_layers(params, cfg: ModelConfig, x, *, positions, context=None,
                cache=None, cache_len=None):
    """Prefix layers, then the superblocks in a Python loop.  ``cache``
    (None without one) is updated in place and returned.  Without a
    cache (train mode) each superblock runs under
    ``torch.utils.checkpoint``, as the JAX package remats it: only the
    block boundaries are kept for the backward, which recomputes each
    block's interior; the stacked params are unbound once, so their
    gradients are stacked once."""
    specs = layer_specs(cfg)
    prefix, period = split_pattern(specs)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(prefix):
        c = cache[f"prefix_{i}"] if cache is not None else None
        x, _, aux = layer_apply(params[f"prefix_{i}"], cfg, specs[i], x,
                                positions=positions, context=context,
                                cache=c, cache_len=cache_len)
        aux_total = aux_total + aux
    n_super = (cfg.n_layers - prefix) // period

    def block(block_p, x, block_c=None):
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(period):
            c = block_c[f"sub{j}"] if block_c is not None else None
            x, _, aux = layer_apply(block_p[f"sub{j}"], cfg,
                                    specs[prefix + j], x,
                                    positions=positions, context=context,
                                    cache=c, cache_len=cache_len)
            aux_acc = aux_acc + aux
        return x, aux_acc

    if cache is None:
        layers = tree_map(lambda a: a.unbind(0), params["blocks"])
        for i in range(n_super):
            block_p = tree_map(lambda a: a[i], layers)
            x, aux = checkpoint(block, block_p, x, use_reentrant=False)
            aux_total = aux_total + aux
        return x, cache, aux_total
    for i in range(n_super):
        block_p = tree_map(lambda a: a[i], params["blocks"])
        block_c = tree_map(lambda a: a[i], cache["blocks"])
        x, aux = block(block_p, x, block_c)
        aux_total = aux_total + aux
    return x, cache, aux_total


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               ctx_len: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    specs = layer_specs(cfg)
    prefix, period = split_pattern(specs)
    n_super = (cfg.n_layers - prefix) // period
    cache: dict[str, Any] = {}
    for i in range(prefix):
        cache[f"prefix_{i}"] = cache_init_layer(cfg, specs[i], batch,
                                                max_len, ctx_len, dtype, dev)
    one = {f"sub{j}": cache_init_layer(cfg, specs[prefix + j], batch,
                                       max_len, ctx_len, dtype, dev)
           for j in range(period)}
    cache["blocks"] = tree_map(
        lambda x: x[None].expand((n_super,) + tuple(x.shape)).contiguous(),
        one)
    cache["length"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


#: sequence-chunk size of the streamed cross-entropy: the fp32 logits
#: exist one chunk at a time, and each chunk is checkpointed, so the
#: backward recomputes its logits instead of keeping them
CE_CHUNK = 512


def _chunk_loss(xc, yc, head):
    """Summed softmax cross-entropy of one chunk: :func:`cross_entropy`'s
    mean (fp32 logits, the gold logit by a gather) times its count."""
    return cross_entropy(xc @ head.T, yc) * yc.numel()


def _chunked_ce(params, cfg: ModelConfig, x, labels):
    """Mean next-token cross-entropy over sequence chunks of
    ``CE_CHUNK`` positions across the whole batch, the remainder last,
    as in the JAX package: never the full (B, S, V) logit tensor."""
    b = x.shape[0]
    shift_x = x[:, :-1]
    shift_y = labels[:, 1:].long()
    n = shift_x.shape[1]
    chunk = min(CE_CHUNK, n)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        total = total + checkpoint(_chunk_loss, shift_x[:, start:stop],
                                   shift_y[:, start:stop], head,
                                   use_reentrant=False)
    return total / (b * n)


def forward_train(params, cfg: ModelConfig, batch):
    """batch: {tokens, labels} (B, S) integer tensors on the params'
    device, with ``frames`` (B, T, d) for an encoder-decoder model or,
    optionally, ``vision_embeds`` (B, T, d) -> mean loss (+ the layers'
    aux losses), differentiable.  A model without cross layers ignores
    the embeddings, as the JAX package does.  Tensor-parallel training is
    not ported (ROADMAP §1 item 9c): under an active group it raises
    ``NotImplementedError``."""
    if tp.active() is not None:
        raise NotImplementedError(
            "tensor-parallel training is not ported (ROADMAP §1 item 9c)")
    context = _context(params, cfg, batch["frames"] if cfg.encoder_layers
                       else batch.get("vision_embeds"))
    tokens = batch["tokens"].long()
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    x, _, aux = _run_layers(params, cfg, x, positions=positions,
                            context=context)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return _chunked_ce(params, cfg, x, batch["labels"]) + aux


def prefill(params, cfg: ModelConfig, tokens, cache, context=None):
    """Fill the cache from a full prompt ``tokens`` (B, S), on the
    cache's device; returns (last-token logits (B, 1, V), cache).  A
    ``context`` (whisper's frames, which go through the encoder, or
    vision embeddings) fills the cross caches, whose ``ctx_len`` must be
    its length; without one the cross layers read the caches as they
    are."""
    context = _context(params, cfg, context)
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    x, cache, _ = _run_layers(params, cfg, x, positions=positions,
                              context=context, cache=cache, cache_len=0)
    cache["length"] = torch.full_like(cache["length"], tokens.shape[1])
    x = norm_apply(params["final_norm"], x[:, -1:].contiguous(), cfg.norm)
    return _logits(params, cfg, x), cache


def decode_step(params, cfg: ModelConfig, token, cache):
    """token: (B, 1) -> (logits (B, 1, V), cache)."""
    x = _embed_tokens(params, cfg, token)
    length = cache["length"]
    x, cache, _ = _run_layers(params, cfg, x, positions=length[:, None],
                              cache=cache, cache_len=length)
    cache["length"] = length + 1
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x), cache


__all__ = ["LayerSpec", "layer_specs", "split_pattern", "layer_init",
           "cache_init_layer", "layer_apply", "init_params", "init_cache",
           "ENCODER_SPEC", "encoder_layer_apply", "encode", "CE_CHUNK",
           "forward_train", "prefill", "decode_step", "tree_leaves"]
