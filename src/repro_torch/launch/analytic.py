"""Analytic FLOPs / HBM-traffic model for the roofline compute & memory
terms: a copy of the JAX package's ``repro.launch.analytic`` under the
same names, over the port's configs (plain arithmetic, no device code).
One H100 is ``n_chips=1, tp=1``; the defaults (``tp=16``) are the
reference's pod, where ``dp = n_chips // tp`` must be at least 1.

Why analytic rather than ``compiled.cost_analysis()``: XLA's
HloCostAnalysis counts a while-loop body ONCE regardless of trip count,
so any scan-over-layers/time program under-reports FLOPs by ~the layer
count (verified on gemma-2b: reported 4.06e15 vs expected 1.58e16 -
exactly the body-counted-once signature).  Analytic model-FLOPs is also
the standard MFU accounting (PaLM App. B / MaxText): exact for matmuls,
explicit about attention quadratic terms, MoE active params, and
recurrent state updates.  Raw cost_analysis numbers are still recorded
in dryrun.json for transparency.

All formulas count multiply-accumulate as 2 FLOPs.  Train multiplier is
3x fwd (fwd + 2x bwd) for parameter matmuls and 4x for the
chunk-checkpointed components (attention scores, mamba/rwkv scans),
whose forward is recomputed during backward.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig

BF16 = 2


@dataclasses.dataclass
class CostBreakdown:
    flops_total: float            # whole step, all chips
    hbm_bytes_per_chip: float
    flops_by_part: dict
    bytes_by_part: dict


def _layer_matmul_params(cfg: ModelConfig, i: int) -> float:
    """Matmul parameters touched per token at layer i (active only)."""
    d = cfg.d_model
    hd = cfg.kv_head_dim()
    kind = cfg.layer_kind(i)
    if cfg.is_cross_layer(i):
        # q/o every text token; k/v are amortized over the context and
        # counted separately in cross-context flops
        mixer = d * cfg.n_heads * hd * 2
    elif cfg.mla is not None:
        m = cfg.mla
        mixer = (d * cfg.n_heads * (m.qk_nope_head_dim
                                    + m.qk_rope_head_dim)
                 + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                 + m.kv_lora_rank * cfg.n_heads
                 * (m.qk_nope_head_dim + m.v_head_dim)
                 + cfg.n_heads * m.v_head_dim * d)
    elif kind == "attn":
        mixer = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * hd * d
        if cfg.encoder_layers:   # whisper decoder adds cross-attn
            mixer += d * hd * (cfg.n_heads + 0) + cfg.n_heads * hd * d
    elif kind == "mamba":
        mb = cfg.mamba
        di = mb.expand * d
        dtr = mb.dt_rank or max(1, -(-d // 16))
        mixer = (d * 2 * di + mb.d_conv * di
                 + di * (dtr + 2 * mb.d_state) + dtr * di + di * d)
    elif kind == "rwkv":
        r = cfg.rwkv
        mixer = 5 * d * d + d * 5 * r.mix_lora + 5 * r.mix_lora * d \
            + d * r.decay_lora + r.decay_lora * d
    else:
        mixer = 0

    if cfg.is_moe_layer(i):
        m = cfg.moe
        ffn = d * m.n_experts \
            + (m.top_k + m.n_shared) * 3 * d * m.d_expert
    elif cfg.rwkv is not None:
        ffn = 2 * d * cfg.d_ff + d * d    # channel mix
    elif cfg.family == "audio":
        ffn = 2 * d * cfg.d_ff
    else:
        dff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.dense_d_ff:
            dff = cfg.moe.dense_d_ff
        ffn = 3 * d * dff
    return float(mixer + ffn)


def _recurrent_flops_per_token(cfg: ModelConfig, i: int) -> float:
    """State-update FLOPs per token (chunk-checkpointed -> 4x in train)."""
    kind = cfg.layer_kind(i)
    if kind == "mamba" and not cfg.is_cross_layer(i):
        di = cfg.mamba.expand * cfg.d_model
        return 9.0 * di * cfg.mamba.d_state
    if kind == "rwkv":
        return 6.0 * cfg.d_model * cfg.rwkv.head_size
    return 0.0


def _attn_layers(cfg: ModelConfig) -> list[int]:
    return [i for i in range(cfg.n_layers)
            if cfg.layer_kind(i) == "attn"
            and not cfg.is_cross_layer(i)
            and cfg.mla is None]


def _mla_layers(cfg: ModelConfig) -> list[int]:
    if cfg.mla is None:
        return []
    return [i for i in range(cfg.n_layers)
            if not cfg.is_cross_layer(i)]


def _cross_layers(cfg: ModelConfig) -> list[int]:
    return [i for i in range(cfg.n_layers) if cfg.is_cross_layer(i)]


def _score_dims(cfg: ModelConfig) -> float:
    """hq * hd for the score matmuls (MLA uses its own head dims)."""
    if cfg.mla is not None:
        m = cfg.mla
        return cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                              + m.v_head_dim) / 2.0
    return cfg.n_heads * cfg.kv_head_dim()


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig,
                  n_chips: int, tp: int = 16,
                  moment_bytes: int = 4) -> CostBreakdown:
    from repro_torch.configs.registry import _ctx_len, _dec_len, \
        n_params_analytic

    d = cfg.d_model
    b = shape.global_batch
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    dec_len = _dec_len(cfg, shape.seq_len)
    ctx_len = _ctx_len(cfg, shape.seq_len)
    if cfg.family == "vlm":
        ctx_len = cfg.vision.n_image_tokens

    # tokens processed this step
    if decode:
        tokens = float(b)                 # one new token per sequence
        kv_depth = float(shape.seq_len)   # attended history
    else:
        tokens = float(b * dec_len)
        kv_depth = dec_len / 2.0          # causal average

    mm = {"param_matmuls": 0.0, "attn_scores": 0.0, "recurrent": 0.0,
          "cross_context": 0.0, "lm_head": 0.0, "encoder": 0.0}

    # per-layer parameter matmuls + recurrences
    for i in range(cfg.n_layers):
        mm["param_matmuls"] += 2 * tokens * _layer_matmul_params(cfg, i)
        mm["recurrent"] += tokens * _recurrent_flops_per_token(cfg, i)

    # attention score+output flops: 4 * hq*hd * kv_depth per token
    n_full_attn = len(_attn_layers(cfg)) + len(_mla_layers(cfg))
    mm["attn_scores"] += 4 * tokens * kv_depth * _score_dims(cfg) \
        * n_full_attn

    # cross-attention: kv projection over the context (once per step)
    # + scores text x context
    ncross = len(_cross_layers(cfg)) + (
        cfg.n_layers if cfg.encoder_layers else 0)
    if ncross and ctx_len:
        hd = cfg.kv_head_dim()
        mm["cross_context"] += ncross * (
            2 * b * ctx_len * (d * 2 * cfg.n_kv_heads * hd)  # k,v proj
            + 4 * tokens * ctx_len * cfg.n_heads * hd)       # scores
        # decode reuses cached context k/v: drop the projection term
        if decode:
            mm["cross_context"] -= ncross * 2 * b * ctx_len * (
                d * 2 * cfg.n_kv_heads * hd)

    # encoder (whisper): bidirectional self-attn + mlp over enc frames
    if cfg.encoder_layers and not decode:
        enc_tokens = float(b * shape.seq_len)
        hd = cfg.kv_head_dim()
        per_layer = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * hd * d + 2 * d * cfg.d_ff
        mm["encoder"] += 2 * enc_tokens * per_layer \
            * cfg.encoder_layers
        mm["encoder"] += 4 * enc_tokens * shape.seq_len \
            * cfg.n_heads * hd * cfg.encoder_layers

    # lm head (+ tied embed matmul)
    mm["lm_head"] += 2 * tokens * d * cfg.vocab_size

    # training multipliers: 3x matmuls, 4x checkpointed components
    if train:
        for k in ("param_matmuls", "lm_head", "cross_context",
                  "encoder"):
            mm[k] *= 3
        for k in ("attn_scores", "recurrent"):
            mm[k] *= 4
    flops_total = sum(mm.values())

    # ----------------------------- HBM ------------------------------
    n_params = n_params_analytic(cfg)
    w_local = n_params * BF16 / tp        # params sharded over 'model'
    by = {}
    if train:
        # fwd read + bwd read + updated write
        by["weights"] = 3 * w_local
        # grads: write in bwd, read in optimizer
        by["grads"] = 2 * w_local
        # moments: read+write mu and nu (ZeRO shards over data too)
        dp = n_chips // tp
        by["optimizer"] = 4 * (n_params * moment_bytes) / (tp * dp)
        # activations: ~12 intermediate tensors per layer + boundaries
        tok_local = tokens / (n_chips / tp)
        by["activations"] = 12 * tok_local * d * BF16 * cfg.n_layers
        by["logits"] = 3 * tok_local * cfg.vocab_size / tp * 4
    elif decode:
        by["weights"] = w_local
        # stream the whole KV cache once per decoded token
        kv_bytes = _kv_cache_bytes(cfg, b, shape.seq_len, ctx_len)
        by["kv_cache"] = kv_bytes / n_chips
        by["activations"] = 2 * (b / max(n_chips / tp, 1)) * d * BF16 \
            * cfg.n_layers
    else:  # prefill
        by["weights"] = w_local
        tok_local = tokens / (n_chips / tp)
        by["activations"] = 12 * tok_local * d * BF16 * cfg.n_layers
        by["kv_cache"] = _kv_cache_bytes(
            cfg, b, dec_len, ctx_len) / n_chips
    hbm = sum(by.values())
    return CostBreakdown(flops_total=flops_total,
                         hbm_bytes_per_chip=hbm,
                         flops_by_part=mm, bytes_by_part=by)


def _kv_cache_bytes(cfg: ModelConfig, b: int, depth: int,
                    ctx_len: int) -> float:
    hd = cfg.kv_head_dim()
    total = 0.0
    for i in range(cfg.n_layers):
        if cfg.is_cross_layer(i):
            total += 2 * b * ctx_len * cfg.n_kv_heads * hd * BF16
        elif cfg.mla is not None:
            m = cfg.mla
            total += b * depth * (m.kv_lora_rank
                                  + m.qk_rope_head_dim) * BF16
        elif cfg.layer_kind(i) == "attn":
            total += 2 * b * depth * cfg.n_kv_heads * hd * BF16
            if cfg.encoder_layers:
                total += 2 * b * ctx_len * cfg.n_kv_heads * hd * BF16
        elif cfg.layer_kind(i) == "mamba":
            mb = cfg.mamba
            di = mb.expand * cfg.d_model
            total += b * di * (mb.d_conv - 1 + mb.d_state) * 4
        elif cfg.layer_kind(i) == "rwkv":
            r = cfg.rwkv
            n_h = cfg.d_model // r.head_size
            total += b * (n_h * r.head_size ** 2 * 4
                          + 2 * cfg.d_model * BF16)
    return total
