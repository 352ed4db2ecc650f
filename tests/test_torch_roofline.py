"""The port's HLO parsers and FLOP counter (``repro_torch.launch.
roofline``).

* ``collective_bytes_from_hlo``, ``extrapolate_body`` and
  ``CollectiveStats.combine`` equal ``repro.launch.roofline``'s with
  ``==`` on the same HLO texts: the parser tests' texts of the JAX
  package, async pairs with tuple results and ``-done`` lines, every
  collective, a dtype without a size.
* ``cost_analysis_dict(fn, *args)`` counts one call's FLOPs with
  ``torch.utils.flop_counter``.  At the smoke configs of gemma-2b,
  qwen3-1.7b and whisper-medium it equals ``analytic_cost``'s parts,
  each times a stated factor, exactly:
  - prefill: the param matmuls, cross context and encoder times 1; the
    lm head times 1 / L (a prefill's logits are its last token's); the
    causal attention scores times 2 (the plain attention computes all
    L x L pairs, the analytic model counts the causal half).
  - train step (loss and gradients; the optimizer has no product): the
    matmul parts times 4 / 3 (the analytic model counts forward and
    backward, 3; the port also recomputes each checkpointed block's
    forward in the backward, 4), the lm head also times (L - 1) / L
    (the loss reads L - 1 shifted positions), the attention scores
    times 2 (all pairs, as above, with its recompute in both counts),
    less one forward of each checkpointed block's last product, its
    feed-forward's down projection, which the non-reentrant checkpoint
    does not recompute (nothing in the backward needs its output).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jrf  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import _dec_len  # noqa: E402
from repro_torch.launch import analytic as an  # noqa: E402
from repro_torch.launch import roofline as trf  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

pytestmark = pytest.mark.torch

HLO = {
    "result_shapes": """
  %ar = bf16[16,512]{1,0} all-reduce(bf16[16,512]{1,0} %x), replica_groups={}
  %ag.1 = f32[4,128]{1,0} all-gather(f32[1,128]{1,0} %y), dimensions={0}
  %nope = bf16[2,2]{1,0} add(bf16[2,2] %a, bf16[2,2] %b)
""",
    "async_pair": """
  %s = (bf16[8]{0}, bf16[8]{0}) all-reduce-start(bf16[8]{0} %x)
  %d = bf16[8]{0} all-reduce-done((bf16[8], bf16[8]) %s)
""",
    "every_collective": """
  %rs = f32[2,64]{1,0} reduce-scatter(f32[32,64]{1,0} %g), dimensions={0}
  %a2a = (s32[4,8]{1,0}, s32[4,8]{1,0}) all-to-all(s32[4,8] %p, s32[4,8] %q)
  %cp = u8[1024]{0} collective-permute(u8[1024]{0} %z), source_target_pairs={{0,1}}
  %ags = (f32[1,128]{1,0}, f32[16,128]{1,0}) all-gather-start(f32[1,128] %w)
  %agd = f32[16,128]{1,0} all-gather-done((f32[1,128], f32[16,128]) %ags)
  %cps = (bf16[2,3]{1,0}, bf16[2,3]{1,0}, u32[], u32[]) collective-permute-start(bf16[2,3] %v)
  %cpd = bf16[2,3]{1,0} collective-permute-done(%cps)
  %odd = token[] all-reduce(token[] %t)
  %fp8 = f8e4m3fn[3,5]{1,0} all-reduce(f8e4m3fn[3,5]{1,0} %e)
  ROOT %t = (bf16[16,512]{1,0}) tuple(%ar)
""",
    "no_collective": """
HloModule m
ENTRY %main (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  ROOT %n = f32[4]{0} negate(f32[4]{0} %p)
}
""",
}


@pytest.mark.parametrize("name", sorted(HLO))
def test_collective_bytes_match_reference(name):
    got = trf.collective_bytes_from_hlo(HLO[name])
    want = jrf.collective_bytes_from_hlo(HLO[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "async_pair":
        assert got.n_ops == 1


def _pair(total, by_op, n_ops):
    return (trf.CollectiveStats(total, dict(by_op), n_ops),
            jrf.CollectiveStats(total, dict(by_op), n_ops))


@pytest.mark.parametrize("scale", [1.0, 0.5, 3.0])
def test_combine_matches_reference(scale):
    ta, ja = _pair(100, {"all-reduce": 60, "all-gather": 40}, 3)
    tb, jb = _pair(33, {"all-reduce": 11, "reduce-scatter": 22}, 2)
    assert dataclasses.asdict(ta.combine(tb, scale)) == dataclasses.asdict(
        ja.combine(jb, scale))


@pytest.mark.parametrize("c1,c2,n_super", [
    ((100, {"all-reduce": 100}, 2), (160, {"all-reduce": 160}, 3), 10),
    ((50, {"all-gather": 50}, 1),
     (40, {"all-gather": 30, "all-reduce": 10}, 2), 4),   # a shrink: 0
    ((0, {}, 0), (7, {"all-to-all": 7}, 1), 1),
])
def test_extrapolate_body_matches_reference(c1, c2, n_super):
    (t1, j1), (t2, j2) = _pair(*c1), _pair(*c2)
    assert dataclasses.asdict(trf.extrapolate_body(t1, t2, n_super)) == \
        dataclasses.asdict(jrf.extrapolate_body(j1, j2, n_super))


# ------------------------------ FLOP counter ----------------------------

B = 2


def _cell(arch):
    """(config, frames length s, decoder length L, params, tokens,
    frames or None)."""
    cfg = smoke_config(arch)
    s = 512 if cfg.family == "audio" else 64
    length = _dec_len(cfg, s)
    params = ttf.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((B, length), dtype=torch.int32)
    frames = (torch.zeros((B, s, cfg.d_model)) if cfg.family == "audio"
              else None)
    return cfg, s, length, params, tokens, frames


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-1.7b",
                                  "whisper-medium"])
def test_prefill_flops_equal_the_analytic_parts(arch):
    cfg, s, length, params, tokens, frames = _cell(arch)
    cache = ttf.init_cache(cfg, B, length, ctx_len=s if frames is not None
                           else 0, device="cpu")
    cost = trf.cost_analysis_dict(ttf.prefill, params, cfg, tokens, cache,
                                  context=frames)
    part = an.analytic_cost(cfg, ShapeConfig("cell", s, B, "prefill"),
                            1, tp=1).flops_by_part
    attention = 2 * part["attn_scores"]          # all pairs, not half
    matmuls = (part["param_matmuls"] + part["lm_head"] / length
               + part["cross_context"] + part["encoder"])
    assert cost["flops"] == matmuls + attention
    if frames is None:      # the products split: params by mm, scores by bmm
        assert cost["flops:aten.mm"] == matmuls
        assert cost["flops:aten.bmm"] == attention


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-1.7b",
                                  "whisper-medium"])
def test_train_step_flops_equal_the_analytic_parts(arch):
    cfg, s, length, params, tokens, frames = _cell(arch)
    batch = {"tokens": tokens, "labels": tokens}
    if frames is not None:
        batch["frames"] = frames
    cost = trf.cost_analysis_dict(steps.value_and_grad, params, cfg, batch)
    part = an.analytic_cost(cfg, ShapeConfig("cell", s, B, "train"),
                            1, tp=1).flops_by_part
    prefix, period = ttf.split_pattern(ttf.layer_specs(cfg))
    n_blocks = (cfg.n_layers - prefix) // period
    # each checkpointed block's down projection, not recomputed
    tail = (n_blocks * 2 * B * length + cfg.encoder_layers * 2 * B * s) \
        * cfg.d_ff * cfg.d_model
    recomputed = 4 / 3
    matmuls = recomputed * (part["param_matmuls"] + part["cross_context"]
                            + part["encoder"]
                            + part["lm_head"] * (length - 1) / length)
    attention = 2 * part["attn_scores"]
    assert cost["flops"] == matmuls + attention - tail
    if frames is None:
        assert cost["flops:aten.mm"] == matmuls - tail
        assert cost["flops:aten.bmm"] == attention
