"""The port's prefill attention (plain version, the CPU route of the
flash kernel's wrapper) against the JAX package:
``repro.kernels.ops.flash_attention`` (the Pallas kernel, in interpret
mode on the CPU) where its block sizes divide the lengths, and
``ref.attention_ref`` everywhere, ragged lengths included, on inputs
made with numpy from a seed.

Tolerances: fp32 1e-5 on unit-scale inputs (rtol and atol; the sums run
in another order); bf16 2e-2, the JAX package's own bf16 tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_plain  # noqa: E402

pytestmark = pytest.mark.torch

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, hq, hkv, lq, lk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]
    j = [jnp.asarray(a).astype(JAX_DT[dtype]) for a in arrs]
    t = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]
    return j, t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (1, 4, 4, 128, 128, 64),     # MHA square
    (2, 8, 2, 128, 256, 64),     # GQA, Lq < Lk: rows are the last Lq
    (1, 8, 1, 256, 256, 32),     # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_equals_pallas(b, hq, hkv, lq, lk, d, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, hq, hkv, lq, lk, d, "float32",
                                         lq + lk + d)
    got = attention_plain(tq, tk, tv, causal=causal)
    assert_allclose(_f32(got), _f32(jops.flash_attention(
        jq, jk, jv, causal=causal)), **TOLS["float32"])


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (2, 8, 1, 37, 37, 32),       # ragged, MQA (gemma's grouping)
    (1, 4, 2, 5, 70, 64),        # Lq < Lk causal, ragged
    (3, 2, 2, 1, 9, 128),        # one row
    (1, 8, 8, 100, 131, 256),    # gemma's head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_equals_oracle(b, hq, hkv, lq, lk, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, hq, hkv, lq, lk, d, dtype, d)
    for causal in (True, False):
        got = attention_plain(tq, tk, tv, causal=causal)
        assert got.dtype == tq.dtype
        assert_allclose(_f32(got), _f32(jref.attention_ref(
            jq, jk, jv, causal=causal)), **TOLS[dtype])


def test_scale_and_cpu_route():
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 2, 1, 16, 24, 32, "float32", 1)
    before = tfa.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=True, scale=0.3)
    assert tfa.flash_attention.launches == before
    assert_allclose(_f32(got), _f32(jref.attention_ref(
        jq, jk, jv, causal=True, scale=0.3)), **TOLS["float32"])


# --- the bf16 backward's launch plan (pure Python; the launch takes its
# --- split and its scratch, and the card tests hold what the kernel does
# --- with them)

@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (4, 8, 1, 2048, 2048, 256),   # gemma-2b's training shape
    (4, 16, 8, 2048, 2048, 128),  # qwen3-1.7b's
    (2, 8, 2, 700, 700, 64),
    (1, 8, 1, 333, 1001, 256),
    (2, 8, 1, 64, 64, 32),
    (1, 32, 2, 129, 129, 128),
])
@pytest.mark.parametrize("sms", [1, 132, 100_000])
def test_bwd_plan_covers_every_query_head_once(b, hq, hkv, lq, lk, d, sms):
    """On a card of one SM (no split), an H100 and a card so wide that
    every group splits as far as it may: S_h divides the group, so the
    kernel's blocks of ``group // S_h`` consecutive heads walk each query
    head once, and keeps two heads a block; the scratch holds the row
    statistics and, when split, the partials."""
    group = hq // hkv
    plan = tfa.bwd_plan(b, hq, hkv, lq, lk, d, sms)
    s_h = plan.head_splits
    assert group % s_h == 0 and (s_h == 1 or group // s_h >= 2)
    if sms == 1 or group <= 2:
        assert s_h == 1
    stats = 2 * b * hq * (-(-lq // 64) * 64)
    partials = 2 * s_h * b * hkv * (-(-lk // 64) * 64) * d
    assert plan.scratch_floats == stats + (partials if s_h > 1 else 0)


def test_bwd_plan_splits_only_short_grids_of_wide_groups():
    """gemma-2b (MQA, group 8) on an H100: 128 dK/dV blocks on 132 SMs,
    split in 4 (512 blocks, two heads each, a 67 MB scratch of partials);
    qwen3-1.7b (group 2, 1024 blocks) and every group of 1 or 2 never
    split, however wide the card; a grid of two waves or more stays
    whole; a group of 16 splits in 8 at most (two heads a block)."""
    gemma = tfa.bwd_plan(4, 8, 1, 2048, 2048, 256, 132)
    assert gemma.head_splits == 4
    assert 67e6 < 4 * gemma.scratch_floats < 68e6
    assert tfa.bwd_plan(4, 16, 8, 2048, 2048, 128, 132).head_splits == 1
    for hq, hkv in ((2, 2), (4, 2), (8, 8), (16, 8)):
        assert tfa.bwd_plan(1, hq, hkv, 64, 64, 64, 100_000).head_splits == 1
    assert tfa.bwd_plan(16, 8, 1, 2048, 2048, 256, 132).head_splits == 1
    assert tfa.bwd_plan(1, 16, 1, 64, 64, 64, 132).head_splits == 8
