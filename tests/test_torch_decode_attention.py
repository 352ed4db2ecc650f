"""The port's one-token decode attention (plain version, the CPU route
of the flash-decode kernel's wrapper) against the JAX package:
``repro.kernels.ops.decode_attention`` (the Pallas kernel, in interpret
mode on the CPU) where its block divides the cache, and
``ref.decode_attention_ref`` everywhere, ragged ``kv_len`` included, on
inputs made with numpy from a seed.

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
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import decode_attention_plain  # noqa: E402

pytestmark = pytest.mark.torch

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, hq, hkv, L, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, d), (b, hkv, L, d), (b, hkv, L, d))]
    lens = rng.integers(1, L + 1, size=b).astype(np.int32)
    j = [jnp.asarray(a).astype(JAX_DT[dtype]) for a in arrs]
    t = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]
    return j, t, lens


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("b,hq,hkv,L,d", [
    (2, 8, 1, 512, 64),     # MQA, two blocks
    (3, 4, 2, 256, 128),    # GQA
    (1, 8, 8, 256, 32),     # MHA
])
@pytest.mark.parametrize("ragged", [False, True])
def test_plain_equals_pallas(b, hq, hkv, L, d, ragged):
    (jq, jk, jv), (tq, tk, tv), lens = _inputs(b, hq, hkv, L, d, "float32",
                                               L + d)
    jl = jnp.asarray(lens) if ragged else None
    tl = torch.from_numpy(lens) if ragged else None
    got = decode_attention_plain(tq, tk, tv, tl)
    assert_allclose(_f32(got), _f32(jops.decode_attention(
        jq, jk, jv, jl)), **TOLS["float32"])


@pytest.mark.parametrize("b,hq,hkv,L,d", [
    (4, 8, 1, 77, 256),     # gemma's grouping and head dim, ragged cache
    (2, 2, 1, 5, 32),
    (3, 8, 4, 130, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_equals_oracle(b, hq, hkv, L, d, dtype):
    (jq, jk, jv), (tq, tk, tv), lens = _inputs(b, hq, hkv, L, d, dtype, b)
    for jl, tl in ((None, None),
                   (jnp.asarray(lens), torch.from_numpy(lens))):
        got = decode_attention_plain(tq, tk, tv, tl)
        assert got.dtype == tq.dtype
        assert_allclose(_f32(got), _f32(jref.decode_attention_ref(
            jq, jk, jv, jl)), **TOLS[dtype])


#: one kv_len per batch row: the edges of the CUDA kernel's 32-key tiles
#: (a split is a run of whole tiles), the whole cache and past it
EDGE_LENS = (1, 31, 32, 33, 63, 64, 65, 96, 97, 256, 265)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_on_tile_edges_and_groups(group, dtype):
    """Every query group 1-8 over a 256-key cache with kv_len on the tile
    edges and above L (which masks nothing): fp32 against the Pallas
    kernel (64-key blocks), bf16 against the oracle."""
    b, hkv, L, d = len(EDGE_LENS), 2, 256, 32
    (jq, jk, jv), (tq, tk, tv), _ = _inputs(b, group * hkv, hkv, L, d, dtype,
                                            group)
    lens = np.asarray(EDGE_LENS, np.int32)
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    if dtype == "float32":
        exp = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=64)
    else:
        exp = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    assert_allclose(_f32(got), _f32(exp), **TOLS[dtype])


def test_decode_equals_last_prefill_row():
    """A decode over kv_len keys is the causal prefill's row kv_len-1."""
    from repro_torch.kernels.ref import attention_plain
    (_, _, _), (tq, tk, tv), _ = _inputs(2, 4, 2, 20, 32, "float32", 5)
    rng = np.random.default_rng(6)
    q_full = torch.from_numpy(rng.standard_normal(
        (2, 4, 20, 32)).astype(np.float32))
    rows = attention_plain(q_full, tk, tv, causal=True)
    lens = torch.tensor([20, 20], dtype=torch.int32)
    got = decode_attention_plain(q_full[:, :, -1].contiguous(), tk, tv, lens)
    assert_allclose(got.numpy(), rows[:, :, -1].numpy(), rtol=1e-5,
                    atol=1e-5)


def test_cpu_route_runs_the_plain_version():
    (_, _, _), (tq, tk, tv), lens = _inputs(2, 4, 1, 40, 64, "float32", 7)
    tl = torch.from_numpy(lens)
    before = tda.decode_attention.launches
    np.testing.assert_array_equal(
        ops.decode_attention(tq, tk, tv, tl).numpy(),
        decode_attention_plain(tq, tk, tv, tl).numpy())
    assert tda.decode_attention.launches == before


@pytest.mark.parametrize("entry", [decode_attention_plain,
                                   tda.decode_attention, ops.decode_attention])
def test_zero_kv_len_rows_are_nan_as_in_the_reference(entry):
    """kv_len 0 masks every key: the reference's softmax over no key is
    0/0, so those rows are NaN.  The port gives NaN exactly there (fp32,
    a batch mixing 0 and non-zero lengths) and the reference's values,
    within 1e-5, everywhere else."""
    (jq, jk, jv), (tq, tk, tv), _ = _inputs(3, 4, 2, 40, 64, "float32", 7)
    lens = np.array([0, 17, 0], np.int32)
    exp = np.asarray(jref.decode_attention_ref(jq, jk, jv,
                                               jnp.asarray(lens)))
    got = entry(tq, tk, tv, torch.from_numpy(lens)).numpy()
    assert np.isnan(exp[[0, 2]]).all() and not np.isnan(exp[1]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    assert_allclose(got[1], exp[1], **TOLS["float32"])
