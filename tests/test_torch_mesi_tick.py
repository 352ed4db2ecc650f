"""The port's MESI tick (plain route, CPU tensors) against the JAX
reference's Pallas kernel in interpret mode and its numpy oracle, and
``mesi_decision_batch`` against the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels import mesi_transition as jmt  # noqa: E402
from repro_torch.kernels import mesi_transition as tmt  # noqa: E402

pytestmark = pytest.mark.torch

STRATEGIES = {"lazy": (False, 0), "eager": (True, 0),
              "access_count": (False, 3)}


def _random_tick_inputs(rng, B, n, m):
    state = rng.integers(0, 2, (B, n, m)).astype(np.int32)  # I or S
    version = rng.integers(1, 5, (B, m)).astype(np.int32)
    sync = np.where(state > 0, version[:, None, :], 0).astype(np.int32)
    reads = rng.integers(0, 5, (B, n, m)).astype(np.int32)
    acts = rng.integers(0, 2, (B, n)).astype(np.int32)
    arts = rng.integers(0, m, (B, n)).astype(np.int32)
    writes = rng.integers(0, 2, (B, n)).astype(np.int32)
    return state, version, sync, reads, acts, arts, writes


@pytest.mark.parametrize("B,n,m", [(6, 4, 3), (5, 1, 3), (7, 3, 1)])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_matches_pallas_and_oracle(B, n, m, strategy):
    eager, access_k = STRATEGIES[strategy]
    rng = np.random.default_rng(B * 100 + n * 10 + m)
    inputs = _random_tick_inputs(rng, B, n, m)
    opts = dict(artifact_tokens=64, eager=eager, access_k=access_k)
    t_in = [torch.as_tensor(x) for x in inputs]
    out = tmt.mesi_tick(*t_in, **opts)
    # functional: the inputs are left as they were
    for x, t in zip(inputs, t_in):
        np.testing.assert_array_equal(x, t.numpy())
    pallas = jmt.mesi_tick_pallas(
        *[jnp.asarray(x) for x in inputs], block_sims=4, interpret=True,
        **opts)
    assert len(pallas) == len(out) == 6
    for j, t in zip(pallas, out):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
        assert t.dtype == torch.int32
    st, ver, sy, rd, cnt = ref.mesi_tick_ref(*inputs, **opts)
    for exp, t in zip((st, ver, sy, rd), out):
        np.testing.assert_array_equal(exp, t.numpy())
    counters = out[4].numpy()
    for slot, key in enumerate(("fetch_tokens", "signal_tokens",
                                "push_tokens", "n_fetches", "n_hits")):
        np.testing.assert_array_equal(counters[:, slot], cnt[key])
    assert (counters[:, 6:] == 0).all()


def test_in_place_tick_updates_its_arguments():
    rng = np.random.default_rng(1)
    inputs = [torch.as_tensor(x) for x in _random_tick_inputs(rng, 4, 3, 2)]
    expected = tmt.mesi_tick(*inputs, artifact_tokens=16)
    state = [t.clone() for t in inputs[:4]]
    cnt, miss = tmt.mesi_tick_(*state, *inputs[4:], artifact_tokens=16)
    for exp, got in zip(expected, state + [cnt, miss]):
        assert torch.equal(exp, got)
    assert tmt.mesi_tick_.launches == 0   # the CPU route launches nothing


@pytest.mark.parametrize("bad,match", [
    ("dtype", "int32"), ("shape", "shape"), ("contiguous", "contiguous"),
    ("arts", r"\[0, 2\)")])
def test_wrapper_rejects_malformed_inputs(bad, match):
    rng = np.random.default_rng(2)
    inputs = [torch.as_tensor(x) for x in _random_tick_inputs(rng, 4, 3, 2)]
    if bad == "dtype":
        inputs[0] = inputs[0].long()
    elif bad == "shape":
        inputs[1] = inputs[1][:, :1]
    elif bad == "contiguous":
        inputs[4] = inputs[4].t().contiguous().t()
    else:
        inputs[5] = inputs[5] + 2
    with pytest.raises((TypeError, ValueError), match=match):
        tmt.mesi_tick(*inputs, artifact_tokens=16)


@pytest.mark.parametrize("pattern", ["none", "some", "all"])
@pytest.mark.parametrize("strategy", ["lazy", "eager"])
def test_decision_batch_matches_reference(pattern, strategy):
    eager, access_k = STRATEGIES[strategy]
    rng = np.random.default_rng(7)
    n, m = 4, 3
    state, version, sync, reads, _, arts, writes = (
        x[0] for x in _random_tick_inputs(rng, 1, n, m))
    acts = {"none": np.zeros(n, np.int32),
            "some": np.array([0, 1, 0, 1], np.int32),
            "all": np.ones(n, np.int32)}[pattern]
    opts = dict(artifact_tokens=64, eager=eager, access_k=access_k)
    j_out = jmt.mesi_decision_batch(
        *[jnp.asarray(x) for x in (state, version, sync, reads, acts, arts,
                                   writes)], interpret=True, **opts)
    t_out = tmt.mesi_decision_batch(
        *[torch.as_tensor(x) for x in (state, version, sync, reads, acts,
                                       arts, writes)], **opts)
    for j, t in zip(j_out, t_out):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
