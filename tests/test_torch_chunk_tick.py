"""The port's chunk-diff tick (plain route, CPU tensors) against the JAX
reference's numpy oracle and its Pallas kernel in interpret mode, fed
the ``miss`` output of a real MESI tick."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import chunk_diff as jcd  # noqa: E402
from repro_torch.kernels import chunk_diff as tcd  # noqa: E402
from repro_torch.kernels import mesi_transition as tmt  # noqa: E402

pytestmark = pytest.mark.torch


def _inputs(rng, B, n, m, C, locality):
    """A MESI tick on random valid directories gives ``miss``; chunk
    vectors lag the authority by 0 or 1; write spans are circular runs
    of ``round(locality * C)`` chunks."""
    state = rng.integers(0, 2, (B, n, m)).astype(np.int32)
    version = rng.integers(1, 5, (B, m)).astype(np.int32)
    sync = np.where(state > 0, version[:, None, :], 0).astype(np.int32)
    reads = np.zeros((B, n, m), np.int32)
    acts = rng.integers(0, 2, (B, n)).astype(np.int32)
    arts = rng.integers(0, m, (B, n)).astype(np.int32)
    writes = rng.integers(0, 2, (B, n)).astype(np.int32)
    miss = tmt.mesi_tick(*[torch.as_tensor(x) for x in (
        state, version, sync, reads, acts, arts, writes)],
        artifact_tokens=60)[5].numpy()
    cv = rng.integers(1, 4, (B, m, C)).astype(np.int32)
    cs = np.clip(cv[:, None] - rng.integers(0, 2, (B, n, m, C)), 0,
                 None).astype(np.int32)
    dirty = (cv > 1).astype(np.int32)
    span = max(1, int(round(locality * C)))
    start = rng.integers(0, C, (B, n))
    wmask = (((np.arange(C) - start[..., None]) % C) < span).astype(np.int32)
    return cv, cs, dirty, miss, acts * writes, arts, wmask


@pytest.mark.parametrize("locality", [1.0, 0.25])
@pytest.mark.parametrize("B,n,m", [(6, 4, 3), (5, 1, 2), (4, 3, 1)])
def test_matches_oracle_and_pallas(B, n, m, locality):
    # 60 tokens in 16-token chunks: a ragged 12-token last chunk
    C, opts = 4, dict(artifact_tokens=60, chunk_tokens=16)
    rng = np.random.default_rng(B * 10 + n + int(locality * 4))
    inputs = _inputs(rng, B, n, m, C, locality)
    assert inputs[3].any(), "the MESI tick filled somewhere"
    t_in = [torch.as_tensor(x) for x in inputs]
    out = tcd.chunk_tick(*t_in, **opts)
    for x, t in zip(inputs, t_in):   # functional
        np.testing.assert_array_equal(x, t.numpy())
    for exp in (jcd.chunk_tick_ref(*inputs, **opts),
                jcd.chunk_tick_pallas(*[jnp.asarray(x) for x in inputs],
                                      block_sims=4, interpret=True,
                                      **opts)):
        assert len(exp) == len(out) == 5
        for j, t in zip(exp, out):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
            assert t.dtype == torch.int32
    assert int(out[4][:, 0].sum()) <= int(out[4][:, 1].sum())


def _chain_inputs(chain, B=4, n=4, m=3, C=8):
    """Inputs whose agents chain on one artifact's row, the orders the
    kernel's staged rows must keep: every agent on artifact 0, random
    fills and writes (``one_artifact``); every agent filling and writing
    artifact 0 (``fill_and_write``: each fetches against the versions
    before its own bump); agents 0 and 1 writing overlapping spans of
    artifact 1, then agent 2 filling it (``writers_then_filler``: its
    fetch sees both bumps)."""
    rng = np.random.default_rng(len(chain))
    cv = rng.integers(1, 4, (B, m, C)).astype(np.int32)
    cs = np.clip(cv[:, None] - rng.integers(0, 2, (B, n, m, C)), 0,
                 None).astype(np.int32)
    dirty = (cv > 1).astype(np.int32)
    miss = rng.integers(0, 2, (B, n)).astype(np.int32)
    wact = rng.integers(0, 2, (B, n)).astype(np.int32)
    arts = np.zeros((B, n), np.int32)
    wmask = (rng.random((B, n, C)) < 0.5).astype(np.int32)
    if chain == "fill_and_write":
        miss[:], wact[:] = 1, 1
    elif chain == "writers_then_filler":
        arts[:, :3] = 1
        miss[:, :2], wact[:, :2] = 0, 1
        miss[:, 2], wact[:, 2] = 1, 0
        cs[:, 2, 1] = cv[:, 1]              # the filler up to date before
        wmask[:, 0], wmask[:, 1] = 0, 0
        wmask[:, 0, :5], wmask[:, 1, 3:] = 1, 1   # overlap at 3, 4
    return cv, cs, dirty, miss, wact, arts, wmask


@pytest.mark.parametrize("chain", ["one_artifact", "fill_and_write",
                                   "writers_then_filler"])
def test_chains_on_one_artifact_match_oracle_and_pallas(chain):
    # 120 tokens in 16-token chunks: a ragged 8-token last chunk
    opts = dict(artifact_tokens=120, chunk_tokens=16)
    inputs = _chain_inputs(chain)
    out = tcd.chunk_tick(*[torch.as_tensor(x) for x in inputs], **opts)
    for exp in (jcd.chunk_tick_ref(*inputs, **opts),
                jcd.chunk_tick_pallas(*[jnp.asarray(x) for x in inputs],
                                      block_sims=2, interpret=True,
                                      **opts)):
        for j, t in zip(exp, out):
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
    fetched = out[3].numpy()
    if chain == "fill_and_write":
        # each later agent fetches every chunk the one before it bumped
        assert (fetched[:, 1:] >= inputs[6][:, :-1]).all()
    elif chain == "writers_then_filler":
        # both bumps, and only they: the overlap bumped twice
        np.testing.assert_array_equal(fetched[:, 2], np.ones((4, 8)))
        np.testing.assert_array_equal(out[0].numpy()[:, 1] - inputs[0][:, 1],
                                      [[1, 1, 1, 2, 2, 1, 1, 1]] * 4)


def test_in_place_tick_touches_only_addressed_rows():
    rng = np.random.default_rng(3)
    inputs = [torch.as_tensor(x) for x in _inputs(rng, 5, 3, 4, 4, 0.5)]
    expected = tcd.chunk_tick(*inputs, artifact_tokens=60, chunk_tokens=16)
    state = [t.clone() for t in inputs[:3]]
    fetched, counters = tcd.chunk_tick_(*state, *inputs[3:],
                                        artifact_tokens=60, chunk_tokens=16)
    for exp, got in zip(expected, state + [fetched, counters]):
        assert torch.equal(exp, got)
    # chunk_sync moves only at (s, a, arts[s, a]) of agents that fill or
    # write
    moved = (state[1] != inputs[1]).any(-1)                  # (B, n, m)
    miss, wact, arts = (x.numpy() for x in inputs[3:6])
    for s, a, d in zip(*np.nonzero(moved.numpy())):
        assert d == arts[s, a] and (miss[s, a] or wact[s, a])
    assert tcd.chunk_tick_.launches == 0   # the CPU route launches nothing


@pytest.mark.parametrize("bad,match", [
    ("dtype", "int32"), ("shape", "shape"), ("arts", r"\[0, 4\)")])
def test_wrapper_rejects_malformed_inputs(bad, match):
    rng = np.random.default_rng(4)
    inputs = [torch.as_tensor(x) for x in _inputs(rng, 3, 2, 4, 4, 0.5)]
    if bad == "dtype":
        inputs[6] = inputs[6].bool()
    elif bad == "shape":
        inputs[0] = inputs[0][:, :, :2]
    else:
        inputs[5] = inputs[5] - 1
    with pytest.raises((TypeError, ValueError), match=match):
        tcd.chunk_tick(*inputs, artifact_tokens=60, chunk_tokens=16)


@pytest.mark.parametrize("env,default,expected", [
    (None, "scan", "scan"), (None, "kernel", "kernel"),
    ("auto", "kernel", "kernel"), ("scan", "kernel", "scan"),
    ("kernel", "scan", "kernel"), ("pallas", "scan", ValueError)])
def test_resolve_chunk_route(monkeypatch, env, default, expected):
    if env is None:
        monkeypatch.delenv("REPRO_CHUNK_DIFF", raising=False)
    else:
        monkeypatch.setenv("REPRO_CHUNK_DIFF", env)
    if expected is ValueError:
        with pytest.raises(ValueError, match="REPRO_CHUNK_DIFF"):
            tcd.resolve_chunk_route(default)
    else:
        assert tcd.resolve_chunk_route(default) == expected
