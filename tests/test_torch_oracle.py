"""The port's differential oracle (``repro_torch.sim.oracle``) against
the JAX package's: the same sampled traces in both threefry modes, and
every port leg's ledgers, states and chunk arrays equal to the
reference's own replay of the trace (``replay_vectorized`` /
``replay_content_vectorized``, which never reach a Pallas kernel)."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import acs as racs  # noqa: E402
from repro.sim import oracle as ro  # noqa: E402
from repro.sim import workloads as rw  # noqa: E402
from repro_torch.sim import oracle as to  # noqa: E402
from repro_torch.sim import workloads as tw  # noqa: E402

pytestmark = pytest.mark.torch

STRATEGIES = {"lazy": racs.LAZY, "eager": racs.EAGER,
              "access_count": racs.ACCESS_COUNT}
SHAPE = dict(n_agents=5, n_artifacts=3, artifact_tokens=64, n_steps=5)


def _pair(family: str, strategy: str, chunk_tokens: int = 0):
    code = STRATEGIES[strategy]
    return (rw.make(family, chunk_tokens=chunk_tokens,
                    **SHAPE).with_strategy(code),
            tw.make(family, chunk_tokens=chunk_tokens,
                    **SHAPE).with_strategy(code))


def _traces(family, strategy, chunk_tokens=0, partitionable=True,
            run=1, locality=None):
    rwk, twk = _pair(family, strategy, chunk_tokens)
    with jax.threefry_partitionable(partitionable):
        ref = ro.sample_trace(rwk.acs, ro.episode_key(rwk.seed, run),
                              rwk.rates(), locality=locality)
    port = to.sample_trace(twk.acs, to.episode_key(twk.seed, run, "cpu"),
                           twk.rates("cpu"), locality=locality,
                           partitionable=partitionable)
    return rwk, twk, ref, port


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("family,chunk_tokens", [("zipf", 0),
                                                 ("rag", 16)])
def test_sample_trace_is_the_reference_trace(partitionable, family,
                                             chunk_tokens):
    *_, ref, port = _traces(family, "lazy", chunk_tokens, partitionable,
                            locality=0.4 if chunk_tokens else None)
    for field in ("acts", "arts", "writes", "write_chunks"):
        want, got = getattr(ref, field), getattr(port, field)
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _assert_token_legs(twk, port, want):
    led, st, ver, sync = want
    report = to.check_trace(twk.acs, port, device="cpu")
    assert dataclasses.asdict(report.ledger) == dataclasses.asdict(led)
    for got, exp in ((report.state, st), (report.version, ver),
                     (report.last_sync, sync)):
        np.testing.assert_array_equal(got, exp)
    for leg in (to.replay_vectorized, to.replay_kernel):
        got = leg(twk.acs, port, "cpu")
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(led)
        for g, e in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, e)
    return report


@pytest.mark.parametrize("family", ["bursty", "ping_pong"])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_token_legs_equal_the_reference(family, strategy):
    rwk, twk, ref, port = _traces(family, strategy)
    report = _assert_token_legs(twk, port,
                                ro.replay_vectorized(rwk.acs, ref))
    assert report.implementations[:3] == ("protocol", "vectorized",
                                          "kernel")
    assert ("model_check" in report.implementations) == (strategy == "lazy")


@pytest.mark.parametrize("family,strategy", [("bursty", "lazy"),
                                             ("ping_pong", "access_count")])
def test_content_legs_equal_the_reference(family, strategy):
    rwk, twk, ref, port = _traces(family, strategy, chunk_tokens=16,
                                  locality=0.5)
    want = ro.replay_content_vectorized(rwk.acs, ref)
    report = to.check_content_trace(twk.acs, port, device="cpu")
    kernel = to.replay_content_kernel(twk.acs, port, "cpu")
    for got in (report.ledger, kernel[0]):
        assert dataclasses.asdict(got) == dataclasses.asdict(want[0])
    for got, exp in zip((report.chunk_version, report.chunk_sync,
                         report.chunk_dirty), want[1:4]):
        np.testing.assert_array_equal(got, exp)
    for got, exp in zip(kernel[1:], want[1:4]):
        np.testing.assert_array_equal(got, exp)
    assert len(report.fills) == len(want[4])
    for f, g in zip(report.fills, want[4]):
        assert ((f.step, f.agent, f.artifact, f.delta_inc, f.full_inc)
                == (g.step, g.agent, g.artifact, g.delta_inc, g.full_inc))
        for field in ("fetched", "sync_before", "dirty"):
            np.testing.assert_array_equal(getattr(f, field),
                                          getattr(g, field))
    store_ledger, n_checks = to.replay_content_store(twk.acs, port,
                                                     report.fills)
    assert dataclasses.asdict(store_ledger) == dataclasses.asdict(want[0])
    assert n_checks == len(report.fills)
    # the token legs of a content trace agree too
    _assert_token_legs(twk, port, ro.replay_vectorized(rwk.acs, ref))


def test_sharded_trace_decomposes():
    _, twk, ref, port = _traces("hierarchical", "lazy")
    shards = np.array([0, 1, 0])
    report = to.check_sharded_trace(twk.acs, port, shards, device="cpu")
    assert report.ledger.n_reads + report.ledger.n_writes == port.n_actions
    sub, cols = to.shard_subtrace(port, shards, 1)
    rsub, rcols = ro.shard_subtrace(ref, shards, 1)
    np.testing.assert_array_equal(cols, rcols)
    for field in ("acts", "arts", "writes"):
        np.testing.assert_array_equal(getattr(sub, field),
                                      getattr(rsub, field))


def test_differential_checks_close_the_loop():
    _, twk = _pair("zipf", "lazy")
    report = to.differential_check(twk, run=2, device="cpu")
    assert report.implementations[-1] == "run_episode"
    _, twk = _pair("rag", "lazy", chunk_tokens=16)
    report = to.content_differential_check(twk, run=2, device="cpu")
    assert report.implementations == ("vectorized", "kernel", "chunk_store",
                                      "protocol_baseline", "run_episode")


def test_a_corrupted_leg_goes_red(monkeypatch):
    _, twk, _, port = _traces("bursty", "lazy")
    real = to.replay_kernel

    def off_by_one(cfg, trace, device=None):
        led, *rest = real(cfg, trace, device)
        return (dataclasses.replace(led, fetch_tokens=led.fetch_tokens + 1),
                *rest)
    monkeypatch.setattr(to, "replay_kernel", off_by_one)
    with pytest.raises(to.ConformanceError, match="fetch_tokens"):
        to.check_trace(twk.acs, port, device="cpu")


def test_scope_guards():
    _, twk, _, port = _traces("bursty", "lazy")
    with pytest.raises(ValueError):
        to.check_trace(dataclasses.replace(twk.acs, max_stale_steps=2),
                       port, device="cpu")
    with pytest.raises(ValueError):
        to.check_content_trace(twk.acs, port, device="cpu")
