"""End to end: the port's sweep engine against the JAX engine.

The port draws its own actions from its threefry stream
(``repro_torch.core.prng``) on the reference's key schedule, so every
per-run ledger and every ``RunStats`` field must equal ``repro.sim``'s
scan route, in both ``jax_threefry_partitionable`` modes (the reference
runs inside ``jax.threefry_partitionable(mode)``, never with the flag
set for the whole process) and on both of the port's routes (``kernel``
runs the kernels' plain versions on CPU tensors and reports the ``-1``
staleness sentinel).  In legacy mode (``partitionable=False``) the
port also reproduces the committed ``tests/golden/*.json`` ledgers.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.sim as jsim  # noqa: E402
from repro.core import acs as jacs  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.core import acs as tacs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.sim import engine as tengine  # noqa: E402

pytestmark = pytest.mark.torch

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
SMALL = dict(n_steps=8, artifact_tokens=64)
RUNS = 4
STALENESS = ("max_staleness_max", "max_version_lag_max",
             "max_consumed_staleness_max")
MODES = pytest.mark.parametrize("partitionable", [True, False],
                                ids=["partitionable", "legacy"])
ROUTES = pytest.mark.parametrize("route", ["kernel", "scan"])
#: the golden zoo grid of ``tests/test_golden_traces.py``
ZOO_PARAMS = dict(n_agents=6, n_artifacts=4, n_runs=5,
                  artifact_tokens=1024, n_steps=30)
#: the content mini-grid of ``tests/test_content_plane.py``
CONTENT_SMALL = dict(n_agents=4, n_artifacts=3, n_runs=2,
                     artifact_tokens=96, n_steps=8, chunk_tokens=16)


def _assert_same_stats(j, t, route):
    """Every ``RunStats`` field equal; the kernel route reports the -1
    sentinel for the staleness diagnostics it does not track."""
    js, ts = dataclasses.asdict(j), dataclasses.asdict(t)
    if route == "kernel":
        for field in STALENESS:
            assert ts.pop(field) == -1
            js.pop(field)
    assert js == ts


def _assert_same_result(j, t, route):
    np.testing.assert_array_equal(j.per_run_total_tokens,
                                  t.per_run_total_tokens)
    np.testing.assert_array_equal(j.per_run_chr, t.per_run_chr)
    _assert_same_stats(j.stats, t.stats, route)


def _assert_same_comparison(j, t, route):
    _assert_same_stats(j.broadcast, t.broadcast, "scan")
    _assert_same_stats(j.coherent, t.coherent, route)
    for field in ("savings_mean", "savings_std", "crr", "chr_mean",
                  "chr_std", "volatility", "strategy", "scenario"):
        assert getattr(j, field) == getattr(t, field), field


def _pair(key, **overrides):
    jscn = dataclasses.replace(jsim.SCENARIOS[key], n_runs=RUNS)
    tscn = dataclasses.replace(tsim.SCENARIOS[key], n_runs=RUNS)
    return (jscn.with_overrides(**SMALL, **overrides),
            tscn.with_overrides(**SMALL, **overrides))


@MODES
@ROUTES
@pytest.mark.parametrize("key", ["A", "B", "C", "D"])
def test_scenarios_equal_reference(key, route, partitionable):
    jscn, tscn = _pair(key)
    with jax.threefry_partitionable(partitionable):
        expected = jsim.run_scenario(jscn, tick_backend="scan")
    got = tsim.run_scenario(tscn, tick_backend=route, device="cpu",
                            partitionable=partitionable)
    _assert_same_result(expected, got, route)


@MODES
@ROUTES
@pytest.mark.parametrize("strategy", [jacs.EAGER, jacs.ACCESS_COUNT],
                         ids=["eager", "access_count"])
def test_strategies_equal_reference(strategy, route, partitionable):
    jscn, tscn = _pair("C", strategy=strategy, access_k=2)
    with jax.threefry_partitionable(partitionable):
        expected = jsim.run_scenario(jscn, tick_backend="scan")
    got = tsim.run_scenario(tscn, tick_backend=route, device="cpu",
                            partitionable=partitionable)
    _assert_same_result(expected, got, route)


def _content_workloads():
    kw = dict(n_agents=4, n_artifacts=3, n_runs=RUNS, chunk_tokens=16,
              n_steps=8, artifact_tokens=60)
    return (jsim.make("bursty", **kw), tsim.make("bursty", **kw))


@MODES
@ROUTES
def test_content_workload_equals_reference(route, partitionable):
    jw, tw = _content_workloads()
    with jax.threefry_partitionable(partitionable):
        expected = jsim.run_workload(jw, tick_backend="scan")
    got = tsim.run_workload(tw, tick_backend=route, device="cpu",
                            partitionable=partitionable)
    assert got.stats.delta_bytes_mean <= got.stats.full_bytes_mean
    _assert_same_result(expected, got, route)


def test_content_broadcast_baseline_equals_reference():
    """Every statistic of the broadcast baseline equals the reference's
    (its byte columns are the analytic fill)."""
    jw, tw = _content_workloads()
    j = jsim.compare_workloads([jw])[0].broadcast
    t = tsim.compare_workloads([tw], device="cpu")[0].broadcast
    _assert_same_stats(j, t, "scan")


def test_routes_agree_on_the_port_generator():
    scn = tsim.SCENARIOS["D"].with_overrides(**SMALL)
    ws = tsim.zoo(n_agents=4, n_artifacts=3, n_runs=RUNS, chunk_tokens=16,
                  **SMALL)
    for route_results in zip(*(
            [tsim.run_scenario(scn, tick_backend=r, device="cpu")]
            + [tsim.run_workload(w, tick_backend=r, device="cpu")
               for w in ws] for r in ("kernel", "scan"))):
        kern, scan = route_results
        _assert_same_result(scan, kern, "kernel")


def test_savings_match_reference_statistically():
    """Scenario B at 512 runs on each side's own draws: the threefry
    stream makes the savings equal, not just close."""
    runs = 512
    j = jsim.compare(dataclasses.replace(jsim.SCENARIOS["B"], n_runs=runs))
    t = tsim.compare(dataclasses.replace(tsim.SCENARIOS["B"], n_runs=runs),
                     device="cpu")
    assert (j.savings_mean, j.savings_std, j.chr_mean) == (
        t.savings_mean, t.savings_std, t.chr_mean)
    assert j.broadcast.total_tokens_mean == t.broadcast.total_tokens_mean


@MODES
@ROUTES
def test_zoo_grid_equals_reference(route, partitionable):
    """The golden zoo grid, every family, both variants, one batch."""
    with jax.threefry_partitionable(partitionable):
        expected = jsim.compare_workloads(jsim.zoo(**ZOO_PARAMS))
    got = tsim.compare_workloads(tsim.zoo(**ZOO_PARAMS), tick_backend=route,
                                 device="cpu", partitionable=partitionable)
    for j, t in zip(expected, got):
        _assert_same_comparison(j, t, route)


@MODES
@ROUTES
@pytest.mark.parametrize("family", ["bursty", "ping_pong"])
@pytest.mark.parametrize("chunk_tokens", [16, 40])
def test_content_mini_grid_equals_reference(family, chunk_tokens, route,
                                            partitionable):
    kw = {**CONTENT_SMALL, "chunk_tokens": chunk_tokens}
    with jax.threefry_partitionable(partitionable):
        expected = jsim.run_workload(jsim.make(family, **kw),
                                     tick_backend="scan")
    got = tsim.run_workload(tsim.make(family, **kw), tick_backend=route,
                            device="cpu", partitionable=partitionable)
    _assert_same_result(expected, got, route)


def _golden(name):
    return json.loads((GOLDEN / f"{name}.json").read_text())


def _roundtrip(payload):
    return json.loads(json.dumps(payload, sort_keys=True, default=float))


def test_scenario_goldens_in_legacy_mode():
    cmps = tsim.compare_grid(list(tsim.SCENARIOS.values()), device="cpu",
                             partitionable=False)
    payload = {key: {
        "scenario": c.scenario, "volatility": c.volatility,
        "broadcast_total_mean": c.broadcast.total_tokens_mean,
        "coherent_total_mean": c.coherent.total_tokens_mean,
        "savings_mean": c.savings_mean, "savings_std": c.savings_std,
        "crr": c.crr, "cache_hit_rate_mean": c.chr_mean}
        for key, c in zip(tsim.SCENARIOS, cmps)}
    assert _roundtrip(payload) == _golden("scenarios")


@ROUTES
def test_zoo_goldens_in_legacy_mode(route):
    golden = _golden("workloads")
    assert golden["_grid"] == ZOO_PARAMS
    for w in tsim.zoo(**ZOO_PARAMS):
        bc = tsim.run_workload(w.with_strategy(tacs.BROADCAST),
                               device="cpu", partitionable=False)
        co = tsim.run_workload(w, tick_backend=route, device="cpu",
                               partitionable=False)
        savings = 1.0 - co.per_run_total_tokens / bc.stats.total_tokens_mean
        row = {
            "name": w.name,
            "effective_volatility": w.effective_volatility(),
            "broadcast_per_run": [int(x) for x in bc.per_run_total_tokens],
            "coherent_per_run": [int(x) for x in co.per_run_total_tokens],
            "broadcast_total_mean": bc.stats.total_tokens_mean,
            "coherent_total_mean": co.stats.total_tokens_mean,
            "savings_mean": float(savings.mean()),
            "cache_hit_rate_mean": co.stats.cache_hit_rate_mean,
        }
        assert _roundtrip(row) == golden[w.family], w.family


def test_content_goldens_in_legacy_mode():
    """Run 0 of each content cell through the port's ``run_episode``
    (the engine's key schedule): the byte ledgers and fill count of
    ``tests/golden/content.json``."""
    golden = _golden("content")
    for family in ("bursty", "ping_pong"):
        for ct in (16, 40):
            w = tsim.make(family, **{**CONTENT_SMALL, "chunk_tokens": ct})
            keys = tacs.run_keys(prng.prng_key(w.seed), [0])
            met = tacs.run_episode(w.acs, keys, rates=w.rates("cpu"),
                                   locality=w.write_locality,
                                   partitionable=False)
            assert golden[f"{family}/ct{ct}"] == {
                "delta_bytes": int(met.delta_bytes[0]),
                "full_bytes": int(met.full_bytes[0]),
                "n_chunks_fetched": int(met.n_chunks_fetched[0]),
                "n_fills": int(met.n_fetches[0])}


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_run_draws_do_not_depend_on_the_grid(route):
    """Run r of a cell is the same episode whatever the run count and
    whatever cells share its batch."""
    scn = tsim.SCENARIOS["C"].with_overrides(**SMALL)
    few = tsim.run_scenario(dataclasses.replace(scn, n_runs=3),
                            tick_backend=route, device="cpu")
    many = tsim.run_scenario(dataclasses.replace(scn, n_runs=9),
                             tick_backend=route, device="cpu")
    np.testing.assert_array_equal(few.per_run_total_tokens,
                                  many.per_run_total_tokens[:3])
    grid = tsim.compare_grid(
        [dataclasses.replace(scn, n_runs=3),
         dataclasses.replace(tsim.SCENARIOS["A"].with_overrides(**SMALL),
                             n_runs=3)], tick_backend=route, device="cpu")
    assert grid[0].coherent.total_tokens_mean == few.stats.total_tokens_mean


def test_sweep_matches_reference_cells():
    vols = (0.05, 0.5)
    jc = jsim.sweep_cells(jsim.SCENARIOS["A"], vols, n_runs=3)
    tc = tsim.sweep_cells(tsim.SCENARIOS["A"], vols, n_runs=3)
    assert [(c.seed, c.acs.volatility, c.n_runs) for c in jc] == [
        (c.seed, c.acs.volatility, c.n_runs) for c in tc]
    out = tsim.sweep_volatility(tsim.SCENARIOS["A"].with_overrides(**SMALL),
                                vols, n_runs=3, device="cpu")
    assert [c.volatility for c in out] == list(vols)
    assert all(c.coherent.total_tokens_mean < c.broadcast.total_tokens_mean
               for c in out)


@pytest.mark.parametrize("strategy,k,requested,env,expected", [
    (tacs.LAZY, 0, None, None, "kernel"),
    (tacs.EAGER, 0, None, None, "kernel"),
    (tacs.ACCESS_COUNT, 0, None, None, "kernel"),
    (tacs.LAZY, 0, None, "scan", "scan"),
    (tacs.LAZY, 0, "kernel", "scan", "kernel"),
    (tacs.LAZY, 2, None, None, "scan"),
    (tacs.TTL, 0, "kernel", None, "scan"),
    (tacs.BROADCAST, 0, None, "kernel", "scan"),
])
def test_resolve_tick_backend(monkeypatch, strategy, k, requested, env,
                              expected):
    if env is None:
        monkeypatch.delenv("REPRO_SIM_TICK", raising=False)
    else:
        monkeypatch.setenv("REPRO_SIM_TICK", env)
    cfg = tacs.ACSConfig(n_agents=2, n_artifacts=2, artifact_tokens=8,
                         n_steps=2, strategy=strategy, max_stale_steps=k)
    assert tengine.resolve_tick_backend(cfg, requested) == expected


def test_resolve_tick_backend_rejects_unknown(monkeypatch):
    monkeypatch.setenv("REPRO_SIM_TICK", "pallas")
    cfg = tacs.ACSConfig(n_agents=2, n_artifacts=2, artifact_tokens=8,
                         n_steps=2)
    with pytest.raises(ValueError, match="auto\\|kernel\\|scan"):
        tengine.resolve_tick_backend(cfg)
