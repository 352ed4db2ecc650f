"""End to end: the port's sweep engine against the JAX engine.

Each episode's action tensors are drawn by the reference's own samplers
on the keys its engine uses (``episode_step_keys(run_keys(PRNGKey(seed),
arange(R)), S)``, with the write-span fold inside
``draw_write_chunks``) and handed to the port through ``actions=``; the
per-run ledgers and every ``RunStats`` field must then equal
``repro.sim``'s scan route, on both of the port's routes (``kernel``
runs the kernels' plain versions on CPU tensors and reports the ``-1``
staleness sentinel).  The port's own generator is held to the reference
statistically.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.sim as jsim  # noqa: E402
from repro.core import acs as jacs  # noqa: E402
from repro.kernels.mesi_transition import episode_step_keys  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.core import acs as tacs  # noqa: E402
from repro_torch.sim import engine as tengine  # noqa: E402

pytestmark = pytest.mark.torch

SMALL = dict(n_steps=8, artifact_tokens=64)
RUNS = 4
STALENESS = ("max_staleness_max", "max_version_lag_max",
             "max_consumed_staleness_max")


def _reference_actions(cfg, seed, n_runs, volatility, p_act, rates=None,
                       locality=None):
    """The (S, R, n[, C]) action tensors the JAX engine draws."""
    n, m = cfg.n_agents, cfg.n_artifacts
    content = jacs.content_enabled(cfg)
    C = jacs.content_chunks(cfg) if content else 0
    keys = episode_step_keys(
        jacs.run_keys(jax.random.PRNGKey(seed),
                      jnp.arange(n_runs, dtype=jnp.int32)), cfg.n_steps)

    def one(k):
        a, d, w = jacs.draw_actions(k, n, m, volatility, p_act, rates)
        wc = (jacs.draw_write_chunks(k, n, C, jnp.float32(locality))
              if content else None)
        return a, d, w, wc

    draws = jax.jit(jax.vmap(jax.vmap(one)))(keys)
    return tuple(None if x is None else np.array(x) for x in draws)


def _scenario_actions(scn):
    return _reference_actions(scn.acs, scn.seed, scn.n_runs,
                              jnp.float32(scn.acs.volatility),
                              jnp.float32(scn.acs.p_act),
                              locality=scn.acs.write_locality)


def _assert_same_result(j, t, route):
    np.testing.assert_array_equal(j.per_run_total_tokens,
                                  t.per_run_total_tokens)
    np.testing.assert_array_equal(j.per_run_chr, t.per_run_chr)
    js, ts = dataclasses.asdict(j.stats), dataclasses.asdict(t.stats)
    if route == "kernel":
        for field in STALENESS:
            assert ts.pop(field) == -1
            js.pop(field)
    assert js == ts


def _pair(key, **overrides):
    jscn = dataclasses.replace(jsim.SCENARIOS[key], n_runs=RUNS)
    tscn = dataclasses.replace(tsim.SCENARIOS[key], n_runs=RUNS)
    return (jscn.with_overrides(**SMALL, **overrides),
            tscn.with_overrides(**SMALL, **overrides))


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("key", ["A", "B", "C", "D"])
def test_scenarios_equal_reference(key, route):
    jscn, tscn = _pair(key)
    expected = jsim.run_scenario(jscn, tick_backend="scan")
    got = tsim.run_scenario(tscn, tick_backend=route, device="cpu",
                            actions=_scenario_actions(jscn))
    _assert_same_result(expected, got, route)


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("strategy", [jacs.EAGER, jacs.ACCESS_COUNT],
                         ids=["eager", "access_count"])
def test_strategies_equal_reference(strategy, route):
    jscn, tscn = _pair("C", strategy=strategy, access_k=2)
    expected = jsim.run_scenario(jscn, tick_backend="scan")
    got = tsim.run_scenario(tscn, tick_backend=route, device="cpu",
                            actions=_scenario_actions(jscn))
    _assert_same_result(expected, got, route)


def _content_workloads():
    kw = dict(n_agents=4, n_artifacts=3, n_runs=RUNS, chunk_tokens=16,
              n_steps=8, artifact_tokens=60)
    return (jsim.make("bursty", **kw), tsim.make("bursty", **kw))


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_content_workload_equals_reference(route):
    jw, tw = _content_workloads()
    actions = _reference_actions(jw.acs, jw.seed, jw.n_runs, None, None,
                                 rates=jw.rates(),
                                 locality=jw.write_locality)
    expected = jsim.run_workload(jw, tick_backend="scan")
    got = tsim.run_workload(tw, tick_backend=route, device="cpu",
                            actions=actions)
    assert got.stats.delta_bytes_mean <= got.stats.full_bytes_mean
    _assert_same_result(expected, got, route)


def test_content_broadcast_baseline_equals_reference():
    """The broadcast baseline has no random term in its token and byte
    ledgers (the analytic byte fill), so it matches exactly even on the
    port's own draws."""
    jw, tw = _content_workloads()
    j = jsim.compare_workloads([jw])[0].broadcast
    t = tsim.compare_workloads([tw], device="cpu")[0].broadcast
    for field in ("total_tokens_mean", "total_tokens_std",
                  "broadcast_tokens_mean", "delta_bytes_mean",
                  "full_bytes_mean", "n_chunks_fetched_mean",
                  "cache_hit_rate_mean"):
        assert getattr(j, field) == getattr(t, field), field


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
    """Scenario B at 512 runs on each side's own random numbers: the
    savings means agree within 4 standard errors of their difference."""
    runs = 512
    j = jsim.compare(dataclasses.replace(jsim.SCENARIOS["B"], n_runs=runs))
    t = tsim.compare(dataclasses.replace(tsim.SCENARIOS["B"], n_runs=runs),
                     device="cpu")
    se = np.hypot(j.savings_std, t.savings_std) / np.sqrt(runs)
    assert abs(j.savings_mean - t.savings_mean) <= 4 * se
    assert j.broadcast.total_tokens_mean == t.broadcast.total_tokens_mean


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
