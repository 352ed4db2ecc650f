"""The port's batched ACS state machine against the JAX reference.

Both packages take the same action tensors (drawn by the reference's own
samplers on its own keys) and must agree integer for integer: every
``ACSArrays`` leaf, every ``ACSMetrics`` field and the
``DecisionOutcome`` after every tick, for all five strategies, with and
without K-staleness enforcement and the content plane, and on the
heterogeneous rate-matrix path.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import acs as jacs  # noqa: E402
from repro.sim.workloads import random_workload as j_random_workload  # noqa: E402
from repro_torch.core import acs as tacs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.sim.workloads import random_workload as t_random_workload  # noqa: E402

pytestmark = pytest.mark.torch

B, S = 5, 6


def _cfg(strategy, max_stale_steps=0, chunk_tokens=0, **kw):
    # 60 tokens in 16-token chunks: C = 4 with a ragged 12-token last chunk
    return jacs.ACSConfig(n_agents=4, n_artifacts=3, artifact_tokens=60,
                          n_steps=S, strategy=strategy,
                          max_stale_steps=max_stale_steps,
                          chunk_tokens=chunk_tokens, access_k=2,
                          write_locality=0.5, **kw)


def _port_cfg(cfg):
    return tacs.ACSConfig(**{f: getattr(cfg, f)
                             for f in cfg.__dataclass_fields__})


def _assert_equal(j_tree, t_tree):
    for field, j, t in zip(j_tree._fields, j_tree, t_tree):
        if j is None:
            assert t is None, field
            continue
        np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                      err_msg=field)
        assert t.dtype == (torch.bool if np.asarray(j).dtype == bool
                           else torch.int32), field


def _episode_both(cfg, rates_j=None, rates_t=None, seed=0, outcome=True):
    """Tick both packages through S steps on the reference's draws,
    asserting equality after every tick; with ``outcome``, at every step
    also compare one ``apply_actions`` pass on the pre-tick state and
    its DecisionOutcome (a second compilation of the reference's agent
    loop, so the cases below spend it where the pass differs)."""
    pcfg = _port_cfg(cfg)
    n, m = cfg.n_agents, cfg.n_artifacts
    content = jacs.content_enabled(cfg)
    C = jacs.content_chunks(cfg) if content else 0
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    step_keys = jax.vmap(lambda k: jax.random.split(k, S))(keys)

    def j_step(ar, me, k, s):
        # the draws jacs.tick makes from k, the tick itself, and one
        # apply_actions pass on the same draws
        a, d, w = jacs.draw_actions(k, n, m, cfg.volatility, cfg.p_act,
                                    rates_j)
        wc = (jacs.draw_write_chunks(k, n, C, cfg.write_locality)
              if content else None)
        out = (jacs.apply_actions(cfg, ar, me, a, d, w, wc) if outcome
               else None)
        return ((a, d, w, wc), jacs.tick(cfg, ar, me, k, s, rates=rates_j),
                out)

    j_step = jax.jit(jax.vmap(j_step, in_axes=(0, 0, 0, None)))
    j_arrays = jax.vmap(lambda _: jacs.init_arrays(cfg))(jnp.arange(B))
    j_met = jax.vmap(lambda _: jacs.init_metrics())(jnp.arange(B))
    t_arrays = tacs.init_arrays(pcfg, B, device="cpu")
    t_met = tacs.init_metrics(B, device="cpu")
    _assert_equal(j_arrays, t_arrays)

    for s in range(S):
        draws, (j_arrays, j_met), j_out = j_step(
            j_arrays, j_met, step_keys[:, s], jnp.int32(s))
        actions = tuple(None if x is None
                        else torch.as_tensor(np.array(x)) for x in draws)
        if outcome:
            t_out = tacs.apply_actions(pcfg, t_arrays, t_met, *actions)
            for j, t in zip(j_out, t_out):
                _assert_equal(j, t)
        old, before = t_arrays, tacs.arrays_to_numpy(t_arrays)
        t_arrays, t_met = tacs.tick(pcfg, t_arrays, t_met, None, s,
                                    rates=rates_t, actions=actions)
        # functional: the input arrays are left as they were
        for x, y in zip(before, tacs.arrays_to_numpy(old)):
            assert (x is None and y is None) or np.array_equal(x, y)
        _assert_equal(j_arrays, t_arrays)
        _assert_equal(j_met, t_met)


STRATEGIES = [jacs.BROADCAST, jacs.EAGER, jacs.LAZY, jacs.TTL,
              jacs.ACCESS_COUNT]


@pytest.mark.parametrize("strategy", STRATEGIES,
                         ids=[jacs.STRATEGY_NAMES[s] for s in STRATEGIES])
def test_tick_matches_reference(strategy):
    _episode_both(_cfg(strategy), seed=strategy)


@pytest.mark.parametrize("strategy", [jacs.LAZY, jacs.TTL,
                                      jacs.ACCESS_COUNT],
                         ids=["lazy", "ttl", "access_count"])
def test_k_staleness_matches_reference(strategy):
    _episode_both(_cfg(strategy, max_stale_steps=1), seed=10 + strategy,
                  outcome=strategy != jacs.TTL)


@pytest.mark.parametrize("strategy", [jacs.LAZY, jacs.ACCESS_COUNT],
                         ids=["lazy", "access_count"])
def test_content_plane_matches_reference(strategy):
    _episode_both(_cfg(strategy, chunk_tokens=16), seed=20 + strategy)


@pytest.mark.parametrize("strategy,chunk_tokens",
                         [(jacs.LAZY, 16), (jacs.TTL, 0), (jacs.EAGER, 0)],
                         ids=["lazy-content", "ttl", "eager"])
def test_rate_matrices_match_reference(strategy, chunk_tokens):
    kw = dict(strategy=strategy, chunk_tokens=chunk_tokens,
              artifact_tokens=60, n_steps=S, access_k=2)
    jw = j_random_workload(7 + strategy, **kw)
    tw = t_random_workload(7 + strategy, **kw)
    cfg = dataclasses.replace(jw.acs, write_locality=jw.write_locality)
    _episode_both(cfg, rates_j=jw.rates(), rates_t=tw.rates(device="cpu"),
                  seed=30 + strategy, outcome=chunk_tokens > 0)


@pytest.mark.parametrize("strategy", [jacs.TTL, jacs.LAZY],
                         ids=["ttl", "lazy"])
def test_uniform_rates_match_reference(strategy):
    """The scalar scenario through the rate-matrix path: the TTL epoch
    then sums ``p_act`` in float32 on both sides."""
    cfg = _cfg(strategy, p_act=0.7)
    rates_t = tacs.uniform_rates(_port_cfg(cfg), device="cpu")
    rates_j = jacs.uniform_rates(cfg)
    for j, t in zip(rates_j, rates_t):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    _episode_both(cfg, rates_j=rates_j, rates_t=rates_t, seed=40 + strategy,
                  outcome=False)


def test_init_and_numpy_round_trip():
    cfg = _cfg(jacs.LAZY, chunk_tokens=16)
    j_arrays = jax.vmap(lambda _: jacs.init_arrays(cfg))(jnp.arange(B))
    host = [None if x is None else np.asarray(x) for x in j_arrays]
    t_arrays = tacs.arrays_from_numpy(host, device="cpu")
    _assert_equal(j_arrays, t_arrays)
    t_arrays.state.fill_(1)      # a copy: the host arrays stay as they were
    np.testing.assert_array_equal(host[0], np.asarray(j_arrays.state))
    t_arrays = tacs.arrays_from_numpy(host, device="cpu")
    back = tacs.arrays_to_numpy(t_arrays)
    for x, y in zip(host, back):
        np.testing.assert_array_equal(x, y)
        assert y.dtype == np.int32
    plain = tacs.arrays_from_numpy(
        tacs.arrays_to_numpy(tacs.init_arrays(_port_cfg(
            _cfg(jacs.LAZY)), B, device="cpu")), device="cpu")
    assert plain.chunk_sync is None and plain.state.dtype == torch.int32


def test_content_plane_rejects_push_strategies():
    with pytest.raises(ValueError, match="content plane"):
        tacs.init_arrays(_port_cfg(_cfg(jacs.EAGER, chunk_tokens=16)), 2,
                         device="cpu")


@functools.lru_cache(maxsize=None)
def _locality_spans(locality, C):
    k = jax.random.PRNGKey(3)
    return np.asarray(jacs.draw_write_chunks(k, 64, C, locality))


@pytest.mark.parametrize("locality", [0.05, 0.25, 0.5, 1.0])
def test_write_span_length_matches_reference(locality):
    """Span lengths follow the reference's rounding (half to even, in
    float32), and on the same key the spans themselves are the
    reference's (the process's default threefry mode on both sides)."""
    C = 8
    spans = tacs.draw_write_chunks(prng.prng_key(3), 64, C, locality)
    np.testing.assert_array_equal(spans.numpy(),
                                  _locality_spans(locality, C))
