"""The port's threefry stream against ``jax.random``, bit for bit.

Keys, ``split``, ``fold_in``, the raw bits and every sampler the ACS
draws with (``bernoulli`` with a scalar and a per-agent ``p``,
``randint``, ``categorical`` and the write-span draw), at the engine's
shapes, in both ``jax_threefry_partitionable`` modes.  The mode is set
with ``jax.threefry_partitionable(...)`` around each reference call,
never for the whole process.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import acs as jacs  # noqa: E402
from repro.kernels.mesi_transition import episode_step_keys as j_step_keys  # noqa: E402
from repro_torch.core import acs as tacs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels.mesi_transition import episode_step_keys  # noqa: E402

pytestmark = pytest.mark.torch

MODES = pytest.mark.parametrize("partitionable", [True, False],
                                ids=["partitionable", "legacy"])
SEEDS = (0, 7, 20260305, 2 ** 31 - 1)
#: (n_agents, n_artifacts) of the scenarios, the zoo grids and the fleet
SHAPES = ((4, 3), (6, 4), (16, 16), (5, 1))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _keys(seed, n):
    """(n, 2) engine episode keys of ``seed``: port and reference."""
    j = jacs.run_keys(jax.random.PRNGKey(seed), jnp.arange(n))
    t = tacs.run_keys(prng.prng_key(seed), torch.arange(n))
    return j, t


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_run_keys(seed):
    np.testing.assert_array_equal(_np(jax.random.PRNGKey(seed)),
                                  prng.prng_key(seed).numpy())
    j, t = _keys(seed, 9)
    np.testing.assert_array_equal(_np(j), t.numpy())


def test_seed_range_is_checked():
    for bad in (-1, 2 ** 31):
        with pytest.raises(ValueError, match="seed"):
            prng.prng_key(bad)


@MODES
@pytest.mark.parametrize("num", [1, 2, 3, 8, 40])
def test_split(num, partitionable):
    j, t = _keys(11, 5)
    with jax.threefry_partitionable(partitionable):
        expected = jax.vmap(lambda k: jax.random.split(k, num))(j)
    np.testing.assert_array_equal(_np(expected),
                                  prng.split(t, num, partitionable).numpy())


@MODES
def test_episode_step_keys(partitionable):
    j, t = _keys(3, 6)
    with jax.threefry_partitionable(partitionable):
        expected = j_step_keys(j, 40)
    np.testing.assert_array_equal(
        _np(expected), episode_step_keys(t, 40, partitionable).numpy())


@pytest.mark.parametrize("data", [0, 1, 0x5EED, 2 ** 31 + 5, 2 ** 32 - 1])
def test_fold_in(data):
    j, t = _keys(5, 4)
    expected = jax.vmap(lambda k: jax.random.fold_in(k, data))(j)
    np.testing.assert_array_equal(_np(expected),
                                  prng.fold_in(t, data).numpy())


@MODES
@pytest.mark.parametrize("shape", [(1,), (5,), (4, 3), (16, 16), (7, 3)])
def test_bits_and_uniform(shape, partitionable):
    j, t = _keys(2, 4)
    with jax.threefry_partitionable(partitionable):
        bits = jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(j)
        u = jax.vmap(lambda k: jax.random.uniform(k, shape))(j)
    np.testing.assert_array_equal(
        _np(bits), prng.random_bits(t, shape, partitionable).numpy())
    np.testing.assert_array_equal(
        np.asarray(u), prng.uniform(t, shape, partitionable).numpy())


@MODES
@pytest.mark.parametrize("n,m", SHAPES)
def test_bernoulli_scalar_and_per_agent(n, m, partitionable):
    j, t = _keys(4, 6)
    p_agent = np.random.default_rng(n).random(n).astype(np.float32)
    with jax.threefry_partitionable(partitionable):
        scalar = jax.vmap(lambda k: jax.random.bernoulli(
            k, jnp.float32(0.75), (n,)))(j)
        agent = jax.vmap(lambda k: jax.random.bernoulli(
            k, jnp.asarray(p_agent), (n,)))(j)
    np.testing.assert_array_equal(
        np.asarray(scalar), prng.bernoulli(t, 0.75, (n,),
                                           partitionable).numpy())
    np.testing.assert_array_equal(
        np.asarray(agent), prng.bernoulli(t, torch.from_numpy(p_agent),
                                          (n,), partitionable).numpy())


@MODES
@pytest.mark.parametrize("hi", [1, 3, 4, 16, 64, 70])
def test_randint(hi, partitionable):
    j, t = _keys(8, 5)
    with jax.threefry_partitionable(partitionable):
        expected = jax.vmap(lambda k: jax.random.randint(k, (16,), 0, hi))(j)
    np.testing.assert_array_equal(
        np.asarray(expected),
        prng.randint(t, (16,), 0, hi, partitionable).numpy())


@MODES
@pytest.mark.parametrize("n,m", SHAPES)
def test_categorical(n, m, partitionable):
    """Gumbel-max over per-agent log-probabilities.  The Gumbel noise
    takes ``log`` twice, and torch's and XLA's ``log`` round apart by an
    ulp on some inputs; the argmax must not flip on these draws."""
    rng = np.random.default_rng(m)
    pick = rng.dirichlet(np.ones(m), size=n).astype(np.float32)
    log_pick = np.log(np.maximum(pick, 1e-30)).astype(np.float32)
    j, t = _keys(9, 64)
    with jax.threefry_partitionable(partitionable):
        expected = jax.vmap(lambda k: jax.random.categorical(
            k, jnp.asarray(log_pick), axis=-1))(j)
    got = prng.categorical(t, torch.from_numpy(log_pick), None,
                           partitionable)
    np.testing.assert_array_equal(np.asarray(expected), got.numpy())


@MODES
@pytest.mark.parametrize("n,m", SHAPES)
def test_draw_actions_at_engine_shapes(n, m, partitionable):
    """One step of 8 episodes x 40 steps, scalar and rate-matrix paths,
    and the write span, as the engine draws them."""
    j, t = _keys(20260305, 8)
    rng = np.random.default_rng(n * m)
    pick = rng.dirichlet(np.ones(m), size=n).astype(np.float32)
    rates_np = (rng.random(n).astype(np.float32),
                np.log(pick).astype(np.float32),
                rng.random((n, m)).astype(np.float32))
    j_rates = jacs.RateMatrices(*(jnp.asarray(x) for x in rates_np))
    t_rates = tacs.RateMatrices(*(torch.from_numpy(x) for x in rates_np))
    C = 7
    with jax.threefry_partitionable(partitionable):
        steps = j_step_keys(j, 40)

        def one(k):
            scalar = jacs.draw_actions(k, n, m, jnp.float32(0.25),
                                       jnp.float32(0.75))
            het = jacs.draw_actions(k, n, m, None, None, j_rates)
            span = jacs.draw_write_chunks(k, n, C, jnp.float32(0.4))
            return scalar, het, span

        expected = jax.jit(jax.vmap(jax.vmap(one)))(steps)
    t_steps = episode_step_keys(t, 40, partitionable)
    got = (tacs.draw_actions(t_steps, n, m, 0.25, 0.75,
                             partitionable=partitionable),
           tacs.draw_actions(t_steps, n, m, None, None, t_rates,
                             partitionable=partitionable),
           tacs.draw_write_chunks(t_steps, n, C, 0.4,
                                  partitionable=partitionable))
    for e, g in zip(jax.tree.leaves(expected), jax.tree.leaves(
            [list(got[0]), list(got[1]), got[2]])):
        np.testing.assert_array_equal(np.asarray(e), g.numpy())
