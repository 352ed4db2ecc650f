"""The port's device-sharded sweep engine against its unsharded runs and
against the JAX package's sharded engine.

``repro_torch.sim.engine`` shards each grid under ``shard_plan`` (the
reference's rules: runs, else workloads, else padded runs) and runs
shard ``i`` on ``cuda:i``.  On the CPU the shards run on N ``(cpu,
None)`` placements (``engine._placed``, the counterpart of the
reference's forced host devices), one after another, through the same
executor: inputs built per shard, episodes queued per shard, outputs
joined on the sharded axis.  Every per-run ledger must equal the
unsharded run's and ``repro``'s to the integer, on every plan and
route, in both PRNG modes; the sharded cells replay through the port's
oracle.  Plan logic is held to ``repro.sim.shard_plan`` with the local
device count patched on both sides and ``REPRO_SWEEP_DEVICES=auto``
(unset, the port runs one batch where the reference takes every
device), and the authority plane's round-robin to
``repro.launch.mesh.shard_devices``.  The sharded runs ask for their
shards with ``devices=n``.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.launch.mesh as rmesh  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.sim import engine as jengine  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.launch.mesh import shard_cards, shard_devices  # noqa: E402
from repro_torch.sim import engine, oracle  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.sharded]

CPU = torch.device("cpu")
SHARDS = pytest.mark.parametrize("n", [2, 3, 4])
MODES = pytest.mark.parametrize("partitionable", [True, False],
                                ids=["partitionable", "legacy"])


def small(package=tsim, v=0.25, seed=777, n_runs=8, **kw):
    params = dict(n_steps=6, artifact_tokens=64)
    params.update(kw)
    return dataclasses.replace(
        package.canonical("sharded-test", v, seed, **params), n_runs=n_runs)


def small_zoo(n_runs, **kw):
    return tsim.zoo(n_agents=4, n_artifacts=3, n_runs=n_runs,
                    artifact_tokens=64, n_steps=5, **kw)


def on_cpu(n):
    """N CPU placements standing in for N devices."""
    return engine._placed([("cpu", None)] * n)


def grid(cfg, items, cell_of, n_runs, devices, route=None,
         partitionable=True):
    """Every per-run array of both variants of a grid."""
    return engine._run_grid(cfg, items, cell_of, n_runs, True, route, CPU,
                            partitionable, devices)


def assert_same_grid(a, b):
    assert len(a) == len(b)
    for va, vb in zip(a, b):
        assert set(va) == set(vb)
        for key in va:
            np.testing.assert_array_equal(va[key], vb[key], err_msg=key)


# ---------------------------------------------------------------------------
# Plan logic, case for case with the reference's.


@pytest.fixture
def local_count(monkeypatch):
    """Patch the local device count of both engines to ``n``, with
    ``REPRO_SWEEP_DEVICES=auto`` (every local device, the reference's
    default)."""
    def patch(n):
        monkeypatch.setattr(engine, "_local_device_count",
                            lambda device=None: n)
        monkeypatch.setattr(jax, "local_device_count", lambda: n)
        monkeypatch.setenv("REPRO_SWEEP_DEVICES", "auto")
    return patch


@pytest.mark.parametrize("n_local", [1, 2, 3, 4, 6, 8])
def test_plans_equal_the_reference(local_count, n_local):
    local_count(n_local)
    for cells in range(1, 10):
        for runs in range(1, 18):
            for devices in (None, 1, 2, 3, 4, 6, 8, 10_000):
                got = tsim.shard_plan(cells, runs, devices=devices)
                want = jsim.shard_plan(cells, runs, devices=devices)
                assert tuple(got) == tuple(want), (cells, runs, devices)
                if got.axis == "workloads":
                    assert cells % got.devices == 0
                    assert got.pad_runs == runs
                else:
                    assert got.pad_runs % got.devices == 0


@pytest.mark.parametrize("n_dev", [2, 3, 4, 6, 8])
def test_shard_plan_multi_device_cases(local_count, n_dev):
    """The reference's ``TestShardPlan`` / ``TestShardPlanMultiDevice``
    cases at a local count of ``n_dev``."""
    local_count(n_dev)
    assert tsim.shard_plan(4, 8, devices=1) == tsim.ShardPlan(1, None, 8)
    assert tsim.shard_plan(4, 8, devices=10_000).devices <= n_dev
    assert (tsim.shard_plan(3, 2 * n_dev, devices=n_dev)
            == tsim.ShardPlan(n_dev, "runs", 2 * n_dev))
    assert (tsim.shard_plan(n_dev, 2 * n_dev + 1, devices=n_dev)
            == tsim.ShardPlan(n_dev, "workloads", 2 * n_dev + 1))
    plan = tsim.shard_plan(n_dev + 1, n_dev + 1, devices=n_dev)
    assert plan.axis == "runs" and plan.pad_runs == 2 * n_dev
    assert tsim.resolve_sweep_devices() == n_dev


def test_one_device_plans_are_unsharded(local_count, monkeypatch):
    """One local device, or several with ``REPRO_SWEEP_DEVICES`` unset:
    one unsharded batch."""
    local_count(1)
    for cells, runs in ((1, 3), (6, 7), (4, 8)):
        assert tsim.shard_plan(cells, runs).axis is None
    local_count(8)
    monkeypatch.delenv("REPRO_SWEEP_DEVICES")
    assert tsim.resolve_sweep_devices() == 1
    for cells, runs in ((1, 3), (6, 7), (4, 8)):
        assert tsim.shard_plan(cells, runs) == tsim.ShardPlan(1, None, runs)
    assert tsim.shard_plan(4, 8, devices=8).devices == 8


@pytest.mark.parametrize("forced,n_local,want", [
    ("1", 4, 1), ("3", 4, 3), ("9", 4, 4), ("0", 4, 1), ("auto", 6, 6)])
def test_env_override(local_count, monkeypatch, forced, n_local, want):
    local_count(n_local)
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", forced)
    assert tsim.resolve_sweep_devices() == want
    assert jengine.resolve_sweep_devices() == want
    assert tsim.shard_plan(1, 12).devices == want


def test_env_override_rejects_a_bad_value(monkeypatch):
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", "many")
    with pytest.raises(ValueError, match="REPRO_SWEEP_DEVICES"):
        tsim.resolve_sweep_devices()
    with pytest.raises(ValueError, match="REPRO_SWEEP_DEVICES"):
        tsim.run_scenario(small(n_runs=2), device="cpu")


def test_local_count_by_device(monkeypatch):
    """The CPU is one device; CUDA counts the host's cards, a named card
    is one; placements count themselves."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", "auto")
    assert engine._local_device_count("cpu") == 1
    assert engine._local_device_count(CPU) == 1
    assert engine._local_device_count() == 8
    assert engine._local_device_count("cuda") == 8
    assert tsim.shard_plan(1, 8, device="cpu").axis is None
    with on_cpu(3):
        assert engine._local_device_count("cpu") == 3
        assert tsim.resolve_sweep_devices("cpu") == 3
    assert engine._local_device_count("cpu") == 1


@pytest.mark.parametrize("forced", ["auto", "4"])
def test_a_named_card_runs_unsharded_there(monkeypatch, forced):
    """On a host of 8 cards, ``device="cuda:1"`` plans one batch on that
    card whatever ``devices`` or ``REPRO_SWEEP_DEVICES`` ask, where
    ``"cuda"`` takes the host's cards (shard i on ``cuda:i``)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", forced)
    card = torch.device("cuda", 1)
    assert engine._local_device_count(card) == 1
    assert tsim.resolve_sweep_devices(card) == 1
    for devices in (None, 2, 8):
        plan = tsim.shard_plan(6, 8, devices=devices, device=card)
        assert plan == tsim.ShardPlan(1, None, 8)
        assert engine._placements(plan, card) == ((card, None),)
    plan = tsim.shard_plan(6, 8, device="cuda")
    assert plan == tsim.ShardPlan(int(forced) if forced != "auto" else 8,
                                  "runs", 8)
    assert [d for d, _ in engine._placements(plan, torch.device("cuda"))] \
        == [torch.device("cuda", i) for i in range(plan.devices)]


# ---------------------------------------------------------------------------
# Sharded == unsharded, per run, over N CPU placements.


@SHARDS
def test_sweep_runs_axis(n):
    base = small(n_runs=n)
    vols = (0.05, 0.25, 0.75, 1.0)
    ref = tsim.sweep_volatility(base, vols, device="cpu")
    with on_cpu(n):
        assert tsim.shard_plan(4, n, devices=n).axis == "runs"
        got = tsim.sweep_volatility(base, vols, device="cpu", devices=n)
        assert tsim.sweep_volatility(base, vols, device="cpu",
                                     devices=1) == ref
    assert got == ref


@SHARDS
def test_run_scenario_per_run_ledgers(n):
    scn = small(n_runs=2 * n)
    ref = tsim.run_scenario(scn, device="cpu")
    with on_cpu(n):
        got = tsim.run_scenario(scn, device="cpu", devices=n)
    np.testing.assert_array_equal(got.per_run_total_tokens,
                                  ref.per_run_total_tokens)
    np.testing.assert_array_equal(got.per_run_chr, ref.per_run_chr)
    assert got.stats == ref.stats


@SHARDS
def test_padded_runs_plan(n):
    """n_runs 3 divides no N here but 3: runs padded to a multiple of N,
    the padded tail dropped; every real run as unsharded."""
    scn = small(n_runs=3)
    ref = grid(scn.acs, [scn], engine._scenario_cell, 3, 1)
    with on_cpu(n):
        plan = tsim.shard_plan(1, 3, devices=n)
        assert plan.axis == "runs" and plan.pad_runs % n == 0
        assert plan.pad_runs == (3 if n == 3 else 4)
        got = grid(scn.acs, [scn], engine._scenario_cell, 3, n)
    assert_same_grid(got, ref)
    assert got[0]["total_tokens"].shape == (1, 3)


@SHARDS
def test_workload_zoo_runs_axis(n):
    zoo = small_zoo(n)
    ref = tsim.compare_workloads(zoo, device="cpu")
    with on_cpu(n):
        got = tsim.compare_workloads(zoo, device="cpu", devices=n)
    assert got == ref


@SHARDS
def test_content_grid_byte_ledgers(n):
    """The chunked grid: per-run byte ledgers (delta, full, chunks) of
    both variants equal, on the runs and the padded plans."""
    zoo = small_zoo(n, chunk_tokens=16)
    cfg = zoo[0].acs
    for runs in (n, 2 * n + 1):
        ref = grid(cfg, zoo, engine._workload_cell, runs, 1)
        with on_cpu(n):
            got = grid(cfg, zoo, engine._workload_cell, runs, n)
        assert_same_grid(got, ref)
        for key in ("delta_bytes", "full_bytes", "n_chunks_fetched"):
            assert key in got[1]
    ref = tsim.compare_workloads(zoo, device="cpu")
    with on_cpu(n):
        assert tsim.compare_workloads(zoo, device="cpu", devices=n) == ref


@pytest.mark.parametrize("d", [2, 3])
def test_workloads_axis_fallback(d):
    """Six families with d + 1 runs: d divides the families, not the
    runs, so the plan shards the workload axis."""
    zoo = small_zoo(d + 1, chunk_tokens=16)
    assert len(zoo) == 6
    ref = grid(zoo[0].acs, zoo, engine._workload_cell, d + 1, 1)
    with on_cpu(d):
        assert tsim.shard_plan(6, d + 1, devices=d) == tsim.ShardPlan(
            d, "workloads", d + 1)
        got = grid(zoo[0].acs, zoo, engine._workload_cell, d + 1, d)
        cmp = tsim.compare_workloads(zoo, device="cpu", devices=d)
    assert_same_grid(got, ref)
    assert cmp == tsim.compare_workloads(zoo, device="cpu")


@SHARDS
def test_kernel_route_sharded_equals_scan_unsharded(n):
    """The kernel route (the ticks' plain versions on the CPU) per shard
    against the scan route unsharded: equal but the staleness
    diagnostics the kernel route does not track."""
    scn = small(n_runs=2 * n)
    ref = grid(scn.acs, [scn], engine._scenario_cell, 2 * n, 1, "scan")
    with on_cpu(n):
        got = grid(scn.acs, [scn], engine._scenario_cell, 2 * n, n,
                   "kernel")
    assert_same_grid(got[:1], ref[:1])
    for key, want in ref[1].items():
        if key.startswith("max_"):
            assert (got[1][key] == -1).all()
        else:
            np.testing.assert_array_equal(got[1][key], want, err_msg=key)


def test_groups_get_their_own_plans():
    """Scenarios of two static configurations and run counts in one
    call: each group sharded under its own plan, results in order."""
    scns = [small(n_runs=4), small(v=0.5, n_runs=3),
            small(v=0.1, n_runs=4, n_agents=3)]
    ref = tsim.compare_grid(scns, device="cpu")
    with on_cpu(2):
        got = tsim.compare_grid(scns, device="cpu", devices=2)
    assert got == ref


# ---------------------------------------------------------------------------
# The oracle and the reference.


@SHARDS
def test_oracle_replays_sharded_cells(n):
    scn = small(n_runs=2 * n)
    with on_cpu(n):
        got = tsim.run_scenario(scn, device="cpu", tick_backend="kernel",
                                devices=n)
    for r in (0, n - 1, 2 * n - 1):
        trace = oracle.sample_trace(scn.acs,
                                    oracle.episode_key(scn.seed, r, "cpu"))
        ledger, _, _, _ = oracle.replay_vectorized(scn.acs, trace, "cpu")
        assert int(got.per_run_total_tokens[r]) == ledger.total_tokens


@MODES
@pytest.mark.parametrize("n,runs", [(2, 4), (3, 3), (4, 3)])
def test_sharded_grid_equals_reference(n, runs, partitionable):
    """The runs and padded plans' per-run ledgers against
    ``repro.sim.run_scenario(..., devices=1)``, in both modes."""
    jscn = small(jsim, n_runs=runs)
    tscn = small(n_runs=runs)
    with jax.threefry_partitionable(partitionable):
        want = jsim.run_scenario(jscn, tick_backend="scan", devices=1)
    with on_cpu(n):
        got = tsim.run_scenario(tscn, device="cpu",
                                partitionable=partitionable, devices=n)
    np.testing.assert_array_equal(got.per_run_total_tokens,
                                  want.per_run_total_tokens)
    np.testing.assert_array_equal(got.per_run_chr, want.per_run_chr)


# ---------------------------------------------------------------------------
# The authority plane's shards over the host's cards.


@pytest.mark.parametrize("n_local", [1, 2, 4])
def test_shard_cards_equal_the_reference_round_robin(monkeypatch, n_local):
    monkeypatch.setattr(rmesh.jax, "devices", lambda: list(range(n_local)))
    monkeypatch.setattr(rmesh, "make_sweep_mesh", lambda n, axis:
                        types.SimpleNamespace(devices=np.arange(n)))
    for k in range(1, 7):
        want = tuple(int(d) for d in rmesh.shard_devices(k))
        assert shard_cards(k, n_local) == want
        assert len(set(want)) == min(k, n_local)


def test_shard_devices_on_the_cpu():
    assert shard_devices(3, "cpu") == ((CPU, None),) * 3
    from repro_torch.service import connect
    plane = connect(n_agents=4, artifacts=("a", "b", "c"),
                    artifact_tokens=16, shards=3, device="cpu")
    assert plane.placements == ((CPU, None),) * 3
    assert plane.streams == (None, None, None)
    assert all(b.decider.device == CPU and b.decider.stream is None
               for b in plane.brokers)
