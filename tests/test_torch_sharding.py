"""The port's sharded authority plane (``repro_torch.service.sharding``,
``connect``) against the JAX package's: the cases of
``tests/test_sharded_service.py`` on the port, then one lockstep load
through ``repro.service.connect`` and ``repro_torch.service.connect``
(on the CPU) at K in {2, 4, 8}, held equal to the integer, and the
port's sharded trace read by the reference's cross-shard oracle."""

import asyncio
import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import service as rservice  # noqa: E402
from repro.sim import oracle as roracle  # noqa: E402
from repro.sim import workloads as rworkloads  # noqa: E402
from repro_torch import service  # noqa: E402
from repro_torch.configs import (CoherenceConfig, CoherenceCore,  # noqa: E402
                                 ServiceLayer, ShardTopology,
                                 shard_of_artifact)
from repro_torch.launch.mesh import shard_streams  # noqa: E402
from repro_torch.service import (BrokerConfig, CoherenceBroker,  # noqa: E402
                                 HostL1Directory, InvariantViolation,
                                 ServicePortal, ShardedCoherenceBroker,
                                 connect, verify_broker)
from repro_torch.service import broker as broker_mod  # noqa: E402
from repro_torch.service.trace import verify_sharded_broker  # noqa: E402
from repro_torch.sim import oracle  # noqa: E402
from repro_torch.sim import workloads as tworkloads  # noqa: E402

pytestmark = pytest.mark.torch

CPU = {"device": "cpu"}


def _names(m: int) -> tuple:
    return tuple(f"artifact-{d}" for d in range(m))


def _config(n: int = 4, m: int = 6, tokens: int = 32,
            **kw) -> CoherenceConfig:
    return CoherenceConfig.make(n, _names(m), artifact_tokens=tokens,
                                **kw)


def _ping_pong_schedule(n: int, m: int, rounds: int, seed: int = 7):
    """Adversarial cross-shard ping-pong (the reference test's): every
    agent alternates between writing its own artifact and reading its
    neighbor's, plus an occasional contended artifact."""
    rng = np.random.default_rng(seed)
    schedule = []
    for r in range(rounds):
        actions = [(a, a % m, True) if (r + a) % 2 == 0
                   else (a, (a + 1) % m, False) for a in range(n)]
        if rng.random() < 0.5:
            actions.append((n - 1, 0, bool(rng.random() < 0.5)))
        seen, uniq = set(), []
        for a, d, w in actions[:n]:
            if a not in seen:
                seen.add(a)
                uniq.append((a, d, w))
        schedule.append(uniq)
    return schedule


async def _drive(broker, schedule, names):
    for actions in schedule:
        await asyncio.gather(*(
            broker.write(a, names[d]) if w else broker.read(a, names[d])
            for a, d, w in actions))


def _run_topology(shards: int, hosts: int, package=service, opts=CPU,
                  rounds: int = 12, verify: bool = False):
    async def go():
        cfg = package.CoherenceConfig.make(4, _names(6), artifact_tokens=32,
                                           shards=shards, hosts=hosts)
        async with package.connect(cfg, **opts) as broker:
            await _drive(broker, _ping_pong_schedule(4, 6, rounds),
                         cfg.artifacts)
            if verify:
                verify_broker(broker)
            return (dataclasses.astuple(broker.ledger),
                    np.array(broker.directory_state),
                    np.array(broker.versions), broker.stats())
    return asyncio.run(go())


# ---------------------------------------------------------------------------
# Routing and the layered config.


def test_shard_routing_stable_and_partitioning():
    assert shard_of_artifact("artifact-0", 1) == 0
    for k in (2, 4, 8):
        vals = [shard_of_artifact(f"artifact-{d}", k) for d in range(16)]
        assert all(0 <= v < k for v in vals)
        assert vals == [rservice.shard_of_artifact(f"artifact-{d}", k)
                        for d in range(16)]
    cfg = _config(m=6, shards=4)
    owned = cfg.shard_artifact_indices()
    assert sorted(d for cols in owned for d in cols) == list(range(6))
    for d, s in enumerate(cfg.artifact_shards()):
        assert d in owned[s]
    ref = rservice.CoherenceConfig.make(4, _names(6), artifact_tokens=32,
                                        shards=4)
    assert owned == ref.shard_artifact_indices()


def test_explicit_assignment_overrides_hash():
    cfg = _config(m=4, shards=2, assignment=(0, 0, 1, 1))
    assert cfg.artifact_shards() == (0, 0, 1, 1)
    with pytest.raises(ValueError):
        _config(m=4, shards=2, assignment=(0, 2, 1, 1))


def test_sharded_forbids_simulator_staleness():
    with pytest.raises(ValueError, match="staleness"):
        _config(shards=2, max_stale_steps=2)
    assert _config(max_stale_steps=2).core.max_stale_steps == 2
    trivial = _config(max_stale_steps=2)
    with pytest.raises(ValueError, match="staleness"):
        ShardedCoherenceBroker(trivial, device="cpu")


def test_make_routes_knobs_to_layers():
    cfg = CoherenceConfig.make(
        4, _names(2), artifact_tokens=64, strategy="eager",
        batch_window=0.01, shards=2, hosts=2, l1_max_version_lag=1)
    assert cfg.core == CoherenceCore(artifact_tokens=64, strategy="eager")
    assert cfg.service == ServiceLayer(batch_window=0.01)
    assert cfg.topology == ShardTopology(n_shards=2, n_hosts=2,
                                         l1_max_version_lag=1)
    with pytest.raises(TypeError, match="unknown coherence knob"):
        CoherenceConfig.make(4, _names(2), tokens=64)


def test_shard_streams_on_the_cpu():
    assert shard_streams(3, "cpu") == (None, None, None)
    broker = connect(_config(shards=2), **CPU)
    assert broker.streams == (None, None)
    assert all(b.decider.stream is None for b in broker.brokers)


# ---------------------------------------------------------------------------
# Sharding changes nothing observable.


def test_cross_shard_ping_pong_bit_exact():
    """K in {1, 2, 4} on the adversarial ping-pong, and the reference at
    K = 4: equal ledgers, directories and versions; the port's K = 4 run
    passes its own conformance closure."""
    led1, st1, ver1, _ = _run_topology(1, 1)
    led2, st2, ver2, _ = _run_topology(2, 2)
    led4, st4, ver4, stats4 = _run_topology(4, 2, verify=True)
    rled, rst, rver, rstats = _run_topology(4, 2, package=rservice,
                                            opts={})
    assert led1 == led2 == led4 == rled
    for st, ver in ((st2, ver2), (st4, ver4), (rst, rver)):
        np.testing.assert_array_equal(st1, st)
        np.testing.assert_array_equal(ver1, ver)
    assert stats4["topology"] == rstats["topology"]
    assert stats4["l1"] == rstats["l1"]
    assert stats4["topology"]["n_shards"] == 4
    assert stats4["l1"]["l1_fills"] + stats4["l1"]["l2_fills"] > 0


def _chunked_run(package, shards, hosts, opts):
    """Writers edit one 16-token chunk per commit (the reference test's
    schedule), so delta traffic stays chunk-granular."""
    async def go():
        cfg = package.CoherenceConfig.make(
            4, _names(6), artifact_tokens=64, chunk_tokens=16,
            shards=shards, hosts=hosts)
        docs = {nm: list(range(64)) for nm in cfg.artifacts}
        async with package.connect(cfg, contents=dict(docs),
                                   **opts) as broker:
            for r in range(8):
                jobs = []
                for a in range(4):
                    name = cfg.artifacts[(a + r) % 6]
                    if (r + a) % 3 == 0:
                        lo = ((r + a) % 4) * 16
                        doc = list(docs[name])
                        doc[lo:lo + 16] = [1000 * r + a] * 16
                        docs[name] = doc
                        jobs.append(broker.write(a, name, doc))
                    else:
                        jobs.append(broker.read(a, name))
                await asyncio.gather(*jobs)
            if package is service and shards > 1:
                verify_sharded_broker(broker)
            return (dict(broker.wire), dataclasses.astuple(broker.ledger),
                    dict(getattr(broker, "l1_wire", {})))
    return asyncio.run(go())


def test_sharded_chunked_byte_exact():
    wire1, led1, _ = _chunked_run(service, 1, 1, CPU)
    wire2, led2, l1 = _chunked_run(service, 2, 2, CPU)
    rwire, rled, rl1 = _chunked_run(rservice, 2, 2, {})
    assert led1 == led2 == rled
    assert wire1 == wire2 == rwire
    assert l1 == rl1
    assert wire2["delta_bytes"] < wire2["full_bytes"]


def test_sharded_trace_records_global_commit_order():
    async def go():
        cfg = _config(m=6, shards=2)
        async with connect(cfg, **CPU) as broker:
            await _drive(broker, _ping_pong_schedule(4, 6, 6),
                         cfg.artifacts)
            return broker
    broker = asyncio.run(go())
    trace = broker.trace
    assert trace.n_shards == 2
    assert trace.artifact_shards == broker.artifact_shards
    shards_seen = {s.shard for s in trace.steps}
    assert shards_seen == {0, 1}
    for step in trace.steps:
        assert {trace.artifact_shards[d] for d in step.arts} == {step.shard}
    oracle.check_sharded_trace(trace.acs_config(), trace.to_oracle_trace(),
                               trace.artifact_shards, name="unit",
                               device="cpu")


def test_shard_subtrace_projection():
    acts = np.array([[1, 1], [1, 0], [0, 1]], bool)
    arts = np.array([[0, 1], [2, 0], [0, 3]], np.int32)
    writes = np.array([[1, 0], [0, 0], [0, 1]], bool)
    trace = oracle.Trace(acts=acts, arts=arts, writes=writes)
    sub, cols = oracle.shard_subtrace(trace, (0, 1, 0, 1), 1)
    np.testing.assert_array_equal(cols, [1, 3])
    np.testing.assert_array_equal(sub.acts, [[False, True], [False, True]])
    np.testing.assert_array_equal(sub.arts[sub.acts], [0, 1])
    np.testing.assert_array_equal(sub.writes[sub.acts], [False, True])


# ---------------------------------------------------------------------------
# L1 plane.


def test_l1_attribution_and_invalidation():
    async def go():
        cfg = _config(m=2, shards=1, hosts=2, placement=(0, 0, 1, 1))
        async with ShardedCoherenceBroker(cfg, **CPU) as broker:
            name = cfg.artifacts[0]
            await broker.write(2, name)        # v2: host 1 holds a copy
            await broker.read(0, name)         # host 0 cold -> L2 fill
            assert broker.l1_wire["l2_fills"] == 1
            await broker.read(1, name)         # same host, same version
            assert broker.l1_wire["l1_fills"] == 1
            await broker.write(3, name)        # invalidates host 0's L1
            assert broker.l1[0].lookup(name) is None
            entry = broker.l1[1].lookup(name)
            assert entry is not None and entry.version == 3
            await broker.read(0, name)         # host 0 must go to L2
            assert broker.l1_wire["l2_fills"] == 2
            await broker.read(2, name)         # host 1 serves locally
            assert broker.l1_wire["l1_fills"] == 2
            return dict(broker.l1_wire)
    wire = asyncio.run(go())
    assert wire["l1_bytes"] + wire["l2_bytes"] > 0


def test_l1_staleness_whitebox():
    async def go():
        cfg = _config(m=2, shards=1, hosts=2, placement=(0, 0, 1, 1))
        async with ShardedCoherenceBroker(cfg, **CPU) as broker:
            name = cfg.artifacts[0]
            await broker.write(0, name)            # v2, host 0 adopts
            broker.l1[1].fill(name, 1, tuple(broker.brokers[0]
                                             .store.get(name)))
            await broker.write(0, name)            # v3 -> lag now 2
            broker.l1[1].fill(name, 1, (0,) * 32)  # re-lose the signal
            with pytest.raises(InvariantViolation, match="L1 staleness"):
                broker.check_l1()
            with pytest.raises(InvariantViolation, match="L1 staleness"):
                await broker.read(2, name)
            broker.l1[1].invalidate(name)          # heal for clean stop
    asyncio.run(go())


def test_l1_directory_unit():
    l1 = HostL1Directory(0, max_version_lag=1)
    l1.fill("a", 3, (1, 2))
    assert l1.lookup("a").version == 3
    l1.check("a", 4)                     # lag 1 == bound: fine
    with pytest.raises(InvariantViolation):
        l1.check("a", 5)                 # lag 2 > bound
    l1.invalidate("a")
    assert l1.lookup("a") is None
    assert l1.n_invalidations == 1
    l1.check("a", 99)


# ---------------------------------------------------------------------------
# connect() and the portal.


def test_connect_resolves_topology():
    trivial = connect(n_agents=2, artifacts=("a",), artifact_tokens=16,
                      **CPU)
    assert type(trivial) is CoherenceBroker
    assert trivial.decider.device == torch.device("cpu")
    sharded = connect(n_agents=2, artifacts=_names(4), artifact_tokens=16,
                      shards=2, **CPU)
    assert isinstance(sharded, ShardedCoherenceBroker)
    l1_only = connect(n_agents=4, artifacts=("a",), artifact_tokens=16,
                      hosts=2, **CPU)
    assert isinstance(l1_only, ShardedCoherenceBroker)
    with pytest.raises(TypeError):
        connect()
    with pytest.raises(TypeError):
        connect(_config(), n_agents=3)
    with pytest.raises(TypeError):
        connect(n_agents=2, artifacts=("a",), no_such_knob=1)


def test_connect_sync_portal_roundtrip():
    with connect(n_agents=2, artifacts=_names(2), artifact_tokens=16,
                 shards=2, sync=True, **CPU) as portal:
        assert isinstance(portal, ServicePortal)
        assert isinstance(portal.broker, ShardedCoherenceBroker)
        client = portal.client(0)
        assert not client.read("artifact-0").hit
        assert client.write("artifact-1").version == 2
    with ServicePortal(_config(m=3, shards=2, hosts=2), **CPU) as portal:
        assert isinstance(portal.broker, ShardedCoherenceBroker)
        assert portal.client(3).write("artifact-2").version == 2


def test_portal_ends_its_thread_when_no_broker_is_built(monkeypatch):
    """A portal whose broker cannot be built (here: the default device
    on a host without a card) raises and leaves no loop thread behind."""
    import threading
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        connect(n_agents=2, artifacts=_names(2), shards=2, sync=True)
    assert not any(t.name == "coherence-broker" and t.is_alive()
                   for t in threading.enumerate())


def test_connect_accepts_legacy_broker_config():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = BrokerConfig(n_agents=2, artifacts=("a",),
                              artifact_tokens=16)
    broker = connect(legacy, **CPU)
    assert type(broker) is CoherenceBroker
    assert broker.config.artifact_tokens == 16


def test_config_layering_golden_ledger(monkeypatch):
    monkeypatch.setattr(broker_mod, "_LEGACY_WARNED", False)
    with pytest.warns(DeprecationWarning, match="thin frozen view"):
        legacy = BrokerConfig(n_agents=4, artifacts=_names(3),
                              artifact_tokens=32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # a second warn would raise
        BrokerConfig(n_agents=4, artifacts=_names(3), artifact_tokens=32)
    monkeypatch.setattr(broker_mod, "_LEGACY_WARNED", False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # blessed path never warns
        layered = _config(n=4, m=3).broker_view()
    assert layered == legacy
    assert legacy.coherence_config().broker_view() == legacy

    async def run(config):
        async with connect(config, **CPU) as broker:
            for _ in range(6):
                await asyncio.gather(
                    broker.write(0, "artifact-0"),
                    broker.read(1, "artifact-0"),
                    broker.read(2, "artifact-1"))
            return dataclasses.astuple(broker.ledger)

    assert asyncio.run(run(legacy)) == asyncio.run(run(_config(n=4, m=3)))


def test_trace_shard_roundtrip_and_back_compat():
    async def go():
        cfg = _config(m=6, shards=2)
        async with connect(cfg, **CPU) as broker:
            await _drive(broker, _ping_pong_schedule(4, 4, 4),
                         cfg.artifacts)
            return broker.trace
    trace = asyncio.run(go())
    payload = json.loads(trace.to_json())
    assert payload["schema_version"] == 4
    assert payload["n_shards"] == 2
    assert type(trace).from_json(trace.to_json()) == trace
    for step in payload["steps"]:
        for key in ("shard", "decide_s", "batch_size"):
            step.pop(key)
    payload.pop("n_shards")
    payload.pop("artifact_shards")
    payload["schema_version"] = 2
    old = type(trace).from_json(json.dumps(payload))
    assert old.n_shards == 1 and old.artifact_shards == ()
    assert all(s.shard == -1 for s in old.steps)


# ---------------------------------------------------------------------------
# Differential: one load through both packages' connect.

N, M, TOKENS, ROUNDS, HOSTS = 8, 4, 64, 8, 2


def _drive_plane(package, family, shards, chunk_tokens=0, m=M, seed=5):
    wl = tworkloads if package is service else rworkloads
    opts = CPU if package is service else {}

    async def main():
        w = wl.make(family, n_agents=N, n_artifacts=m,
                    artifact_tokens=TOKENS, n_steps=ROUNDS)
        cfg = package.CoherenceConfig.make(
            N, _names(m), artifact_tokens=TOKENS, chunk_tokens=chunk_tokens,
            shards=shards, hosts=HOSTS)
        async with package.connect(cfg, **opts) as plane:
            await package.drive_workload(plane, w, ROUNDS, seed=seed)
            return plane
    return asyncio.run(main())


def _same_plane(port, ref) -> None:
    """Traces step for step (shards included), token, wire and L1
    ledgers, the assembled directory, versions and last_sync, and the
    ``topology`` and ``l1`` sections of ``stats()``."""
    assert dataclasses.astuple(port.ledger) == dataclasses.astuple(ref.ledger)
    assert port.wire == ref.wire
    assert port.l1_wire == ref.l1_wire
    np.testing.assert_array_equal(port.directory_state, ref.directory_state)
    np.testing.assert_array_equal(port.versions, ref.versions)
    np.testing.assert_array_equal(port.last_sync, ref.last_sync)
    assert port.trace.n_shards == ref.trace.n_shards
    assert port.trace.artifact_shards == ref.trace.artifact_shards
    assert port.trace.n_steps == ref.trace.n_steps > 0
    for s1, s2 in zip(port.trace.steps, ref.trace.steps):
        assert ((s1.agents, s1.arts, s1.writes, s1.miss, s1.version,
                 s1.chunks, s1.shard, s1.batch_size)
                == (s2.agents, s2.arts, s2.writes, s2.miss, s2.version,
                    s2.chunks, s2.shard, s2.batch_size))
    ps, rs = port.stats(), ref.stats()
    assert ps["topology"] == rs["topology"]
    assert ps["l1"] == rs["l1"]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("family,chunk_tokens", [
    ("ping_pong", 0), ("ping_pong", 16), ("zipf", 0), ("zipf", 16)])
def test_plane_equals_the_reference(family, chunk_tokens, shards):
    port = _drive_plane(service, family, shards, chunk_tokens)
    ref = _drive_plane(rservice, family, shards, chunk_tokens)
    assert port.brokers[0].decider.backend == "kernel"
    _same_plane(port, ref)
    report = verify_broker(port, name=f"{family}:K={shards}")
    assert "kernel" in report.implementations


def test_eight_shards_over_six_artifacts():
    """Some of the K = 8 shards own no artifact."""
    port = _drive_plane(service, "ping_pong", 8, m=6)
    ref = _drive_plane(rservice, "ping_pong", 8, m=6)
    assert 0 in port.stats()["topology"]["shard_artifacts"]
    _same_plane(port, ref)
    verify_broker(port, name="K=8")


def test_port_trace_replays_in_the_reference_sharded_oracle():
    port = _drive_plane(service, "ping_pong", 4, m=6)
    trace = rservice.ServiceTrace.from_json(port.trace.to_json())
    assert trace.n_shards == 4 and trace.n_steps == port.trace.n_steps
    report = roracle.check_sharded_trace(
        trace.acs_config(), trace.to_oracle_trace(),
        trace.artifact_shards, name="port-sharded-trace")
    np.testing.assert_array_equal(report.state, port.directory_state)
    np.testing.assert_array_equal(report.last_sync, port.last_sync)
    assert report.ledger.fetch_tokens == port.ledger.fetch_tokens
