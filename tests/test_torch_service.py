"""The port's coherence service (``repro_torch.service``) against the
JAX package's: one lockstep load through ``repro.service``'s broker
(scan route) and the port's broker on both routes, on the CPU; the
port's trace read by the reference's oracle; the port's own oracle,
metrics conformance, invariant checks and route guards."""

import asyncio
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.service import BrokerConfig as RConfig  # noqa: E402
from repro.service import CoherenceBroker as RBroker  # noqa: E402
from repro.service import ServiceTrace as RTrace  # noqa: E402
from repro.service import drive_workload as rdrive  # noqa: E402
from repro.service.trace import replay_trace as rreplay  # noqa: E402
from repro.sim import workloads as rworkloads  # noqa: E402
from repro_torch.core.states import MESIState  # noqa: E402
from repro_torch.kernels import mesi_transition as mt  # noqa: E402
from repro_torch.obs import (MetricsConformanceError,  # noqa: E402
                             check_metrics_conformance)
from repro_torch.service import (BatchDecider, BrokerConfig,  # noqa: E402
                                 CoherenceBroker, CoherenceConfig,
                                 InvariantViolation, ServicePortal,
                                 ServiceTrace, drive_workload,
                                 resolve_decide_backend, verify_broker)
from repro_torch.sim import oracle  # noqa: E402
from repro_torch.sim import workloads as tworkloads  # noqa: E402

pytestmark = pytest.mark.torch

N, M, TOKENS, ROUNDS = 8, 4, 64, 10


def _names(m: int = M) -> tuple:
    return tuple(f"artifact-{d}" for d in range(m))


def _config(package="port", **kw):
    Config = BrokerConfig if package == "port" else RConfig
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return Config(n_agents=kw.pop("n", N), artifacts=_names(
            kw.pop("m", M)), artifact_tokens=TOKENS, **kw)


def _drive(package, family, rounds=ROUNDS, seed=9, n=N, m=M, **kw):
    wl = tworkloads if package == "port" else rworkloads
    drive = drive_workload if package == "port" else rdrive
    Broker = CoherenceBroker if package == "port" else RBroker
    opts = {"device": "cpu"} if package == "port" else {}

    async def main():
        w = wl.make(family, n_agents=n, n_artifacts=m,
                    artifact_tokens=TOKENS, n_steps=rounds)
        async with Broker(_config(package, n=n, m=m, **kw), **opts) as b:
            report = await drive(b, w, n_rounds=rounds, seed=seed)
            return b, report
    return asyncio.run(main())


def _same_service(a, b) -> None:
    """Equal traces step for step, ledgers, wire ledgers, directory and
    versions (latencies are wall-clock and excluded)."""
    assert dataclasses.astuple(a.ledger) == dataclasses.astuple(b.ledger)
    assert a.wire == b.wire
    np.testing.assert_array_equal(a.directory_state, b.directory_state)
    np.testing.assert_array_equal(a.versions, b.versions)
    assert a.trace.n_steps == b.trace.n_steps > 0
    for s1, s2 in zip(a.trace.steps, b.trace.steps):
        assert ((s1.agents, s1.arts, s1.writes, s1.miss, s1.version,
                 s1.chunks, s1.batch_size)
                == (s2.agents, s2.arts, s2.writes, s2.miss, s2.version,
                    s2.chunks, s2.batch_size))


@pytest.mark.parametrize("family,strategy,chunk_tokens", [
    ("bursty", "eager", 0), ("zipf", "lazy", 16),
    ("ping_pong", "access_count", 16)])
def test_both_routes_equal_the_reference_broker(family, strategy,
                                                chunk_tokens):
    ref, ref_load = _drive("ref", family, strategy=strategy,
                           backend="scan", chunk_tokens=chunk_tokens)
    for backend in ("scan", "kernel"):
        port, load = _drive("port", family, strategy=strategy,
                            backend=backend, chunk_tokens=chunk_tokens)
        assert port.decider.backend == backend
        _same_service(port, ref)
        assert load.savings_vs_broadcast == ref_load.savings_vs_broadcast
        last_sync = port.decider.arrays.last_sync[0].numpy()
        np.testing.assert_array_equal(
            last_sync, np.asarray(ref.decider.arrays.last_sync))
        if chunk_tokens:
            for leaf in ("chunk_version", "chunk_sync", "chunk_dirty"):
                np.testing.assert_array_equal(
                    getattr(port.decider.arrays, leaf)[0].numpy(),
                    np.asarray(getattr(ref.decider.arrays, leaf)))
        report = verify_broker(port, name=f"{family}:{backend}")
        assert "kernel" in report.implementations
        check_metrics_conformance(port)


def test_port_trace_replays_in_the_reference_oracle():
    port, _ = _drive("port", "pipeline", rounds=8, seed=6, n=6, m=3,
                     backend="kernel")
    text = port.trace.to_json()
    trace = RTrace.from_json(text)
    assert trace.n_actions == port.trace.n_actions
    report = rreplay(trace, name="port-trace")
    assert report.ledger.fetch_tokens == port.ledger.fetch_tokens
    assert report.ledger.n_hits == port.ledger.n_hits
    np.testing.assert_array_equal(report.state, port.directory_state)
    again = ServiceTrace.from_json(text)
    assert again.to_json() == text


def test_invariant_checker_fires_on_corruption():
    """White-box: corrupt the directory (two M holders) and the next
    flush must raise InvariantViolation."""
    for backend in ("scan", "kernel"):
        async def main():
            async with CoherenceBroker(_config(backend=backend),
                                       device="cpu") as broker:
                await broker.read(0, "artifact-0")
                broker.decider.arrays.state[0, 0:2, 0] = int(MESIState.M)
                with pytest.raises(InvariantViolation):
                    await broker.read(1, "artifact-1")
        asyncio.run(main())


def test_metrics_corruption_goes_red():
    port, _ = _drive("port", "bursty", rounds=6)
    port.telemetry.registry.counter("coh_fetch_tokens_total").inc(
        1, shard=0)
    with pytest.raises(MetricsConformanceError):
        check_metrics_conformance(port)


def test_a_corrupted_ledger_fails_verification():
    port, _ = _drive("port", "bursty", rounds=6, backend="kernel")
    port.ledger.fetch_tokens += 1
    with pytest.raises(oracle.ConformanceError, match="fetch_tokens"):
        verify_broker(port)


def test_reentrant_decide_raises():
    decider = BatchDecider(_config().acs_config(), "kernel", device="cpu")
    acts = np.zeros(N, bool)
    acts[0] = True
    arts = np.zeros(N, np.int32)
    decider._deciding = True
    with pytest.raises(RuntimeError, match="re-entrant"):
        decider.decide(acts, arts, np.zeros(N, bool))
    decider._deciding = False
    assert bool(decider.decide(acts, arts, np.zeros(N, bool)).miss[0])


def test_backend_resolution_guards(monkeypatch):
    cfg = _config(max_stale_steps=2).acs_config()
    assert resolve_decide_backend(cfg, "auto") == "scan"
    with pytest.raises(ValueError):
        resolve_decide_backend(cfg, "kernel")
    with pytest.raises(ValueError):
        resolve_decide_backend(cfg, "pallas")
    plain = _config().acs_config()
    assert resolve_decide_backend(plain, "auto") == "kernel"
    monkeypatch.setenv("REPRO_SERVICE_DECIDE", "scan")
    assert resolve_decide_backend(plain, "kernel") == "scan"
    monkeypatch.setenv("REPRO_SERVICE_DECIDE", "kernel")
    assert resolve_decide_backend(plain, "auto") == "kernel"
    monkeypatch.delenv("REPRO_SERVICE_DECIDE")
    chunked = _config(chunk_tokens=16).acs_config()
    monkeypatch.setenv("REPRO_CHUNK_DIFF", "scan")
    assert resolve_decide_backend(chunked, "auto") == "scan"
    with pytest.raises(ValueError):
        resolve_decide_backend(chunked, "kernel")


def test_empty_batch_launches_nothing():
    decider = BatchDecider(_config(chunk_tokens=16).acs_config(), "kernel",
                           device="cpu")
    out = decider.decide(np.zeros(N, bool), np.zeros(N, np.int32),
                         np.zeros(N, bool),
                         write_chunks=np.zeros((N, 4), bool))
    assert not out.miss.any() and out.wire_delta["delta_bytes"] == 0


def test_decision_entry_agrees_with_the_public_function():
    """The decider's internal entry (one tick, no read-back) and the
    public ``mesi_decision_batch`` give the same decisions."""
    rng = np.random.default_rng(11)
    for n, m in ((1, 1), (5, 3), (9, 2)):
        state = torch.tensor(rng.integers(0, 2, (n, m)), dtype=torch.int32)
        version = torch.tensor(rng.integers(1, 5, m), dtype=torch.int32)
        sync = torch.where(state > 0, version, 0).to(torch.int32)
        reads = torch.tensor(rng.integers(0, 5, (n, m)), dtype=torch.int32)
        acts = rng.random(n) < 0.7
        acts[0] = True
        arts = rng.integers(0, m, n).astype(np.int32)
        writes = rng.random(n) < 0.4
        opts = dict(artifact_tokens=64, access_k=3)
        public = mt.mesi_decision_batch(state, version, sync, reads, acts,
                                        arts, writes, **opts)
        prefix = mt.decision_inputs(acts, arts, writes, m, "cpu")
        internal = mt.decision_tick(state, version, sync, reads, prefix,
                                    **opts)
        for got, want in zip(internal[:4], public[:4]):
            torch.testing.assert_close(got[0], want, rtol=0, atol=0)
        torch.testing.assert_close(internal[4], public[4], rtol=0, atol=0)
        np.testing.assert_array_equal(internal[5].numpy().astype(bool),
                                      public[5].numpy())
        np.testing.assert_array_equal(internal[6].numpy(),
                                      public[6].numpy())


def test_portal_and_layered_config():
    config = CoherenceConfig.make(4, _names(3), artifact_tokens=32)
    with ServicePortal(config, device="cpu") as portal:
        client = portal.client(0)
        assert client.write("artifact-0", [5] * 32).version == 2
        assert not portal.client(1).read("artifact-0").hit
        assert client.read("artifact-0").hit
    sharded = CoherenceConfig.make(4, _names(3), shards=2)
    with pytest.raises(ValueError, match="sharded"):
        CoherenceBroker(sharded, device="cpu")
