"""Oracle-replayable action traces of the live coherence service.

Every micro-batch the broker commits is one *serialized authority
pass* - exactly the shape of one simulator tick.  Recording the batch
stream as a ``(n_batches, n_agents)`` action matrix therefore yields a
trace in the four-way differential oracle's native format
(``repro_torch.sim.oracle.Trace``): batches map to steps, and within a batch
agents are processed ascending, which is both the broker's and the
kernel's serialization order.

``verify_broker`` closes the live-service <-> conformance loop: the
captured trace is replayed through the message-level protocol, the
batched ACS, the MESI tick kernel (on the broker's device) and (for
lazy) the model checker's transition relation, then the agreed-upon
ledger / MESI states / versions are compared **bit-for-bit** against
what the live broker actually charged and holds.  Any scheduling bug,
lost update or double-charge in the async layer shows up as a
ConformanceError.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.core import acs


@dataclasses.dataclass
class StepRecord:
    """One committed micro-batch (one serialized authority pass)."""

    agents: tuple        # acting agent ids, ascending
    arts: tuple          # artifact index per acting agent
    writes: tuple        # bool per acting agent
    miss: tuple          # bool per acting agent (coherence fill)
    version: tuple       # served version per acting agent
    latency_s: tuple     # decision latency per acting agent
    #: measured dirty chunk indices per acting agent (content plane;
    #: empty tuples for reads / whole-artifact brokers)
    chunks: tuple = ()
    #: authority shard that committed this batch (-1 = unsharded
    #: broker).  Steps from different shards interleave in *global
    #: commit order* - the one serializable order the oracle replays.
    shard: int = -1
    #: v4 telemetry stamps: decision-kernel wall time for this batch
    #: and the cut batch size (requests decided together).  Defaults
    #: are what v3-and-older traces load with; ``batch_size`` falls
    #: back to ``len(agents)`` when unstamped (-1), so offline latency
    #: reconstruction works on any trace vintage.
    decide_s: float = 0.0
    batch_size: int = -1

    @property
    def size(self) -> int:
        """Batch size, robust to v3 traces (unstamped -> len(agents))."""
        return self.batch_size if self.batch_size >= 0 else len(self.agents)


@dataclasses.dataclass
class ServiceTrace:
    """Append-only audit log of every decision the broker made."""

    n_agents: int
    n_artifacts: int
    artifact_tokens: int
    strategy: str
    access_k: int
    max_stale_steps: int
    chunk_tokens: int = 0
    #: authority-plane topology: shard count and per-artifact shard id
    #: (empty tuple = unsharded).  Replays ignore them - the global
    #: commit order is already serializable - but the cross-shard
    #: conformance leg (``sim.oracle.check_sharded_trace``) uses them
    #: to re-derive every shard's local history.
    n_shards: int = 1
    artifact_shards: tuple = ()
    steps: list = dataclasses.field(default_factory=list)

    @classmethod
    def for_broker(cls, config) -> "ServiceTrace":
        return cls(n_agents=config.n_agents,
                   n_artifacts=len(config.artifacts),
                   artifact_tokens=config.artifact_tokens,
                   strategy=config.strategy,
                   access_k=config.access_k,
                   max_stale_steps=config.max_stale_steps,
                   chunk_tokens=getattr(config, "chunk_tokens", 0))

    # -------------------------------------------------------- capture
    def append_step(self, acts, arts, writes, miss, version,
                    latencies: Optional[dict] = None,
                    write_chunks=None, shard: int = -1,
                    decide_s: float = 0.0,
                    batch_size: Optional[int] = None) -> None:
        agents = tuple(int(a) for a in np.flatnonzero(np.asarray(acts)))
        chunks = ()
        if write_chunks is not None:
            chunks = tuple(
                tuple(np.flatnonzero(write_chunks[a]).tolist())
                if writes[a] else () for a in agents)
        self.steps.append(StepRecord(
            agents=agents,
            arts=tuple(int(arts[a]) for a in agents),
            writes=tuple(bool(writes[a]) for a in agents),
            miss=tuple(bool(miss[a]) for a in agents),
            version=tuple(int(version[a]) for a in agents),
            latency_s=tuple(float((latencies or {}).get(a, 0.0))
                            for a in agents),
            chunks=chunks, shard=int(shard),
            decide_s=float(decide_s),
            batch_size=(len(agents) if batch_size is None
                        else int(batch_size))))

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def n_actions(self) -> int:
        return sum(len(s.agents) for s in self.steps)

    # ------------------------------------------------- oracle interface
    def acs_config(self) -> acs.ACSConfig:
        return acs.ACSConfig(
            n_agents=self.n_agents, n_artifacts=self.n_artifacts,
            artifact_tokens=self.artifact_tokens,
            n_steps=max(self.n_steps, 1),
            strategy=acs.STRATEGY_CODES[self.strategy],
            access_k=self.access_k,
            max_stale_steps=self.max_stale_steps,
            chunk_tokens=self.chunk_tokens)

    def to_oracle_trace(self):
        """The captured batch stream as a ``sim.oracle.Trace`` (batches
        = steps; agent order within a batch is the serialization
        order both executions share).  Chunked traces carry the
        measured per-write dirty masks, so the byte-exact content leg
        replays the *actual* diffs the live broker served."""
        from repro_torch.content.chunks import n_chunks as _n_chunks
        from repro_torch.sim import oracle
        T = max(self.n_steps, 1)
        acts = np.zeros((T, self.n_agents), bool)
        arts = np.zeros((T, self.n_agents), np.int32)
        writes = np.zeros((T, self.n_agents), bool)
        write_chunks = None
        if self.chunk_tokens > 0:
            C = _n_chunks(self.artifact_tokens, self.chunk_tokens)
            write_chunks = np.zeros((T, self.n_agents, C), bool)
        for s, rec in enumerate(self.steps):
            chunks = rec.chunks or ((),) * len(rec.agents)
            for a, d, w, ch in zip(rec.agents, rec.arts, rec.writes,
                                   chunks):
                acts[s, a] = True
                arts[s, a] = d
                writes[s, a] = w
                if write_chunks is not None and w:
                    write_chunks[s, a, list(ch)] = True
        return oracle.Trace(acts=acts, arts=arts, writes=writes,
                            write_chunks=write_chunks)

    # ----------------------------------------------- offline telemetry
    def latency_report(self) -> dict:
        """Reconstruct the service latency/decide histograms from the
        trace alone (no live broker needed).  v4 traces carry per-step
        decision wall time and batch size; v3-and-older traces yield
        zeros for ``decide_*`` and ``len(agents)`` batch sizes."""
        lat = np.asarray([x for s in self.steps for x in s.latency_s],
                         float)
        if lat.size == 0:
            lat = np.zeros(1)
        sizes = [s.size for s in self.steps]
        decide = [s.decide_s for s in self.steps]
        return {
            "n_steps": self.n_steps,
            "n_actions": self.n_actions,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "mean_batch": (sum(sizes) / max(len(sizes), 1)),
            "max_batch": max(sizes, default=0),
            "decide_s_total": float(sum(decide)),
            "decide_s_max": float(max(decide, default=0.0)),
        }

    # --------------------------------------------------- serialization
    def to_json(self) -> str:
        payload = dataclasses.asdict(self)
        # v2: chunk_tokens + step chunks; v3: shard topology + step
        # shard; v4: per-step decide_s + batch_size telemetry stamps
        payload["schema_version"] = 4
        return json.dumps(payload, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ServiceTrace":
        payload = json.loads(text)
        payload.pop("schema_version", None)
        payload.setdefault("chunk_tokens", 0)   # v1 traces
        payload.setdefault("n_shards", 1)       # v1/v2 traces
        payload["artifact_shards"] = tuple(
            payload.get("artifact_shards", ()))

        def record(s: dict) -> StepRecord:
            chunks = tuple(tuple(c) for c in s.pop("chunks", ()))
            shard = int(s.pop("shard", -1))
            decide_s = float(s.pop("decide_s", 0.0))    # v3 traces
            batch_size = int(s.pop("batch_size", -1))   # v3 traces
            return StepRecord(chunks=chunks, shard=shard,
                              decide_s=decide_s, batch_size=batch_size,
                              **{k: tuple(v) for k, v in s.items()})

        steps = [record(s) for s in payload.pop("steps")]
        return cls(steps=steps, **payload)


# ---------------------------------------------------------------------------
# The live-service <-> conformance loop.


def replay_trace(trace: ServiceTrace, name: str = "service",
                 device=None):
    """Replay a captured service trace through the four-way oracle,
    its tensor legs on ``device`` (``None``: CUDA).

    Returns the agreed-upon ``DiffReport``; raises ``ConformanceError``
    if any two implementations disagree on the trace."""
    from repro_torch.sim import oracle
    return oracle.check_trace(trace.acs_config(),
                              trace.to_oracle_trace(), name=name,
                              device=device)


def verify_broker(broker, name: str = "service"):
    """Replay the broker's own captured trace through the oracle and
    assert the *live* ledger, MESI directory and versions match the
    replay bit-for-bit.  The acceptance surface for the async layer:
    batching, interleaving and dispatch may reorder concurrent
    requests, but the serialized history the broker committed must be
    exactly executable - and exactly charged - under all four
    reference implementations, whose tensor legs run on the broker's
    own device.

    Sharded brokers (``service.sharding.ShardedCoherenceBroker``)
    dispatch to :func:`verify_sharded_broker`, which adds the
    cross-shard and L1/L2 conformance legs."""
    from repro_torch.sim import oracle
    if getattr(broker, "is_sharded", False):
        return verify_sharded_broker(broker, name=name)
    if not broker.config.capture_trace:
        raise ValueError(
            "broker was started with capture_trace=False (unbounded "
            "deployments); oracle verification needs the audit trace")
    if broker.n_batches != broker.trace.n_steps:
        raise ValueError(
            f"trace has {broker.trace.n_steps} steps but the broker "
            f"committed {broker.n_batches} batches - partial capture "
            f"cannot be verified")
    report = replay_trace(broker.trace, name=name,
                          device=broker.decider.device)
    led = broker.ledger
    for field in dataclasses.fields(oracle.Ledger):
        live = int(getattr(led, field.name))
        replayed = int(getattr(report.ledger, field.name))
        if live != replayed:
            raise oracle.ConformanceError(
                f"live broker ledger.{field.name} = {live} but oracle "
                f"replay charged {replayed}")
    if not np.array_equal(broker.directory_state, report.state):
        raise oracle.ConformanceError(
            f"live MESI directory diverged from replay:\n"
            f"live:\n{broker.directory_state}\nreplay:\n{report.state}")
    if not np.array_equal(broker.versions, report.version):
        raise oracle.ConformanceError(
            f"live versions diverged from replay: {broker.versions} "
            f"vs {report.version}")
    sync = broker.decider.arrays.last_sync[0].cpu().numpy()
    if not np.array_equal(sync, report.last_sync):
        raise oracle.ConformanceError(
            f"live last_sync diverged from replay:\n{sync}\n"
            f"vs\n{report.last_sync}")
    if broker.chunks is not None:
        verify_broker_content(broker, name=name)
    return report


def verify_sharded_broker(broker, name: str = "service-sharded"):
    """Conformance closure for the sharded authority plane.

    Four legs, all bit-exact:

    1. **Global serializability** + **cross-shard decomposition** -
       the interleaved per-shard batch stream replays through
       ``sim.oracle.check_sharded_trace``: the four-way harness treats
       it as ONE serializable history, and every shard's projected
       sub-trace independently re-derives that shard's directory
       columns and its share of the ledger.
    2. **Live-state comparison** - the *summed* per-shard ledgers and
       the *assembled* directory/version/last_sync views must equal
       the global replay exactly (sharding changed nothing
       observable).
    3. **Content plane** (chunked brokers) - summed wire bytes and
       assembled chunk arrays vs the byte-exact replay, plus every
       shard's chunk index reassembling to its canonical artifacts.
    4. **L1/L2** - every valid host-L1 entry is within the
       version-lag bound and byte-identical to its shard's authority
       copy, and L1+L2 fill attribution conserves the read-miss count
       (the L1 plane never changed what the decision plane charged).
    """
    from repro_torch.sim import oracle
    if not broker.config.service.capture_trace:
        raise ValueError(
            "broker was started with capture_trace=False (unbounded "
            "deployments); oracle verification needs the audit trace")
    trace = broker.trace
    if broker.n_batches != trace.n_steps:
        raise ValueError(
            f"trace has {trace.n_steps} steps but the sharded broker "
            f"committed {broker.n_batches} batches - partial capture "
            f"cannot be verified")
    device = broker.brokers[0].decider.device
    report = oracle.check_sharded_trace(
        trace.acs_config(), trace.to_oracle_trace(),
        trace.artifact_shards, name=name, device=device)
    led = broker.ledger
    for field in dataclasses.fields(oracle.Ledger):
        live = int(getattr(led, field.name))
        replayed = int(getattr(report.ledger, field.name))
        if live != replayed:
            raise oracle.ConformanceError(
                f"summed shard ledger.{field.name} = {live} but oracle "
                f"replay charged {replayed}")
    for label, live, want in (
            ("directory_state", broker.directory_state, report.state),
            ("versions", broker.versions, report.version),
            ("last_sync", broker.last_sync, report.last_sync)):
        if not np.array_equal(np.asarray(live), want):
            raise oracle.ConformanceError(
                f"assembled sharded {label} diverged from replay:\n"
                f"{np.asarray(live)}\nvs\n{want}")
    if broker.chunked:
        _verify_sharded_content(broker, report, name=name,
                                device=device)
    # ---- L1/L2 leg
    broker.check_l1()
    read_misses = sum(
        sum(1 for w, miss in zip(s.writes, s.miss) if miss and not w)
        for s in trace.steps)
    attributed = (broker.l1_wire["l1_fills"]
                  + broker.l1_wire["l2_fills"])
    if attributed != read_misses:
        raise oracle.ConformanceError(
            f"L1/L2 fill attribution lost fills: {attributed} "
            f"attributed vs {read_misses} read misses in the trace")
    return report


def _verify_sharded_content(broker, report, name: str, device=None):
    """Byte-exact content leg of sharded verification (chunk ledgers,
    chunk arrays, and per-shard store reassembly)."""
    from repro_torch.content.chunks import reassemble, split_chunks
    from repro_torch.sim import oracle
    trace = broker.trace
    creport = oracle.check_content_trace(
        trace.acs_config(), trace.to_oracle_trace(),
        name=f"{name}:content", device=device)
    wire = broker.wire
    for field in dataclasses.fields(oracle.ByteLedger):
        live = int(wire[field.name])
        replayed = int(getattr(creport.ledger, field.name))
        if live != replayed:
            raise oracle.ConformanceError(
                f"summed shard wire.{field.name} = {live} but oracle "
                f"replay charged {replayed}")
    cv = np.zeros_like(np.asarray(creport.chunk_version))
    cs = np.zeros_like(np.asarray(creport.chunk_sync))
    cd = np.zeros_like(np.asarray(creport.chunk_dirty))
    for shard, sub in enumerate(broker.brokers):
        arrays = sub.decider.arrays
        for local, d in enumerate(
                broker.config.shard_artifact_indices()[shard]):
            cv[d] = arrays.chunk_version[0, local].cpu().numpy()
            cs[:, d] = arrays.chunk_sync[0, :, local].cpu().numpy()
            cd[d] = arrays.chunk_dirty[0, local].cpu().numpy()
    for label, live, want in (
            ("chunk_version", cv, creport.chunk_version),
            ("chunk_sync", cs, creport.chunk_sync),
            ("chunk_dirty", cd, creport.chunk_dirty)):
        if not np.array_equal(live, want):
            raise oracle.ConformanceError(
                f"assembled sharded {label} diverged from replay:\n"
                f"{live}\nvs\n{want}")
    for sub in broker.brokers:
        for artifact in sub.names:
            canonical = tuple(sub.store.get(artifact))
            if sub.chunks.reassembled(artifact) != canonical:
                raise oracle.ConformanceError(
                    f"chunk index of {artifact!r} does not reassemble "
                    f"to the canonical artifact on its shard")
            if reassemble(split_chunks(
                    canonical, sub.config.chunk_tokens)) != canonical:
                raise oracle.ConformanceError(
                    f"chunk round-trip broke for {artifact!r}")
    return creport


def verify_broker_content(broker, name: str = "service"):
    """Byte-exact content-plane leg of broker verification: the
    captured trace (with its *measured* per-write dirty masks) replays
    through the chunked ACS + kernel + real-payload-store oracle legs
    (``oracle.check_content_trace``), and the live broker's wire-byte
    ledger, chunk state, and content-addressed store must match the
    replay bit-for-bit - including every artifact's chunk index
    reassembling to the canonical whole-artifact copy."""
    from repro_torch.content.chunks import reassemble, split_chunks
    from repro_torch.sim import oracle
    report = oracle.check_content_trace(
        broker.trace.acs_config(), broker.trace.to_oracle_trace(),
        name=f"{name}:content", device=broker.decider.device)
    for field in dataclasses.fields(oracle.ByteLedger):
        live = int(broker.wire[field.name])
        replayed = int(getattr(report.ledger, field.name))
        if live != replayed:
            raise oracle.ConformanceError(
                f"live broker wire.{field.name} = {live} but oracle "
                f"replay charged {replayed}")
    arrays = broker.decider.arrays
    for label, live, want in (
            ("chunk_version", arrays.chunk_version,
             report.chunk_version),
            ("chunk_sync", arrays.chunk_sync, report.chunk_sync),
            ("chunk_dirty", arrays.chunk_dirty, report.chunk_dirty)):
        live = live[0].cpu().numpy()
        if not np.array_equal(live, want):
            raise oracle.ConformanceError(
                f"live {label} diverged from replay:\n{live}\nvs\n"
                f"{want}")
    for d, artifact in enumerate(broker.names):
        canonical = tuple(broker.store.get(artifact))
        rebuilt = broker.chunks.reassembled(artifact)
        if rebuilt != canonical:
            raise oracle.ConformanceError(
                f"chunk index of {artifact!r} does not reassemble to "
                f"the canonical artifact")
        if reassemble(split_chunks(canonical,
                                   broker.config.chunk_tokens)
                      ) != canonical:
            raise oracle.ConformanceError(
                f"chunk round-trip broke for {artifact!r}")
    return report
