"""Artifact Coherence Broker: an asyncio single-writer authority.

The simulator answers "how many tokens would a fleet spend"; this
module answers "serve the fleet".  Many concurrent agent clients issue
read/write requests against a shared artifact store; the broker is the
serialization point (paper A2/AS1): all directory mutation happens on
ONE flush task, so the three verified invariants (SWMR, monotonic
versioning, K-bounded staleness) hold under true asyncio interleaving
by construction - and are *checked* after every micro-batch, not
assumed.

State machinery is reused, not reimplemented:

  * content plane: ``repro_torch.core.protocol``'s ``ArtifactStore`` +
    ``EventBus`` (``VERSION_UPDATE`` messages on every commit) +
    ``TokenLedger`` accounting;
  * decision plane: ``repro_torch.service.batching`` - coalesced
    micro-batches resolved by the simulator's own serialized authority
    pass (``acs.apply_actions_``) or the MESI tick kernel, on a
    directory that lives on the broker's device (``None``: CUDA);
  * audit plane: every decision lands in a ``ServiceTrace``
    (``repro_torch.service.trace``) that replays bit-for-bit through the
    four-way differential oracle, closing the live-service <->
    conformance loop.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import dataclasses
import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.content.chunks import (BYTES_PER_TOKEN, ChunkStore,
                                        diff_chunks)
from repro_torch.core import acs, invariants
from repro_torch.core.protocol import (ArtifactStore, EventBus, Message,
                                       TokenLedger)
from repro_torch.core.states import MESIState
from repro_torch.obs.stats import unified_stats
from repro_torch.obs.telemetry import BatchObservation, Telemetry
from repro_torch.service.batching import BatchDecider
from repro_torch.service.trace import ServiceTrace

_E = int(MESIState.E)

#: strategies the broker serves.  Broadcast is the *baseline* the bench
#: compares against analytically; TTL epochs are defined in terms of the
#: simulator's logical step clock, which a live service does not have.
BROKER_STRATEGIES = ("lazy", "eager", "access_count")


class InvariantViolation(AssertionError):
    """A verified CCS invariant failed on live broker state."""


#: set while ``CoherenceConfig.broker_view()`` constructs the flat view,
#: so only *direct* legacy construction triggers the deprecation shim.
_VIEW_CONSTRUCTION = contextvars.ContextVar("broker_view_construction",
                                            default=False)
_LEGACY_WARNED = False


def _warn_legacy_broker_config() -> None:
    global _LEGACY_WARNED
    if _LEGACY_WARNED:
        return
    _LEGACY_WARNED = True
    warnings.warn(
        "constructing BrokerConfig directly is deprecated: it is now a "
        "thin frozen view over the layered "
        "repro_torch.configs.CoherenceConfig (core -> service -> shard "
        "topology); build one with CoherenceConfig.make(...) and "
        "broker_view().  Direct construction keeps working "
        "(ledgers are byte-identical) but loses the topology layer.",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class BrokerConfig:
    """Static single-authority service parameters (fixed for the
    decider's life).

    Since the layered-config redesign this is a *thin frozen view* over
    ``repro_torch.configs.CoherenceConfig``'s core + service layers - the
    blessed constructors are ``CoherenceConfig.broker_view()`` and
    ``repro_torch.service.connect(...)``.  Direct construction is a
    deprecation shim: it warns once per process and keeps working
    byte-identically."""

    n_agents: int
    artifacts: tuple
    artifact_tokens: int = 4096
    strategy: str = "lazy"
    access_k: int = 8
    max_stale_steps: int = 0       # 0 disables K-staleness enforcement
    batch_window: float = 0.0      # extra coalescing wait (s); 0 = one
                                   # event-loop pass
    max_batch: int = 0             # 0 = up to n_agents requests
    backend: str = "auto"          # decision route: auto | scan | kernel
    check_invariants: bool = True
    #: audit-trace capture.  The trace grows one StepRecord per batch,
    #: so indefinitely-running deployments (the TCP frontend) disable
    #: it; bounded load runs keep it on for oracle replay.
    capture_trace: bool = True
    #: ring-buffer size for per-decision latency samples (stats
    #: percentiles); bounds the broker's memory under open-ended load.
    latency_window: int = 1 << 20
    #: chunk-granular content plane (``repro_torch.content``): with
    #: ``chunk_tokens > 0`` the broker content-addresses every
    #: artifact's chunks, a write's dirty set is *measured* by digest
    #: diff, and a read miss ships only the reader's stale chunks
    #: (``ReadResult.delta``).  0 = whole-artifact payloads.
    chunk_tokens: int = 0
    #: telemetry plane (``repro_torch.obs``): MESI perf counters, span
    #: tracing and the metrics-conformance oracle leg.  Off = the
    #: broker keeps only the ledger/trace it always kept.
    telemetry: bool = True

    def __post_init__(self):
        if not _VIEW_CONSTRUCTION.get():
            _warn_legacy_broker_config()
        if self.strategy not in BROKER_STRATEGIES:
            raise ValueError(
                f"broker serves {BROKER_STRATEGIES}, got "
                f"{self.strategy!r} (broadcast is the baseline, not a "
                f"servable strategy; ttl is simulation-clock-only)")
        if len(set(self.artifacts)) != len(self.artifacts):
            raise ValueError("duplicate artifact ids")
        if self.chunk_tokens > 0:
            if acs.STRATEGY_CODES[
                    self.strategy] not in acs.CONTENT_STRATEGIES:
                raise ValueError(
                    f"chunked broker serves "
                    f"{[acs.STRATEGY_NAMES[s] for s in acs.CONTENT_STRATEGIES]}"
                    f" (delta fetch is pull-only); got "
                    f"{self.strategy!r}")
            if self.max_stale_steps > 0:
                # the byte-exact oracle leg (verify_broker_content)
                # covers max_stale_steps=0 only; allowing the combo
                # would build a broker that can never be verified
                raise ValueError(
                    "chunked broker does not support K-staleness "
                    "enforcement (max_stale_steps > 0): the byte-exact "
                    "content oracle covers the pull-only invalidation "
                    "protocol without revalidation; run either "
                    "chunk_tokens=0 or max_stale_steps=0")

    def acs_config(self, n_steps: int = 1) -> acs.ACSConfig:
        return acs.ACSConfig(
            n_agents=self.n_agents, n_artifacts=len(self.artifacts),
            artifact_tokens=self.artifact_tokens, n_steps=n_steps,
            strategy=acs.STRATEGY_CODES[self.strategy],
            access_k=self.access_k,
            max_stale_steps=self.max_stale_steps,
            chunk_tokens=self.chunk_tokens)

    @classmethod
    def _from_layers(cls, coherence) -> "BrokerConfig":
        """The blessed view constructor (``CoherenceConfig.broker_view``
        calls this); suppresses the legacy-construction warning."""
        token = _VIEW_CONSTRUCTION.set(True)
        try:
            return cls(
                n_agents=coherence.n_agents,
                artifacts=tuple(coherence.artifacts),
                artifact_tokens=coherence.core.artifact_tokens,
                strategy=coherence.core.strategy,
                access_k=coherence.core.access_k,
                max_stale_steps=coherence.core.max_stale_steps,
                batch_window=coherence.service.batch_window,
                max_batch=coherence.service.max_batch,
                backend=coherence.service.backend,
                check_invariants=coherence.service.check_invariants,
                capture_trace=coherence.service.capture_trace,
                latency_window=coherence.service.latency_window,
                chunk_tokens=coherence.core.chunk_tokens,
                telemetry=coherence.service.telemetry)
        finally:
            _VIEW_CONSTRUCTION.reset(token)

    def coherence_config(self):
        """Lift this flat view back into the layered config (trivial
        topology)."""
        from repro_torch.configs.coherence import from_broker_fields
        return from_broker_fields(
            self.n_agents, self.artifacts,
            artifact_tokens=self.artifact_tokens, strategy=self.strategy,
            access_k=self.access_k, max_stale_steps=self.max_stale_steps,
            batch_window=self.batch_window, max_batch=self.max_batch,
            backend=self.backend,
            check_invariants=self.check_invariants,
            capture_trace=self.capture_trace,
            latency_window=self.latency_window,
            chunk_tokens=self.chunk_tokens,
            telemetry=self.telemetry)


class ReadResult(NamedTuple):
    content: tuple
    version: int
    hit: bool            # False = coherence fill (tokens were charged)
    latency_s: float
    #: chunked brokers only: the actual delta payload of a miss -
    #: ((chunk_idx, chunk_tokens), ...) covering exactly the reader's
    #: stale chunks (empty tuple on a hit; ``None`` when the content
    #: plane is off).  ``content`` is always the full authority copy;
    #: ``repro_torch.content.apply_delta(prev, delta, chunk_tokens)`` patched
    #: onto any previously-held copy reproduces it byte-for-byte.
    delta: tuple | None = None
    #: wire bytes this read cost under delta coherence (-1 when off)
    delta_bytes: int = -1


class WriteResult(NamedTuple):
    version: int
    latency_s: float
    #: chunked brokers only: chunks this commit actually dirtied
    #: (measured by content-address diff; ``None`` when off)
    dirty_chunks: tuple | None = None


@dataclasses.dataclass
class _Request:
    agent: int
    artifact: int
    is_write: bool
    content: Optional[tuple]
    future: asyncio.Future
    t_submit: float


class CoherenceBroker:
    """The single-writer directory service.

    Use as an async context manager::

        async with CoherenceBroker(cfg) as broker:
            await broker.read(agent=0, artifact="plan")
    """

    def __init__(self, config: BrokerConfig,
                 contents: Optional[Dict[str, Sequence[int]]] = None,
                 *, on_commit: Optional[Callable] = None,
                 device=None, telemetry: Optional[Telemetry] = None,
                 shard: int = 0) -> None:
        if hasattr(config, "broker_view"):   # layered CoherenceConfig
            if not config.topology.trivial:
                raise ValueError(
                    "CoherenceBroker is the single-authority shard; "
                    "non-trivial topologies need the sharded authority "
                    "plane, which repro_torch does not have yet")
            config = config.broker_view()
        self.config = config
        self.names = tuple(config.artifacts)
        self._index = {a: d for d, a in enumerate(self.names)}
        self.acs_config = config.acs_config()
        self.decider = BatchDecider(self.acs_config, config.backend,
                                    device=device)
        #: called as ``on_commit(broker, commit)`` after every committed
        #: micro-batch (the sharded authority plane uses this to build
        #: the globally-sequenced trace)
        self._on_commit = on_commit
        #: decision-plane busy time: seconds spent inside the decider
        #: (the serialized per-authority bottleneck the shard-capacity
        #: metric is built on)
        self.decide_busy_s = 0.0
        #: shard label this authority stamps on its metrics (the
        #: sharded plane passes its shard id; standalone brokers are
        #: shard 0 - the same label the conformance replay uses)
        self.shard = int(shard)
        #: the telemetry plane handle (None = disabled).  A sharded
        #: deployment hands ONE shared ``Telemetry`` to every
        #: sub-broker; a standalone broker builds its own.
        self.telemetry: Optional[Telemetry] = telemetry
        if self.telemetry is None and config.telemetry:
            self.telemetry = Telemetry(
                config.n_agents, strategy=config.strategy,
                backend=self.decider.backend)
        self.bus = EventBus()
        self.store = ArtifactStore()
        for name in self.names:
            content = (contents or {}).get(
                name, list(range(config.artifact_tokens)))
            if len(content) != config.artifact_tokens:
                raise ValueError(
                    f"artifact {name!r} content length {len(content)} != "
                    f"artifact_tokens {config.artifact_tokens} (the "
                    f"broker's accounting is fixed-slot, like the "
                    f"simulator's)")
            self.store.put(name, list(content))
        self.chunks: Optional[ChunkStore] = None
        if config.chunk_tokens > 0:
            self.chunks = ChunkStore(self.store, config.chunk_tokens)
            for name in self.names:
                self.chunks.register(name)
        #: bytes-on-wire ledger (content plane; all zero when off)
        self.wire = {"delta_bytes": 0, "full_bytes": 0,
                     "n_chunks_fetched": 0}
        self.ledger = TokenLedger()
        self.trace = ServiceTrace.for_broker(config)
        self.latencies = collections.deque(maxlen=config.latency_window)
        self.n_batches = 0
        self._pending: list = []
        self._wake = asyncio.Event()
        self._flusher_task: Optional[asyncio.Task] = None
        self._closed = False

    # ------------------------------------------------------- lifecycle
    async def start(self) -> "CoherenceBroker":
        if self._flusher_task is None:
            self._flusher_task = asyncio.get_running_loop().create_task(
                self._flusher())
        return self

    async def stop(self) -> None:
        self._closed = True
        self._wake.set()
        if self._flusher_task is not None:
            await self._flusher_task
            self._flusher_task = None

    async def __aenter__(self) -> "CoherenceBroker":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # ------------------------------------------------------ client API
    def artifact_index(self, artifact: str) -> int:
        try:
            return self._index[artifact]
        except KeyError:
            raise KeyError(
                f"unknown artifact {artifact!r}; registered: "
                f"{list(self.names)}") from None

    async def read(self, agent: int, artifact: str) -> ReadResult:
        """Consume an artifact: zero tokens when the agent's coherent
        copy is valid, a full fetch otherwise."""
        return await self._submit(agent, artifact, False, None)

    async def write(self, agent: int, artifact: str,
                    content: Optional[Sequence[int]] = None
                    ) -> WriteResult:
        """Read-modify-write through the authority (upgrade -> commit).
        ``content=None`` commits a same-size revision of the current
        canonical content (pointer-semantics update)."""
        if content is not None:
            content = tuple(content)
            if len(content) != self.config.artifact_tokens:
                raise ValueError(
                    f"write of {len(content)} tokens to fixed "
                    f"{self.config.artifact_tokens}-token artifact slot")
        return await self._submit(agent, artifact, True, content)

    def _submit(self, agent: int, artifact: str, is_write: bool,
                content) -> asyncio.Future:
        if self._closed:
            raise RuntimeError("broker is stopped")
        if not 0 <= agent < self.config.n_agents:
            raise ValueError(f"agent {agent} outside [0, "
                             f"{self.config.n_agents})")
        if self._flusher_task is None:
            raise RuntimeError("broker not started - use "
                               "`async with CoherenceBroker(...)` or "
                               "await broker.start()")
        fut = asyncio.get_running_loop().create_future()
        self._pending.append(_Request(
            agent=agent, artifact=self.artifact_index(artifact),
            is_write=is_write, content=content, future=fut,
            t_submit=time.perf_counter()))
        self._wake.set()
        return fut

    # --------------------------------------------------------- flusher
    async def _flusher(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            if self._closed and not self._pending:
                return
            if self.config.batch_window > 0:
                await asyncio.sleep(self.config.batch_window)
            else:
                # one event-loop pass: every already-scheduled client
                # coroutine gets to enqueue before the batch is cut.
                await asyncio.sleep(0)
            while self._pending:
                self._flush_once()
                if self._pending:       # same-agent conflict spillover
                    await asyncio.sleep(0)
            if self._closed:
                return

    def _cut_batch(self) -> list:
        """Drain pending FIFO into a micro-batch: at most one request
        per agent (a batch is one serialized authority pass; a second
        request from the same agent belongs to the next pass)."""
        max_batch = self.config.max_batch or self.config.n_agents
        batch, rest, seen = [], [], set()
        for req in self._pending:
            if req.agent in seen or len(batch) >= max_batch:
                rest.append(req)
            else:
                seen.add(req.agent)
                batch.append(req)
        self._pending = rest
        return batch

    def _flush_once(self) -> None:
        batch = self._cut_batch()
        if not batch:
            return
        try:
            self._decide_and_resolve(batch)
        except Exception as e:       # noqa: BLE001 - fail the batch, not
            for req in batch:        # the event loop
                if not req.future.done():
                    req.future.set_exception(e)

    def _measure_write_masks(self, batch: list) -> Optional[np.ndarray]:
        """(n, C) measured dirty chunk masks for the batch's writes.

        Masks are diffed *sequentially in the authority's agent order*
        against the content each write will actually see at its
        serialization slot (two same-batch writers of one artifact:
        the second diffs against the first's content, exactly as the
        commits apply below)."""
        if self.chunks is None:
            return None
        n = self.config.n_agents
        masks = np.zeros((n, self.chunks.n_chunks_of(self.names[0])),
                         bool)
        pending: Dict[str, list] = {}
        for req in sorted(batch, key=lambda r: r.agent):
            if not req.is_write:
                continue
            name = self.names[req.artifact]
            cur = pending.get(name)
            if cur is None:
                cur = list(self.store.get(name))
            new = (list(req.content) if req.content is not None
                   else cur)
            masks[req.agent] = diff_chunks(cur, new,
                                           self.config.chunk_tokens)
            pending[name] = new
        return masks

    def _decide_and_resolve(self, batch: list) -> None:
        n = self.config.n_agents
        acts = np.zeros(n, bool)
        arts = np.zeros(n, np.int32)
        writes = np.zeros(n, bool)
        for req in batch:
            acts[req.agent] = True
            arts[req.agent] = req.artifact
            writes[req.agent] = req.is_write
        wmasks = self._measure_write_masks(batch)

        tel = self.telemetry
        state_before = (self.decider.host_state.copy()
                        if tel is not None else None)
        queue_depth = len(batch) + len(self._pending)
        ver_before = self.decider.host_version.astype(np.int64)
        t_decide = time.perf_counter()
        decision = self.decider.decide(acts, arts, writes,
                                       write_chunks=wmasks)
        busy_s = time.perf_counter() - t_decide
        self.decide_busy_s += busy_s
        ver_after = self.decider.host_version.astype(np.int64)

        if self.config.check_invariants:
            self._check_invariants(batch, ver_before, ver_after)

        # ledger: exact integer deltas from the decision engine
        for field, delta in decision.ledger_delta.items():
            setattr(self.ledger, field,
                    getattr(self.ledger, field) + delta)
        if decision.wire_delta is not None:
            for field, delta in decision.wire_delta.items():
                self.wire[field] += delta

        # content plane + responses, in the authority's agent order
        # (reads at slot a see commits from slots < a, exactly the
        # order the decision plane serialized)
        now = time.perf_counter()
        latencies = {}
        for req in sorted(batch, key=lambda r: r.agent):
            name = self.names[req.artifact]
            version = int(decision.version[req.agent])
            latency = now - req.t_submit
            latencies[req.agent] = latency
            self.latencies.append(latency)
            if req.is_write:
                content = (list(req.content) if req.content is not None
                           else list(self.store.get(name)))
                dirty = None
                if self.chunks is not None:
                    self.chunks.put(name, content)
                    dirty = tuple(np.flatnonzero(wmasks[req.agent])
                                  .tolist())
                else:
                    self.store.put(name, content)
                self.bus.publish(Message(
                    "VERSION_UPDATE", f"agent-{req.agent}", name,
                    version, timestamp=now))
                req.future.set_result(WriteResult(version, latency,
                                                  dirty_chunks=dirty))
            else:
                delta = None
                delta_bytes = -1
                if self.chunks is not None:
                    fetched = np.flatnonzero(
                        decision.fetched_chunks[req.agent])
                    delta = self.chunks.delta(name, fetched)
                    delta_bytes = 0
                    if decision.miss[req.agent]:
                        delta_bytes = (sum(len(c) for _, c in delta)
                                       + acs.SIGNAL_TOKENS
                                       ) * BYTES_PER_TOKEN
                req.future.set_result(ReadResult(
                    tuple(self.store.get(name)), version,
                    hit=not bool(decision.miss[req.agent]),
                    latency_s=latency, delta=delta,
                    delta_bytes=delta_bytes))
        self.n_batches += 1
        if self.config.capture_trace:
            self.trace.append_step(acts, arts, writes, decision.miss,
                                   decision.version, latencies,
                                   write_chunks=wmasks,
                                   decide_s=busy_s,
                                   batch_size=len(batch))
        if tel is not None:
            tel.record_batch(BatchObservation(
                names=self.names, acts=acts, arts=arts, writes=writes,
                miss=np.asarray(decision.miss, bool),
                version=np.asarray(decision.version, np.int64),
                ledger_delta=decision.ledger_delta,
                state_before=state_before,
                state_after=self.decider.host_state,
                ver_after=ver_after,
                wire_delta=decision.wire_delta,
                shard=self.shard, live=True, busy_s=busy_s,
                route=self.decider.backend, queue_depth=queue_depth,
                t_decide=t_decide, t_respond=now,
                t_submits={req.agent: req.t_submit for req in batch},
                latencies=latencies))
        if self._on_commit is not None:
            self._on_commit(self, {
                "acts": acts, "arts": arts, "writes": writes,
                "miss": decision.miss, "version": decision.version,
                "latencies": latencies, "write_chunks": wmasks,
                "busy_s": busy_s})

    # ------------------------------------------------------ invariants
    def _check_invariants(self, batch, ver_before, ver_after) -> None:
        state = self.decider.host_state
        if not invariants.single_writer(state):
            raise InvariantViolation(
                f"SWMR violated: two M holders\n{state}")
        if not invariants.exclusive_means_alone(state):
            raise InvariantViolation(
                f"exclusivity violated\n{state}")
        if (state >= _E).any():
            raise InvariantViolation(
                f"E/M persisted past a committed batch\n{state}")
        if not invariants.monotonic_version(ver_before, ver_after):
            raise InvariantViolation(
                f"version regressed: {ver_before} -> {ver_after}")
        bumps = np.zeros(len(self.names), np.int64)
        for req in batch:
            if req.is_write:
                bumps[req.artifact] += 1
        if not np.array_equal(ver_after - ver_before, bumps):
            raise InvariantViolation(
                f"version bump mismatch: delta {ver_after - ver_before}"
                f" vs writes {bumps}")
        if self.config.max_stale_steps > 0:
            consumed = int(self.decider.metrics.max_consumed_staleness)
            if consumed > self.config.max_stale_steps:
                raise InvariantViolation(
                    f"K-staleness violated: served a hit "
                    f"{consumed} action-steps stale "
                    f"(K={self.config.max_stale_steps})")

    # ----------------------------------------------------------- stats
    @property
    def directory_state(self) -> np.ndarray:
        """(n_agents, n_artifacts) MESI matrix, as of the last batch."""
        return self.decider.host_state.copy()

    @property
    def versions(self) -> np.ndarray:
        return self.decider.host_version.copy()

    def stats(self) -> dict:
        """The unified stats mapping (``repro_torch.obs.stats``): canonical
        nested schema plus the legacy flat aliases as a deprecation
        shim."""
        return unified_stats(self)
