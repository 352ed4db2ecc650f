"""CCS v0.1 message-level protocol implementation (paper SS5, SS7).

Four entities: CoordinatorService (authority), AgentRuntime (per-agent
cache + protocol client), EventBus (invalidations / version updates),
ArtifactStore (canonical content).  This is the control-plane that a real
deployment runs beside the JAX data plane; messages carry metadata and
artifact token payloads, never tensors.

Token accounting uses the same constants as the vectorized simulator
(``repro.core.acs``): a cache-miss fetch costs ``len(content) + 12``
tokens, every invalidation/validation signal costs 12, an eager push
costs ``len(content) + 12``.  ``tests/test_protocol.py`` drives this
implementation and the vectorized simulator with identical action traces
and asserts the ledgers agree exactly.

Beyond the paper: ``ShardedCoordinator`` partitions the artifact
namespace over multiple authority shards (directory-based coherence,
paper SS10 "Centralized authority service" future work).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.lease import LeaseTable
from repro_torch.core.states import MESIState
from repro_torch.core.clock import MonotonicVersioner, VectorClock

SIGNAL_TOKENS = 12

I, S, E, M = (MESIState.I, MESIState.S, MESIState.E, MESIState.M)


# ----------------------------- messages -------------------------------

_msg_counter = itertools.count()


@dataclasses.dataclass
class Message:
    """Common envelope (paper SS5.4)."""

    type: str
    agent_id: str
    artifact_id: str
    version: int
    payload: Any = None
    timestamp: float = 0.0
    msg_id: int = dataclasses.field(default_factory=lambda: next(_msg_counter))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TokenLedger:
    fetch_tokens: int = 0
    push_tokens: int = 0
    signal_tokens: int = 0
    n_fetches: int = 0
    n_hits: int = 0
    n_reads: int = 0
    n_writes: int = 0
    n_invalidation_signals: int = 0

    @property
    def total_tokens(self) -> int:
        return self.fetch_tokens + self.push_tokens + self.signal_tokens

    def merge(self, other: "TokenLedger") -> "TokenLedger":
        return TokenLedger(*[a + b for a, b in
                             zip(dataclasses.astuple(self),
                                 dataclasses.astuple(other))])


# ----------------------------- event bus ------------------------------

class EventBus:
    """Async pub/sub with at-least-once delivery semantics (AS2).

    ``duplicate_every``: deliver every k-th event twice, to exercise the
    idempotency requirement in tests.  ``deliver_immediately=False``
    queues events until ``flush()`` (models bus latency).
    """

    def __init__(self, deliver_immediately: bool = True,
                 duplicate_every: int = 0) -> None:
        self._subs: Dict[str, List[Callable[[Message], None]]] = {}
        self._queue: List[Message] = []
        self.deliver_immediately = deliver_immediately
        self.duplicate_every = duplicate_every
        self._published = 0

    def subscribe(self, agent_id: str,
                  handler: Callable[[Message], None]) -> None:
        self._subs.setdefault(agent_id, []).append(handler)

    def publish(self, msg: Message,
                targets: Optional[Sequence[str]] = None) -> None:
        self._published += 1
        copies = 1
        if self.duplicate_every and self._published % self.duplicate_every == 0:
            copies = 2  # at-least-once: duplicated delivery
        for _ in range(copies):
            for agent_id, handlers in self._subs.items():
                if targets is not None and agent_id not in targets:
                    continue
                for h in handlers:
                    if self.deliver_immediately:
                        h(msg)
                    else:
                        self._queue.append(msg)

    def flush(self) -> None:
        queue, self._queue = self._queue, []
        for msg in queue:
            for handlers in self._subs.values():
                for h in handlers:
                    h(msg)


# --------------------------- artifact store ---------------------------

class ArtifactStore:
    """Canonical artifact versions; serves fetch requests."""

    def __init__(self) -> None:
        self._content: Dict[str, Sequence[int]] = {}

    def put(self, artifact_id: str, content: Sequence[int]) -> None:
        self._content[artifact_id] = content

    def get(self, artifact_id: str) -> Sequence[int]:
        return self._content[artifact_id]

    def token_len(self, artifact_id: str) -> int:
        return len(self._content[artifact_id])


# ----------------------------- authority ------------------------------

@dataclasses.dataclass
class DirectoryEntry:
    version: int = 1
    last_writer: Optional[str] = None
    states: Dict[str, MESIState] = dataclasses.field(default_factory=dict)


class CoordinatorService:
    """Authority service: global artifact directory + serialization point.

    All writes to an artifact serialize through here (assumption A2 /
    AS1); Exclusive grants carry a lease (SS5.2) so an agent crash in M
    state cannot permanently orphan the artifact.
    """

    def __init__(self, bus: EventBus, store: ArtifactStore,
                 lease_ttl: float = LeaseTable.DEFAULT_TTL,
                 strategy: str = "lazy") -> None:
        assert strategy in ("lazy", "eager", "access_count", "ttl")
        self.bus = bus
        self.store = store
        self.strategy = strategy
        self.directory: Dict[str, DirectoryEntry] = {}
        self.versioner = MonotonicVersioner()
        self.leases = LeaseTable(lease_ttl)
        self.ledger = TokenLedger()
        self.vclock = VectorClock()
        self.now: float = 0.0

    # -- registration ---------------------------------------------------
    def register_artifact(self, artifact_id: str,
                          content: Sequence[int]) -> None:
        self.store.put(artifact_id, content)
        self.directory.setdefault(artifact_id, DirectoryEntry())

    def _entry(self, artifact_id: str) -> DirectoryEntry:
        return self.directory[artifact_id]

    def agent_state(self, agent_id: str, artifact_id: str) -> MESIState:
        return self._entry(artifact_id).states.get(agent_id, I)

    # -- time / recovery -------------------------------------------------
    def advance(self, now: float) -> List[Message]:
        """Advance the authority clock; recover orphaned M-state leases."""
        self.now = now
        recovered = []
        for lease in self.leases.collect_expired(now):
            entry = self._entry(lease.artifact_id)
            # revert to last committed version: invalidate EVERYONE,
            # including the (presumed crashed) owner.
            for agent_id in list(entry.states):
                entry.states[agent_id] = I
            msg = Message("LEASE_REVOKED", lease.agent_id,
                          lease.artifact_id, entry.version,
                          timestamp=now)
            self.bus.publish(msg)
            recovered.append(msg)
        return recovered

    # -- protocol operations (SS5.3) --------------------------------------
    def read_request(self, agent_id: str, artifact_id: str
                     ) -> tuple[Sequence[int], int]:
        """READ_REQUEST / FETCH_REQUEST: respond with content+version."""
        entry = self._entry(artifact_id)
        content = self.store.get(artifact_id)
        entry.states[agent_id] = S
        self.ledger.fetch_tokens += len(content) + SIGNAL_TOKENS
        self.ledger.n_fetches += 1
        return content, entry.version

    def validate(self, agent_id: str, artifact_id: str,
                 cached_version: int) -> bool:
        """Staleness check round-trip: True iff cached version current."""
        self.ledger.signal_tokens += SIGNAL_TOKENS
        return self._entry(artifact_id).version == cached_version

    def upgrade_request(self, agent_id: str, artifact_id: str
                        ) -> tuple[bool, List[str]]:
        """UPGRADE_REQUEST: invalidate peers, grant E, start lease."""
        entry = self._entry(artifact_id)
        if self.leases.holder(artifact_id) not in (None, agent_id):
            return False, []  # someone else holds the write lease
        invalidated = []
        for peer, st in entry.states.items():
            if peer != agent_id and st != I:
                entry.states[peer] = I
                invalidated.append(peer)
                self.bus.publish(Message(
                    "INVALIDATE", agent_id, artifact_id, entry.version,
                    timestamp=self.now), targets=[peer])
        self.ledger.signal_tokens += SIGNAL_TOKENS * len(invalidated)
        self.ledger.n_invalidation_signals += len(invalidated)
        entry.states[agent_id] = E
        if self.leases.holder(artifact_id) is None:
            self.leases.grant(agent_id, artifact_id, self.now)
        return True, invalidated

    def commit(self, agent_id: str, artifact_id: str,
               content: Sequence[int],
               push_targets: Optional[Sequence[str]] = None) -> int:
        """COMMIT: store canonical version, writer -> S, publish update.

        Under the eager strategy the authority pushes the fresh content
        to ``push_targets`` (the active sharers at upgrade time),
        pre-populating their caches (SS8.8).
        """
        entry = self._entry(artifact_id)
        if self.leases.holder(artifact_id) != agent_id:
            raise RuntimeError(
                f"commit from {agent_id!r} without lease on {artifact_id!r}"
                " (lease expired? write is lost, re-fetch and re-apply)")
        new_version = self.versioner.bump(artifact_id)
        entry.version = new_version
        entry.last_writer = agent_id
        entry.states[agent_id] = S
        self.store.put(artifact_id, content)
        self.vclock = self.vclock.tick(agent_id)
        self.leases.release(agent_id, artifact_id)
        self.ledger.n_writes += 1
        if self.strategy == "eager" and push_targets:
            for peer in push_targets:
                entry.states[peer] = S
                self.bus.publish(Message(
                    "PUSH", agent_id, artifact_id, new_version,
                    payload=content, timestamp=self.now), targets=[peer])
                self.ledger.push_tokens += len(content) + SIGNAL_TOKENS
        else:
            self.bus.publish(Message(
                "VERSION_UPDATE", agent_id, artifact_id, new_version,
                timestamp=self.now))
        return new_version


class ShardedCoordinator:
    """Directory-sharded authority (beyond-paper, SS10 extension).

    Artifact namespace is hash-partitioned across ``n_shards``
    coordinators; each artifact has a single home shard, so SWMR and
    monotonicity hold per-artifact exactly as in the single-authority
    case (no cross-shard writes exist by construction)."""

    def __init__(self, n_shards: int, bus: EventBus, store: ArtifactStore,
                 strategy: str = "lazy") -> None:
        self.shards = [CoordinatorService(bus, store, strategy=strategy)
                       for _ in range(n_shards)]

    def shard_of(self, artifact_id: str) -> CoordinatorService:
        h = int(hashlib.sha1(artifact_id.encode()).hexdigest(), 16)
        return self.shards[h % len(self.shards)]

    def register_artifact(self, artifact_id, content):
        self.shard_of(artifact_id).register_artifact(artifact_id, content)

    def __getattr__(self, name):
        # route single-artifact ops by artifact_id (2nd positional arg)
        def route(agent_id, artifact_id, *a, **kw):
            return getattr(self.shard_of(artifact_id), name)(
                agent_id, artifact_id, *a, **kw)
        return route

    @property
    def ledger(self) -> TokenLedger:
        total = TokenLedger()
        for s in self.shards:
            total = total.merge(s.ledger)
        return total


# --------------------------- agent runtime ----------------------------

@dataclasses.dataclass
class CacheEntry:
    content: Sequence[int]
    version: int
    state: MESIState
    reads_since_fetch: int = 0
    last_validate_action: int = 0


class AgentRuntime:
    """Per-agent protocol client with a local MESI cache (SS5.2, SS7.1)."""

    def __init__(self, agent_id: str, coordinator, bus: EventBus,
                 strategy: str = "lazy", access_k: int = 8,
                 max_stale_steps: int = 0) -> None:
        self.agent_id = agent_id
        self.coordinator = coordinator
        self.strategy = strategy
        self.access_k = access_k
        self.max_stale_steps = max_stale_steps
        self.cache: Dict[str, CacheEntry] = {}
        self.actions = 0
        self.crashed = False
        bus.subscribe(agent_id, self._on_event)

    # -- event handlers (idempotent, AS2) --------------------------------
    def _on_event(self, msg: Message) -> None:
        if self.crashed:
            return
        entry = self.cache.get(msg.artifact_id)
        if msg.type in ("INVALIDATE", "LEASE_REVOKED"):
            if entry is not None:
                entry.state = I  # re-invalidation is a no-op by design
        elif msg.type == "PUSH":
            self.cache[msg.artifact_id] = CacheEntry(
                msg.payload, msg.version, S,
                last_validate_action=self.actions)
        elif msg.type == "VERSION_UPDATE":
            # Defensive: a valid entry older than the committed version is
            # stale (can occur if a fetch raced an in-flight write lease).
            if (entry is not None and entry.state != I
                    and entry.version < msg.version):
                entry.state = I

    # -- cache freshness --------------------------------------------------
    def _fresh(self, entry: Optional[CacheEntry]) -> bool:
        if entry is None or entry.state == I:
            return False
        if (self.strategy == "access_count"
                and entry.reads_since_fetch >= self.access_k):
            return False
        return True

    def _fill(self, artifact_id: str) -> CacheEntry:
        content, version = self.coordinator.read_request(
            self.agent_id, artifact_id)
        entry = CacheEntry(content, version, S,
                           last_validate_action=self.actions)
        self.cache[artifact_id] = entry
        return entry

    def _ensure_valid(self, artifact_id: str, ledger: TokenLedger
                      ) -> CacheEntry:
        entry = self.cache.get(artifact_id)
        if self._fresh(entry) and self.max_stale_steps > 0:
            staleness = self.actions - entry.last_validate_action
            if staleness > self.max_stale_steps:
                if self.coordinator.validate(self.agent_id, artifact_id,
                                             entry.version):
                    entry.last_validate_action = self.actions
                else:
                    entry.state = I
        if not self._fresh(self.cache.get(artifact_id)):
            return self._fill(artifact_id)
        ledger.n_hits += 1
        return self.cache[artifact_id]

    # -- public API (what the framework adapters call) --------------------
    def read(self, artifact_id: str) -> Sequence[int]:
        """Consume the artifact; zero tokens when the cache is coherent."""
        if self.crashed:
            raise RuntimeError(f"agent {self.agent_id} crashed")
        self.actions += 1
        ledger = self.coordinator.ledger if not isinstance(
            self.coordinator, ShardedCoordinator) else \
            self.coordinator.shard_of(artifact_id).ledger
        entry = self._ensure_valid(artifact_id, ledger)
        entry.reads_since_fetch += 1
        ledger.n_reads += 1
        return entry.content

    def write(self, artifact_id: str,
              new_content: Sequence[int],
              crash_before_commit: bool = False) -> Optional[int]:
        """Read-modify-write: access -> upgrade -> local write -> commit."""
        if self.crashed:
            raise RuntimeError(f"agent {self.agent_id} crashed")
        self.actions += 1
        coord = (self.coordinator.shard_of(artifact_id)
                 if isinstance(self.coordinator, ShardedCoordinator)
                 else self.coordinator)
        entry = self._ensure_valid(artifact_id, coord.ledger)
        granted, invalidated = coord.upgrade_request(
            self.agent_id, artifact_id)
        if not granted:
            return None  # write lease contention; caller retries
        entry.state = E
        # local write: E -> M, zero tokens (SS5.3 Write)
        entry.state = M
        if crash_before_commit:
            self.crashed = True  # AS3 violation: lease TTL must recover
            return None
        version = coord.commit(
            self.agent_id, artifact_id, new_content,
            push_targets=invalidated if self.strategy == "eager" else None)
        entry.content = new_content
        entry.version = version
        entry.state = S
        entry.reads_since_fetch = 0
        entry.last_validate_action = self.actions
        return version

    def state_of(self, artifact_id: str) -> MESIState:
        entry = self.cache.get(artifact_id)
        return entry.state if entry is not None else I
