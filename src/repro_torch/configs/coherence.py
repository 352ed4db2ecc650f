"""Layered coherence configuration: ONE config surface for the
protocol core, the service plane, and the shard topology.

Before this module, ``repro_torch.core.acs.ACSConfig`` and
``repro_torch.service.BrokerConfig`` had drifted into duplicated fields
(``chunk_tokens``, the staleness bound, strategy knobs) that had to be
kept in sync by hand.  :class:`CoherenceConfig` is now the single
source of truth, layered the way the system is layered:

  ``core``      protocol knobs every layer shares (strategy, artifact
                slot size, access-count K, staleness bound, chunk
                granularity) - projects onto ``ACSConfig``;
  ``service``   broker-plane knobs (batching window, decision backend,
                invariant checks, trace capture) - only the live
                service reads these;
  ``topology``  shard/host placement (K authority shards, per-host L1
                directories) - only the sharded authority plane reads
                these.

``BrokerConfig`` survives as a *thin frozen view* over the first two
layers (``CoherenceConfig.broker_view()``); constructing it directly
still works but warns once per process (deprecation shim - golden
ledgers stay byte-identical either way).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

from repro_torch.core import acs


def shard_of_artifact(name: str, n_shards: int) -> int:
    """Stable hash-of-artifact shard routing (crc32, never Python's
    randomized ``hash``): the same artifact maps to the same authority
    shard in every process, so captured traces replay anywhere."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(str(name).encode("utf-8")) % n_shards


@dataclasses.dataclass(frozen=True)
class CoherenceCore:
    """Protocol-core layer (projects onto ``acs.ACSConfig``)."""

    artifact_tokens: int = 4096
    strategy: str = "lazy"
    access_k: int = 8
    max_stale_steps: int = 0     # 0 disables K-staleness enforcement
    chunk_tokens: int = 0        # 0 = whole-artifact payloads

    def __post_init__(self):
        if self.strategy not in acs.STRATEGY_CODES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; known: "
                f"{sorted(acs.STRATEGY_CODES)}")
        if self.artifact_tokens <= 0:
            raise ValueError("artifact_tokens must be positive")


@dataclasses.dataclass(frozen=True)
class ServiceLayer:
    """Service-plane layer (the asyncio broker's own knobs)."""

    batch_window: float = 0.0    # extra coalescing wait (s)
    max_batch: int = 0           # 0 = up to n_agents requests
    backend: str = "auto"        # decision route: auto | scan | kernel
    check_invariants: bool = True
    capture_trace: bool = True
    latency_window: int = 1 << 20
    #: the telemetry plane (``repro_torch.obs``): MESI perf counters, span
    #: tracing and the metrics-conformance oracle leg.  Off = the
    #: broker records nothing beyond the ledger/trace it always kept
    #: (the overhead bench measures the difference).
    telemetry: bool = True


@dataclasses.dataclass(frozen=True)
class ShardTopology:
    """Authority-plane topology: K directory shards + per-host L1s.

    ``n_shards``  partition the directory by artifact across K broker
                  shards (``shard_of_artifact``; SWMR survives sharding
                  because exclusivity is per-artifact).
    ``n_hosts``   L1 placement domains: agents map onto hosts
                  (round-robin unless ``placement`` pins them) and each
                  host keeps an L1 directory caching (version, chunk
                  versions, content) in front of the L2 authority, so
                  same-host agents exchange deltas without a
                  cross-shard hop.  1 = no L1 plane.
    ``placement``       optional explicit agent -> host map.
    ``assignment``      optional explicit artifact-index -> shard map
                        (defaults to hash routing).
    ``l1_max_version_lag``  invariant bound: a *valid* L1 entry may
                  never be observed more than this many versions behind
                  the authority (the L1-invalidation path keeps it at
                  0); a violation raises ``InvariantViolation``.
    """

    n_shards: int = 1
    n_hosts: int = 1
    placement: Tuple[int, ...] = ()
    assignment: Tuple[int, ...] = ()
    l1_max_version_lag: int = 0

    def __post_init__(self):
        if self.n_shards < 1 or self.n_hosts < 1:
            raise ValueError("n_shards and n_hosts must be >= 1")
        if self.l1_max_version_lag < 0:
            raise ValueError("l1_max_version_lag must be >= 0")
        if any(s < 0 or s >= self.n_shards for s in self.assignment):
            raise ValueError(
                f"assignment entries must be in [0, {self.n_shards})")
        if any(h < 0 or h >= self.n_hosts for h in self.placement):
            raise ValueError(
                f"placement entries must be in [0, {self.n_hosts})")

    @property
    def trivial(self) -> bool:
        """True when the topology collapses to the single-broker,
        no-L1 deployment (the pre-sharding behavior)."""
        return self.n_shards == 1 and self.n_hosts == 1

    def shard_of(self, artifact_index: int, artifact_name: str) -> int:
        if self.assignment:
            return int(self.assignment[artifact_index])
        return shard_of_artifact(artifact_name, self.n_shards)

    def host_of(self, agent: int) -> int:
        if self.placement:
            return int(self.placement[agent])
        return int(agent) % self.n_hosts


_CORE_FIELDS = {f.name for f in dataclasses.fields(CoherenceCore)}
_SERVICE_FIELDS = {f.name for f in dataclasses.fields(ServiceLayer)}
_TOPOLOGY_FIELDS = {f.name for f in dataclasses.fields(ShardTopology)}
#: flat-kwarg aliases accepted by :meth:`CoherenceConfig.make`
_ALIASES = {"shards": "n_shards", "hosts": "n_hosts"}


@dataclasses.dataclass(frozen=True)
class CoherenceConfig:
    """The layered config: core -> service -> shard topology."""

    n_agents: int
    artifacts: Tuple[str, ...]
    core: CoherenceCore = CoherenceCore()
    service: ServiceLayer = ServiceLayer()
    topology: ShardTopology = ShardTopology()

    def __post_init__(self):
        object.__setattr__(self, "artifacts", tuple(self.artifacts))
        if self.n_agents < 1:
            raise ValueError("n_agents must be >= 1")
        if len(set(self.artifacts)) != len(self.artifacts):
            raise ValueError("duplicate artifact ids")
        if self.topology.assignment and len(
                self.topology.assignment) != len(self.artifacts):
            raise ValueError(
                f"assignment covers {len(self.topology.assignment)} "
                f"artifacts but {len(self.artifacts)} are registered")
        if self.topology.placement and len(
                self.topology.placement) != self.n_agents:
            raise ValueError(
                f"placement covers {len(self.topology.placement)} "
                f"agents but n_agents={self.n_agents}")
        if self.topology.n_shards > 1 and self.core.max_stale_steps > 0:
            # per-shard action clocks diverge from the global clock, so
            # simulator-style K-staleness is not well-defined across
            # shards; the L1 plane carries its own version-lag bound.
            raise ValueError(
                "sharded authority does not support simulator "
                "K-staleness (max_stale_steps > 0); bound L1 staleness "
                "with topology.l1_max_version_lag instead")

    # ------------------------------------------------------ construction
    @classmethod
    def make(cls, n_agents: int, artifacts, **knobs) -> "CoherenceConfig":
        """Build a layered config from flat kwargs, routing each knob
        to its layer by field name (``shards``/``hosts`` are accepted
        as aliases for ``n_shards``/``n_hosts``)."""
        core_kw, svc_kw, topo_kw = {}, {}, {}
        for key, value in knobs.items():
            name = _ALIASES.get(key, key)
            if name in _CORE_FIELDS:
                core_kw[name] = value
            elif name in _SERVICE_FIELDS:
                svc_kw[name] = value
            elif name in _TOPOLOGY_FIELDS:
                topo_kw[name] = value
            else:
                raise TypeError(
                    f"unknown coherence knob {key!r}; core fields: "
                    f"{sorted(_CORE_FIELDS)}, service: "
                    f"{sorted(_SERVICE_FIELDS)}, topology: "
                    f"{sorted(_TOPOLOGY_FIELDS)}")
        return cls(n_agents=n_agents, artifacts=tuple(artifacts),
                   core=CoherenceCore(**core_kw),
                   service=ServiceLayer(**svc_kw),
                   topology=ShardTopology(**topo_kw))

    # ----------------------------------------------------- flat core view
    # Read-only pass-throughs so code holding a broker handle can read
    # the cost-model knobs without caring which config flavor (flat
    # BrokerConfig vs layered) the topology handed it.

    @property
    def artifact_tokens(self) -> int:
        return self.core.artifact_tokens

    @property
    def strategy(self) -> str:
        return self.core.strategy

    @property
    def access_k(self) -> int:
        return self.core.access_k

    @property
    def max_stale_steps(self) -> int:
        return self.core.max_stale_steps

    @property
    def chunk_tokens(self) -> int:
        return self.core.chunk_tokens

    # ------------------------------------------------------- projections
    def acs_config(self, n_steps: int = 1) -> acs.ACSConfig:
        """Project the core layer onto the simulator's static config."""
        return acs.ACSConfig(
            n_agents=self.n_agents, n_artifacts=len(self.artifacts),
            artifact_tokens=self.core.artifact_tokens, n_steps=n_steps,
            strategy=acs.STRATEGY_CODES[self.core.strategy],
            access_k=self.core.access_k,
            max_stale_steps=self.core.max_stale_steps,
            chunk_tokens=self.core.chunk_tokens)

    def broker_view(self):
        """The flat frozen ``BrokerConfig`` view of the core + service
        layers (what a single broker shard consumes).  Constructed
        through the blessed path, so no deprecation warning fires."""
        from repro_torch.service.broker import BrokerConfig
        return BrokerConfig._from_layers(self)

    # ---------------------------------------------------------- topology
    def shard_of(self, artifact_index: int) -> int:
        return self.topology.shard_of(
            artifact_index, self.artifacts[artifact_index])

    def artifact_shards(self) -> Tuple[int, ...]:
        """Per-artifact shard id, in artifact-index order."""
        return tuple(self.shard_of(d) for d in range(len(self.artifacts)))

    def shard_artifact_indices(self) -> Tuple[Tuple[int, ...], ...]:
        """Global artifact indices owned by each shard (len n_shards;
        shards with no artifacts get an empty tuple)."""
        owned = [[] for _ in range(self.topology.n_shards)]
        for d, s in enumerate(self.artifact_shards()):
            owned[s].append(d)
        return tuple(tuple(o) for o in owned)

    def shard_view(self, shard: int) -> "CoherenceConfig":
        """The single-shard CoherenceConfig a sub-broker runs with
        (that shard's artifacts only, trivial topology)."""
        cols = self.shard_artifact_indices()[shard]
        return dataclasses.replace(
            self, artifacts=tuple(self.artifacts[d] for d in cols),
            topology=ShardTopology())


def from_broker_fields(n_agents: int, artifacts, *, artifact_tokens,
                       strategy, access_k, max_stale_steps, batch_window,
                       max_batch, backend, check_invariants,
                       capture_trace, latency_window, chunk_tokens,
                       telemetry: bool = True,
                       topology: Optional[ShardTopology] = None,
                       ) -> CoherenceConfig:
    """Lift legacy flat ``BrokerConfig`` fields into the layered config
    (the deprecation shim's upgrade path)."""
    return CoherenceConfig(
        n_agents=n_agents, artifacts=tuple(artifacts),
        core=CoherenceCore(
            artifact_tokens=artifact_tokens, strategy=strategy,
            access_k=access_k, max_stale_steps=max_stale_steps,
            chunk_tokens=chunk_tokens),
        service=ServiceLayer(
            batch_window=batch_window, max_batch=max_batch,
            backend=backend, check_invariants=check_invariants,
            capture_trace=capture_trace, latency_window=latency_window,
            telemetry=telemetry),
        topology=topology or ShardTopology())
