"""Sharded authority plane: K directory shards + per-host L1s.

The single-broker authority (``repro_torch.service.broker``) serializes ALL
directory mutation through one flush task.  That is the correctness
anchor - and the scaling bottleneck: every fleet in the building funnels
through one decider.  This module partitions the authority **by
artifact** across K broker shards (``configs.shard_of_artifact``):

  * SWMR survives sharding because exclusivity is *per-artifact* - an
    artifact's entire history (reads, upgrades, commits, invalidations)
    serializes through exactly one shard, so no cross-shard interleaving
    can ever produce two M holders;
  * every shard is a full, unmodified ``CoherenceBroker`` whose
    directory lives on the shard's card, round-robin over the host's
    cards as the JAX package pins each shard to a device, with its own
    CUDA stream there (``launch.mesh.shard_devices``; on one card the K
    shards are K streams of it), so each shard's micro-batches queue
    their tick launches (or ACS pass) on that shard's stream;
  * the shards' interleaved batch commits are recorded into ONE global
    ``ServiceTrace`` in event-loop commit order - a serializable order
    the four-way oracle replays, and ``sim.oracle.check_sharded_trace``
    additionally re-derives every shard's local history from it
    (cross-shard conformance leg).

In front of the L2 authority sits a per-host **L1 directory**
(:class:`HostL1Directory`): each host caches the (version, content) it
last saw per artifact, so a same-host agent's fill is served from the
host's copy without a cross-shard hop.  The L1 plane is *attribution
only* - it never changes what the decision plane charges (which is what
keeps the K=4 ledger bit-identical to K=1); it splits each fill's wire
bytes into ``l1_bytes`` (served host-locally) vs ``l2_bytes`` (shipped
from the authority).  Writes drive an explicit L1-invalidation path:
the commit invalidates the artifact's entry on every host, then the
writer's host adopts the committed copy.  The invariant bound
``topology.l1_max_version_lag`` says a *valid* L1 entry may never be
observed more than that many versions behind the authority; a stale
entry surviving past the bound raises ``InvariantViolation``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.content.chunks import BYTES_PER_TOKEN
from repro_torch.core.protocol import TokenLedger
from repro_torch.launch.mesh import shard_devices
from repro_torch.obs.stats import unified_stats
from repro_torch.obs.telemetry import Telemetry
from repro_torch.service.batching import resolve_decide_backend
from repro_torch.service.broker import (CoherenceBroker, InvariantViolation,
                                  ReadResult, WriteResult)
from repro_torch.service.trace import ServiceTrace


class L1Entry(NamedTuple):
    """One host's cached copy of an artifact (version-exact)."""

    version: int
    content: tuple


class HostL1Directory:
    """Per-host L1 cache of artifact copies in front of the L2 shards.

    Serve rule: an entry is usable for a fill only on an **exact
    version match** with byte-equal content - anything else is an L2
    fill (and refreshes the entry).  The invalidation path keeps valid
    entries within ``max_version_lag`` of the authority; the white-box
    check (:meth:`check`) proves it.
    """

    def __init__(self, host: int, max_version_lag: int = 0) -> None:
        self.host = host
        self.max_version_lag = max_version_lag
        self.entries: Dict[str, L1Entry] = {}
        self.n_invalidations = 0

    def lookup(self, artifact: str) -> Optional[L1Entry]:
        return self.entries.get(artifact)

    def fill(self, artifact: str, version: int, content) -> None:
        self.entries[artifact] = L1Entry(int(version), tuple(content))

    def invalidate(self, artifact: str) -> bool:
        """Drop the entry; True if one was actually held."""
        if self.entries.pop(artifact, None) is not None:
            self.n_invalidations += 1
            return True
        return False

    def check(self, artifact: str, authority_version: int) -> None:
        """Raise if a valid entry sits past the staleness bound - the
        L1-invalidation path failed to keep this host coherent."""
        entry = self.entries.get(artifact)
        if entry is None:
            return
        lag = int(authority_version) - entry.version
        if lag > self.max_version_lag:
            raise InvariantViolation(
                f"L1 staleness bound violated: host {self.host} holds "
                f"{artifact!r} at version {entry.version}, authority is "
                f"at {authority_version} (lag {lag} > bound "
                f"{self.max_version_lag})")


class ShardedCoherenceBroker:
    """K-shard authority plane behind the single-broker client API.

    Use as an async context manager, exactly like ``CoherenceBroker``::

        async with ShardedCoherenceBroker(cfg) as broker:
            await broker.read(agent=0, artifact="plan")

    ``cfg`` is a layered ``repro_torch.configs.CoherenceConfig``; its
    ``topology`` layer fixes the shard count, host count and L1 bound.
    The blessed constructor is ``repro_torch.service.connect(...)``,
    which resolves the topology and picks this class or the plain
    broker.  The shards' directories live on ``device`` (``None``: the
    host's cards, round-robin), each on its own stream.
    """

    #: lets ``trace.verify_broker`` dispatch to the sharded verifier.
    is_sharded = True

    def __init__(self, config,
                 contents: Optional[Dict[str, Sequence[int]]] = None,
                 *, device=None) -> None:
        if not hasattr(config, "topology"):
            raise TypeError(
                "ShardedCoherenceBroker needs a layered "
                "repro_torch.configs.CoherenceConfig (BrokerConfig has "
                "no topology layer); build one with "
                "CoherenceConfig.make or repro_torch.service.connect"
                "(...)")
        if config.core.max_stale_steps > 0:
            raise ValueError(
                "sharded authority does not serve simulator K-staleness"
                " (per-shard action clocks diverge from the global "
                "clock); bound L1 staleness with l1_max_version_lag")
        self.config = config
        self.names = tuple(config.artifacts)
        self.n_shards = config.topology.n_shards
        self.artifact_shards = config.artifact_shards()
        self._shard_cols = config.shard_artifact_indices()
        self._shard_of_name = {name: self.artifact_shards[d]
                               for d, name in enumerate(self.names)}
        #: each shard's (device, stream): its card and a stream of its
        #: own there (``(cpu, None)`` each on the CPU)
        self.placements = shard_devices(self.n_shards, device)
        self.streams = tuple(stream for _, stream in self.placements)

        #: the ONE global audit trace, in event-loop commit order
        self.trace = ServiceTrace.for_broker(config.broker_view())
        self.trace.n_shards = self.n_shards
        self.trace.artifact_shards = self.artifact_shards
        self._capture = config.service.capture_trace
        self.n_batches = 0

        #: ONE telemetry plane shared by every shard: sub-brokers stamp
        #: their own ``shard=k`` label into the same registry, so the
        #: fleet-wide MESI counters aggregate without a collector.
        self.telemetry: Optional[Telemetry] = None
        if config.service.telemetry:
            self.telemetry = Telemetry(
                config.n_agents, strategy=config.core.strategy,
                backend=resolve_decide_backend(config.acs_config(),
                                               config.service.backend),
                n_shards=self.n_shards,
                n_hosts=config.topology.n_hosts)

        self.brokers = []
        for shard in range(self.n_shards):
            view = config.shard_view(shard)
            # sub-brokers never capture: the global trace above is the
            # single authoritative history (per-shard histories are
            # re-derived from it by the cross-shard oracle leg)
            view = dataclasses.replace(view, service=dataclasses.replace(
                view.service, capture_trace=False))
            sub_contents = None
            if contents is not None:
                sub_contents = {name: contents[name]
                                for name in view.artifacts
                                if name in contents}
            self.brokers.append(CoherenceBroker(
                view.broker_view(), sub_contents,
                on_commit=functools.partial(self._commit, shard),
                device=self.placements[shard][0],
                stream=self.placements[shard][1],
                telemetry=self.telemetry, shard=shard))
        self.brokers = tuple(self.brokers)

        self.l1 = tuple(
            HostL1Directory(h, config.topology.l1_max_version_lag)
            for h in range(config.topology.n_hosts))
        #: fill attribution (never touches the token ledger): how many
        #: fills / wire bytes the L1 plane served host-locally vs what
        #: crossed to the L2 authority shards
        self.l1_wire = {"l1_fills": 0, "l2_fills": 0,
                        "l1_bytes": 0, "l2_bytes": 0}

    # ------------------------------------------------------- lifecycle
    async def start(self) -> "ShardedCoherenceBroker":
        for broker in self.brokers:
            await broker.start()
        return self

    async def stop(self) -> None:
        for broker in self.brokers:
            await broker.stop()
        if self.config.service.check_invariants:
            self.check_l1()

    async def __aenter__(self) -> "ShardedCoherenceBroker":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # ------------------------------------------------------ client API
    def shard_of(self, artifact: str) -> int:
        try:
            return self._shard_of_name[artifact]
        except KeyError:
            raise KeyError(
                f"unknown artifact {artifact!r}; registered: "
                f"{list(self.names)}") from None

    def broker_of(self, artifact: str) -> CoherenceBroker:
        return self.brokers[self.shard_of(artifact)]

    def host_of(self, agent: int) -> int:
        return self.config.topology.host_of(agent)

    async def read(self, agent: int, artifact: str) -> ReadResult:
        result = await self.broker_of(artifact).read(agent, artifact)
        if not result.hit:
            self._attribute_fill(agent, artifact, result)
        return result

    async def write(self, agent: int, artifact: str,
                    content: Optional[Sequence[int]] = None
                    ) -> WriteResult:
        result = await self.broker_of(artifact).write(agent, artifact,
                                                      content)
        self._l1_on_commit(agent, artifact, result.version)
        return result

    # -------------------------------------------------------- L1 plane
    def _fill_bytes(self, result: ReadResult) -> int:
        if result.delta is not None:     # content plane: measured delta
            return sum(len(chunk) for _, chunk in result.delta) \
                * BYTES_PER_TOKEN
        return self.config.core.artifact_tokens * BYTES_PER_TOKEN

    def _attribute_fill(self, agent: int, artifact: str,
                        result: ReadResult) -> None:
        """Attribute one coherence fill to the L1 or the L2 plane.

        Future resolution order IS the authority's serialization order
        (batches commit in event-loop order; within a batch futures
        resolve in ascending agent order), so this bookkeeping observes
        commits exactly as the decision plane serialized them."""
        host = self.l1[self.host_of(agent)]
        host.check(artifact, result.version)
        entry = host.lookup(artifact)
        nbytes = self._fill_bytes(result)
        if (entry is not None and entry.version == result.version
                and entry.content == result.content):
            # a same-host peer already holds this exact version: the
            # delta never leaves the host, no cross-shard hop
            self.l1_wire["l1_fills"] += 1
            self.l1_wire["l1_bytes"] += nbytes
            level = "l1"
        else:
            self.l1_wire["l2_fills"] += 1
            self.l1_wire["l2_bytes"] += nbytes
            host.fill(artifact, result.version, result.content)
            level = "l2"
        if self.telemetry is not None:
            self.telemetry.record_l1_fill(host.host, level, nbytes)

    def _l1_on_commit(self, agent: int, artifact: str,
                      version: int) -> None:
        """The explicit L1-invalidation path: a commit invalidates the
        artifact on EVERY host, then the writer's host adopts the
        committed copy (if it is still the authority's current one)."""
        for host in self.l1:
            if host.invalidate(artifact) and self.telemetry is not None:
                self.telemetry.record_l1_invalidation(host.host)
        broker = self.broker_of(artifact)
        local = broker.artifact_index(artifact)
        if int(broker.versions[local]) == int(version):
            self.l1[self.host_of(agent)].fill(
                artifact, version, tuple(broker.store.get(artifact)))

    def check_l1(self) -> None:
        """White-box L1/L2 invariant sweep: every valid entry on every
        host is within the version-lag bound, and lag-0 entries are
        byte-identical to the authority copy."""
        for host in self.l1:
            for artifact, entry in host.entries.items():
                broker = self.broker_of(artifact)
                local = broker.artifact_index(artifact)
                authority = int(broker.versions[local])
                host.check(artifact, authority)
                if (entry.version == authority and entry.content
                        != tuple(broker.store.get(artifact))):
                    raise InvariantViolation(
                        f"L1 content diverged from authority: host "
                        f"{host.host} holds {artifact!r} at version "
                        f"{entry.version} with different bytes")

    # ------------------------------------------------- trace assembly
    def _commit(self, shard: int, sub: CoherenceBroker,
                commit: dict) -> None:
        """Per-shard commit hook: remap the shard-local batch onto the
        global artifact index space and append it (tagged with its
        shard) to the global trace, in event-loop commit order."""
        self.n_batches += 1
        if not self._capture:
            return
        acts = commit["acts"]
        cols = np.asarray(self._shard_cols[shard], np.int32)
        arts = np.zeros_like(commit["arts"])
        arts[acts] = cols[commit["arts"][acts]]
        self.trace.append_step(acts, arts, commit["writes"],
                               commit["miss"], commit["version"],
                               commit["latencies"],
                               write_chunks=commit["write_chunks"],
                               shard=shard,
                               decide_s=commit["busy_s"],
                               batch_size=int(np.asarray(acts).sum()))

    # --------------------------------------------------- assembled views
    def _assemble(self, attr: str, agent_axis: bool) -> np.ndarray:
        """Stitch per-shard directory columns back into the global
        (n_agents, n_artifacts, ...) layout."""
        parts = [np.asarray(getattr(b, attr)) for b in self.brokers]
        ref = parts[0]
        m = len(self.names)
        shape = ((ref.shape[0], m) + ref.shape[2:] if agent_axis
                 else (m,) + ref.shape[1:])
        out = np.zeros(shape, ref.dtype)
        for shard, cols in enumerate(self._shard_cols):
            part = parts[shard]
            for local, d in enumerate(cols):
                if agent_axis:
                    out[:, d] = part[:, local]
                else:
                    out[d] = part[local]
        return out

    @property
    def directory_state(self) -> np.ndarray:
        """(n_agents, n_artifacts) MESI matrix across all shards."""
        return self._assemble("directory_state", agent_axis=True)

    @property
    def versions(self) -> np.ndarray:
        return self._assemble("versions", agent_axis=False)

    @property
    def last_sync(self) -> np.ndarray:
        parts = []
        for b in self.brokers:
            # read after the shard's own stream, not the default one
            with b.decider.on_stream():
                parts.append(b.decider.arrays.last_sync[0].cpu().numpy())
        n = self.config.n_agents
        out = np.zeros((n, len(self.names)), np.int32)
        for shard, cols in enumerate(self._shard_cols):
            for local, d in enumerate(cols):
                out[:, d] = parts[shard][:, local]
        return out

    @property
    def ledger(self) -> TokenLedger:
        """Summed token ledger - per-artifact charges are independent,
        so the sum over shards IS the global ledger (oracle-checked)."""
        led = TokenLedger()
        for broker in self.brokers:
            led = led.merge(broker.ledger)
        return led

    @property
    def wire(self) -> dict:
        out = {"delta_bytes": 0, "full_bytes": 0, "n_chunks_fetched": 0}
        for broker in self.brokers:
            for key in out:
                out[key] += broker.wire[key]
        return out

    @property
    def chunked(self) -> bool:
        return self.config.core.chunk_tokens > 0

    def decision_busy(self) -> tuple:
        """Per-shard seconds spent inside the decider - the serialized
        per-authority bottleneck.  Under the shard-per-host deployment
        the shards decide concurrently, so the plane's makespan is the
        MAX over shards (the decision-capacity metric of the bench)."""
        return tuple(broker.decide_busy_s for broker in self.brokers)

    # ----------------------------------------------------------- stats
    def stats(self) -> dict:
        """The unified stats mapping (``repro_torch.obs.stats``): canonical
        nested schema plus the legacy flat aliases as a deprecation
        shim (identical schema to the plain broker's)."""
        return unified_stats(self)
