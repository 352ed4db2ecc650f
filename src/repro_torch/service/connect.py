"""Topology-neutral client entry: ``repro_torch.service.connect(...)``.

Callers say *what* fleet they are (agents, artifacts, protocol knobs)
and at most *how wide* the authority plane should be (``shards=``,
``hosts=``); the resolver picks the implementation - the single
asyncio broker for a trivial topology, the sharded authority plane
(with per-host L1 directories) otherwise.  Client code is identical
either way::

    from repro_torch import service

    async with service.connect(n_agents=8,
                               artifacts=("plan", "result"),
                               shards=2, hosts=2, device="cpu") as broker:
        await broker.read(agent=0, artifact="plan")

    with service.connect(n_agents=4, artifacts=("plan",),
                         sync=True) as portal:     # thread-loop bridge
        portal.client(0).read("plan")

Shard count, artifact placement and L1 host mapping are deployment
facts, not protocol facts - nothing about coherence semantics leaks
through this boundary (the K=4 ledger is bit-identical to K=1,
oracle-enforced), so callers never branch on the topology.  The
authority's directories live on ``device`` (``None``: CUDA; a sharded
plane gives each shard its own stream there).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.configs.coherence import CoherenceConfig
from repro_torch.service.broker import CoherenceBroker
from repro_torch.service.sharding import ShardedCoherenceBroker


def resolve_broker(config: CoherenceConfig,
                   contents: Optional[Dict[str, Sequence[int]]] = None,
                   *, device=None):
    """Pick the authority implementation this topology needs.

    Trivial topology (1 shard, 1 host) -> the plain single-writer
    ``CoherenceBroker`` (byte-identical to the pre-sharding service);
    anything wider -> ``ShardedCoherenceBroker``.  Legacy flat
    ``BrokerConfig``s are lifted into the layered config first."""
    if not hasattr(config, "topology"):      # legacy BrokerConfig
        config = config.coherence_config()
    if config.topology.trivial:
        return CoherenceBroker(config.broker_view(), contents,
                               device=device)
    return ShardedCoherenceBroker(config, contents, device=device)


def connect(config: Optional[CoherenceConfig] = None, *,
            n_agents: Optional[int] = None,
            artifacts: Optional[Sequence[str]] = None,
            contents: Optional[Dict[str, Sequence[int]]] = None,
            sync: bool = False, device=None, **knobs):
    """Build an authority handle without naming its implementation.

    Either pass a prebuilt ``CoherenceConfig`` (or legacy
    ``BrokerConfig``), or flat knobs (``n_agents`` + ``artifacts``
    plus any core / service / topology field, with ``shards`` /
    ``hosts`` aliases) and the layered config is assembled here.

    Returns an *unstarted* broker - use ``async with`` (or ``await
    .start()``).  With ``sync=True`` returns a started
    ``ServicePortal`` (its own event loop on a daemon thread) for
    frameworks that do not run asyncio; use ``with``.  The directories
    live on ``device`` (``None``: CUDA).
    """
    if config is None:
        if n_agents is None or artifacts is None:
            raise TypeError(
                "connect() needs either a config or both n_agents= "
                "and artifacts=")
        config = CoherenceConfig.make(n_agents, artifacts, **knobs)
    else:
        if knobs or n_agents is not None or artifacts is not None:
            raise TypeError(
                "pass either a prebuilt config or flat knobs, not both")
        if not hasattr(config, "topology"):  # legacy BrokerConfig
            config = config.coherence_config()
    if sync:
        from repro_torch.service.client import ServicePortal
        return ServicePortal(config, contents, device=device)
    return resolve_broker(config, contents, device=device)
