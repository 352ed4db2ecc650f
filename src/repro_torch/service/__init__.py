"""Artifact-coherence service: the paper's reference implementation as
a servable async system (contribution 5), on the port's decision layer.

Public surface (the names of ``repro.service`` that this package has):

  * :class:`CoherenceBroker` - the asyncio single-writer authority
    with micro-batched coherence decisions over a directory that lives
    on the broker's device (``None``: CUDA);
  * :class:`BrokerConfig` - legacy flat config, a thin frozen view over
    the layered ``repro_torch.configs.CoherenceConfig`` (direct
    construction warns once);
  * :class:`BatchDecider` / :func:`resolve_decide_backend` - the
    decision layer and its ``scan`` / ``kernel`` routes;
  * :class:`CoherentClient` / :func:`make_clients` /
    :class:`ServicePortal` / :class:`SyncCoherentClient` - per-agent
    clients (async-native, plus a sync bridge for frameworks);
  * :class:`ServiceTrace` / :func:`replay_trace` /
    :func:`verify_broker` / :func:`verify_broker_content` /
    :func:`verify_sharded_broker` - oracle-replayable decision traces;
  * :func:`drive_workload` / :class:`LoadReport` - the concurrent load
    generator over workload-zoo rate matrices.

The sharded authority plane (``ShardedCoherenceBroker``,
``HostL1Directory``), ``connect`` and the framework adapters are not
ported yet.
"""

from repro_torch.configs.coherence import (CoherenceConfig, CoherenceCore,
                                           ServiceLayer, ShardTopology,
                                           shard_of_artifact)
from repro_torch.service.broker import (BROKER_STRATEGIES, BrokerConfig,
                                        CoherenceBroker, InvariantViolation,
                                        ReadResult, WriteResult)
from repro_torch.service.batching import (BatchDecider, BatchDecision,
                                          resolve_decide_backend)
from repro_torch.service.client import (CoherentClient, DeltaMismatch,
                                        ServicePortal, SyncCoherentClient,
                                        make_clients)
from repro_torch.service.trace import (ServiceTrace, StepRecord,
                                       replay_trace, verify_broker,
                                       verify_broker_content,
                                       verify_sharded_broker)
from repro_torch.service.loadgen import (LoadReport, drive_workload,
                                         sample_round)

__all__ = [
    "CoherenceConfig", "CoherenceCore", "ServiceLayer", "ShardTopology",
    "shard_of_artifact",
    "BROKER_STRATEGIES", "BrokerConfig", "CoherenceBroker",
    "InvariantViolation", "ReadResult", "WriteResult",
    "BatchDecider", "BatchDecision", "resolve_decide_backend",
    "CoherentClient", "DeltaMismatch", "ServicePortal",
    "SyncCoherentClient", "make_clients",
    "ServiceTrace", "StepRecord", "replay_trace", "verify_broker",
    "verify_broker_content", "verify_sharded_broker",
    "LoadReport", "drive_workload", "sample_round",
]
