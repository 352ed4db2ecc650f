"""Artifact-coherence service: the paper's reference implementation as
a servable async system (contribution 5), on the port's decision layer.

Public surface (the names of ``repro.service``):

  * :func:`connect` - the **blessed entry point**: a topology-neutral
    factory that resolves the layered
    ``repro_torch.configs.CoherenceConfig`` onto the right authority
    implementation (single broker or sharded plane) without callers
    naming either; the directories live on ``device`` (``None``: CUDA);
  * :class:`CoherenceBroker` - the asyncio single-writer authority
    with micro-batched coherence decisions over a directory on the
    broker's device;
  * :class:`ShardedCoherenceBroker` / :class:`HostL1Directory` - the
    K-shard authority plane with per-host L1 directories, each shard on
    its own CUDA stream of the one card;
  * :class:`BrokerConfig` - legacy flat config, a thin frozen view over
    the layered config (direct construction warns once);
  * :class:`BatchDecider` / :func:`resolve_decide_backend` - the
    decision layer and its ``scan`` / ``kernel`` routes;
  * :class:`CoherentClient` / :func:`make_clients` /
    :class:`ServicePortal` / :class:`SyncCoherentClient` - per-agent
    clients (async-native, plus a sync bridge for frameworks);
  * :class:`CoherentTool`, :func:`langgraph_node`, :func:`crewai_tool`,
    :func:`autogen_functions` - the thin framework adapter layer;
  * :class:`ServiceTrace` / :func:`replay_trace` /
    :func:`verify_broker` / :func:`verify_sharded_broker` -
    oracle-replayable decision traces (``verify_broker`` dispatches on
    the broker flavor);
  * :func:`drive_workload` / :class:`LoadReport` - the concurrent load
    generator over workload-zoo rate matrices.
"""

from repro_torch.configs.coherence import (CoherenceConfig, CoherenceCore,
                                           ServiceLayer, ShardTopology,
                                           shard_of_artifact)
from repro_torch.service.broker import (BROKER_STRATEGIES, BrokerConfig,
                                        CoherenceBroker, InvariantViolation,
                                        ReadResult, WriteResult)
from repro_torch.service.batching import (BatchDecider, BatchDecision,
                                          resolve_decide_backend)
from repro_torch.service.sharding import (HostL1Directory, L1Entry,
                                          ShardedCoherenceBroker)
from repro_torch.service.connect import connect, resolve_broker
from repro_torch.service.client import (CoherentClient, DeltaMismatch,
                                        ServicePortal, SyncCoherentClient,
                                        make_clients)
from repro_torch.service.adapters import (CoherentTool, ToolResult,
                                          autogen_functions, crewai_tool,
                                          langgraph_node)
from repro_torch.service.trace import (ServiceTrace, StepRecord,
                                       replay_trace, verify_broker,
                                       verify_broker_content,
                                       verify_sharded_broker)
from repro_torch.service.loadgen import (LoadReport, drive_workload,
                                         sample_round)

__all__ = [
    "connect", "resolve_broker",
    "CoherenceConfig", "CoherenceCore", "ServiceLayer", "ShardTopology",
    "shard_of_artifact",
    "BROKER_STRATEGIES", "BrokerConfig", "CoherenceBroker",
    "InvariantViolation", "ReadResult", "WriteResult",
    "BatchDecider", "BatchDecision", "resolve_decide_backend",
    "HostL1Directory", "L1Entry", "ShardedCoherenceBroker",
    "CoherentClient", "DeltaMismatch", "ServicePortal",
    "SyncCoherentClient", "make_clients",
    "CoherentTool", "ToolResult", "autogen_functions", "crewai_tool",
    "langgraph_node",
    "ServiceTrace", "StepRecord", "replay_trace", "verify_broker",
    "verify_broker_content", "verify_sharded_broker",
    "LoadReport", "drive_workload", "sample_round",
]
