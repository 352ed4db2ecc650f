"""Core of the paper: the Artifact Coherence System (ACS), batched over
simulations in PyTorch, and the CCS protocol."""

from repro_torch.core.states import MESIState, CoherenceEvent, TRANSITION_TABLE
from repro_torch.core.acs import (
    ACSConfig, ACSArrays, ACSMetrics, RateMatrices, init_arrays,
    init_metrics, tick, run_episode, draw_actions, uniform_rates,
    BROADCAST, EAGER, LAZY, TTL, ACCESS_COUNT,
    STRATEGY_NAMES, STRATEGY_CODES, SIGNAL_TOKENS,
)
from repro_torch.core import theorem, invariants, model_check, strategies
from repro_torch.core.protocol import (
    Message, EventBus, ArtifactStore, CoordinatorService,
    ShardedCoordinator, AgentRuntime, TokenLedger,
)
from repro_torch.core.lease import Lease, LeaseTable
from repro_torch.core.clock import VectorClock, MonotonicVersioner

__all__ = [
    "MESIState", "CoherenceEvent", "TRANSITION_TABLE",
    "ACSConfig", "ACSArrays", "ACSMetrics", "RateMatrices", "init_arrays",
    "init_metrics", "tick", "run_episode", "draw_actions", "uniform_rates",
    "BROADCAST", "EAGER", "LAZY", "TTL",
    "ACCESS_COUNT", "STRATEGY_NAMES", "STRATEGY_CODES", "SIGNAL_TOKENS",
    "theorem", "invariants", "model_check", "strategies",
    "Message", "EventBus", "ArtifactStore", "CoordinatorService",
    "ShardedCoordinator", "AgentRuntime", "TokenLedger",
    "Lease", "LeaseTable", "VectorClock", "MonotonicVersioner",
]
