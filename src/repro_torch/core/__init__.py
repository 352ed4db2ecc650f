"""Core of the paper: the Artifact Coherence System (ACS), batched over
simulations in PyTorch."""

from repro_torch.core.states import MESIState, CoherenceEvent, TRANSITION_TABLE
from repro_torch.core.acs import (
    ACSConfig, ACSArrays, ACSMetrics, RateMatrices, init_arrays,
    init_metrics, tick, run_episode, draw_actions, uniform_rates,
    BROADCAST, EAGER, LAZY, TTL, ACCESS_COUNT,
    STRATEGY_NAMES, STRATEGY_CODES, SIGNAL_TOKENS,
)
from repro_torch.core import theorem, invariants

__all__ = [
    "MESIState", "CoherenceEvent", "TRANSITION_TABLE",
    "ACSConfig", "ACSArrays", "ACSMetrics", "RateMatrices", "init_arrays",
    "init_metrics", "tick", "run_episode", "draw_actions", "uniform_rates",
    "BROADCAST", "EAGER", "LAZY", "TTL",
    "ACCESS_COUNT", "STRATEGY_NAMES", "STRATEGY_CODES", "SIGNAL_TOKENS",
    "theorem", "invariants",
]
