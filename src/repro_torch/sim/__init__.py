"""Tick-based discrete-event simulation of artifact coherence (paper SS8)
on CUDA, one batch a grid or sharded over the host's devices on
request."""

from repro_torch.sim.scenarios import (
    ScenarioConfig, SCENARIOS, CLIFF_VOLATILITIES, SCALING_AGENT_COUNTS,
    SCALING_ARTIFACT_TOKENS, SCALING_STEPS, canonical, cliff_scenario,
    agent_scaling_scenario, artifact_size_scenario, step_scaling_scenario,
    pointer_semantics_scenario,
)
from repro_torch.sim.engine import (
    RunStats, RunResult, Comparison, run_scenario, compare, compare_grid,
    compare_workloads, run_workload, sweep_volatility, sweep_cells,
    resolve_tick_backend, resolve_sweep_devices, shard_plan, ShardPlan,
)
from repro_torch.sim.workloads import (
    Workload, FAMILIES, FAMILY_SEEDS, make, zoo, random_workload,
    zipf_weights,
)

__all__ = [
    "ScenarioConfig", "SCENARIOS", "CLIFF_VOLATILITIES",
    "SCALING_AGENT_COUNTS", "SCALING_ARTIFACT_TOKENS", "SCALING_STEPS",
    "canonical", "cliff_scenario", "agent_scaling_scenario",
    "artifact_size_scenario", "step_scaling_scenario",
    "pointer_semantics_scenario",
    "RunStats", "RunResult", "Comparison", "run_scenario", "compare",
    "compare_grid", "compare_workloads", "run_workload",
    "sweep_volatility", "sweep_cells", "resolve_tick_backend",
    "resolve_sweep_devices", "shard_plan", "ShardPlan",
    "Workload", "FAMILIES", "FAMILY_SEEDS", "make", "zoo",
    "random_workload", "zipf_weights",
]
