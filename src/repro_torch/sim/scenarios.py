"""Scenario registry for the paper's evaluation (SS8.1).

Canonical parameters (all configurations): n = 4 agents, m = 3 artifacts,
|d_i| = 4,096 tokens, S = 40 steps, action probability 0.75, 10 runs per
configuration with scenario-specific deterministic seeds (A-D use
20260305-20260308; run ``r`` of a scenario is keyed by ``fold_in(
PRNGKey(seed), r)`` - see ``repro_torch.sim.engine``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.acs import ACSConfig, LAZY


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One evaluation workload: an ACSConfig plus run bookkeeping."""

    name: str
    acs: ACSConfig
    seed: int
    n_runs: int = 10
    description: str = ""

    def with_strategy(self, strategy_code: int) -> "ScenarioConfig":
        return dataclasses.replace(
            self, acs=dataclasses.replace(self.acs, strategy=strategy_code))

    def with_overrides(self, **acs_overrides) -> "ScenarioConfig":
        return dataclasses.replace(
            self, acs=dataclasses.replace(self.acs, **acs_overrides))


CANONICAL = dict(n_agents=4, n_artifacts=3, artifact_tokens=4096,
                 n_steps=40, p_act=0.75, strategy=LAZY)


def canonical(name: str, volatility: float, seed: int,
              description: str = "", **overrides) -> ScenarioConfig:
    params = dict(CANONICAL, volatility=volatility, **overrides)
    return ScenarioConfig(name=name, acs=ACSConfig(**params), seed=seed,
                          description=description)


#: The four workload scenarios of SS8.1 with the published seeds.
SCENARIOS: dict[str, ScenarioConfig] = {
    "A": canonical(
        "A: Planning", 0.05, 20260305,
        "Infrequent plan revisions (W ~= 2 writes per artifact)."),
    "B": canonical(
        "B: Analysis", 0.10, 20260306,
        "Periodic shared-document updates (W ~= 4)."),
    "C": canonical(
        "C: Development", 0.25, 20260307,
        "Moderate artifact churn (W ~= 10)."),
    "D": canonical(
        "D: High Churn", 0.50, 20260308,
        "Frequent modification by multiple agents (W ~= 20)."),
}

#: SS8.3 volatility-cliff sweep (canonical params, V varies).
CLIFF_VOLATILITIES = (0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 1.00)

#: SS8.5 agent-count scaling (Scenario B volatility).
SCALING_AGENT_COUNTS = (2, 4, 8, 16)

#: SS8.6 artifact-size scaling (Scenario A volatility).
SCALING_ARTIFACT_TOKENS = (4096, 8192, 32768, 65536)

#: SS8.7 step-count scaling (fixed W ~= 2 -> V = 2/S).
SCALING_STEPS = (5, 10, 20, 40, 50, 100)


def cliff_scenario(v: float) -> ScenarioConfig:
    return canonical(f"cliff V={v}", v, 20260310 + int(round(v * 100)))


def agent_scaling_scenario(n: int) -> ScenarioConfig:
    return canonical(f"agents n={n}", 0.10, 20260320 + n, n_agents=n)


def artifact_size_scenario(tokens: int) -> ScenarioConfig:
    return canonical(f"size |d|={tokens}", 0.05,
                     20260330 + tokens % 97, artifact_tokens=tokens)


def step_scaling_scenario(s: int) -> ScenarioConfig:
    # fixed write budget W ~= 2 per artifact: V = W/S = 2/S (Def. 4)
    return canonical(f"steps S={s}", 2.0 / s, 20260340 + s, n_steps=s)


def pointer_semantics_scenario() -> ScenarioConfig:
    """SS8.8: pointer-reference architecture with frequent cold fetches.

    One shared artifact that every agent dereferences every step
    (p_act = 1.0, m = 1) under moderate churn.  Under lazy, every
    write-invalidation turns the next dereference into a synchronous
    full fetch (a stall); under eager, push-on-commit keeps cache
    occupancy near-perfect and only the n initial fills hit the
    critical path.  sync_tokens counts critical-path traffic only;
    eager's background push bytes are reported separately.
    """
    return canonical("pointer semantics", 0.25, 20260350,
                     p_act=1.0, n_steps=40, n_artifacts=1)
