"""Token Coherence Theorem (paper SS4.3-4.5): analytic cost model and bounds.

All quantities are in tokens.  Notation follows the paper:
    n  - agent count            S  - reasoning steps
    m  - artifact count         |d| - artifact size (tokens)
    W  - writes per artifact    V = W / S  - volatility factor
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    """Closed-form workload description for the analytic model."""

    n_agents: int
    n_steps: int
    artifact_sizes: tuple[int, ...]          # |d_i| in tokens
    writes_per_artifact: tuple[float, ...]   # W(d_i)

    @property
    def n_artifacts(self) -> int:
        return len(self.artifact_sizes)

    @classmethod
    def uniform(
        cls, n_agents: int, n_steps: int, n_artifacts: int,
        artifact_tokens: int, volatility: float,
    ) -> "WorkloadParams":
        """Canonical uniform workload: identical sizes, V(d_i) = V.

        The paper defines W(d_i) = V * S (Def. 4 inverted).
        """
        w = volatility * n_steps
        return cls(
            n_agents=n_agents,
            n_steps=n_steps,
            artifact_sizes=tuple([artifact_tokens] * n_artifacts),
            writes_per_artifact=tuple([w] * n_artifacts),
        )


def broadcast_cost(p: WorkloadParams) -> float:
    """T_broadcast = n * S * sum_i |d_i|   (paper SS4.3)."""
    return float(p.n_agents) * p.n_steps * float(sum(p.artifact_sizes))


def coherent_cost_upper_bound(p: WorkloadParams) -> float:
    """Def. 3: T_coherent <= sum_i n * (n + W(d_i)) * |d_i|."""
    total = 0.0
    for size, w in zip(p.artifact_sizes, p.writes_per_artifact):
        total += p.n_agents * (p.n_agents + w) * size
    return total


def savings_lower_bound(p: WorkloadParams) -> float:
    """Theorem 1: Savings >= 1 - T_coherent_upper / T_broadcast.

    For uniform sizes this reduces to 1 - (n + W)/S.  The bound may be
    negative (Corollary 2, the collapse condition W >= S - n).
    """
    return 1.0 - coherent_cost_upper_bound(p) / broadcast_cost(p)


def savings_lower_bound_uniform(
    n_agents: int, n_steps: int, volatility: float
) -> float:
    """Closed form 1 - n/S - V (paper SS4.5)."""
    return 1.0 - n_agents / n_steps - volatility


def coherence_condition(p: WorkloadParams) -> bool:
    """S > n + W(d_i) for every artifact (Theorem 1 positivity condition)."""
    return all(
        p.n_steps > p.n_agents + w for w in p.writes_per_artifact
    )


def volatility_cliff(n_agents: int, n_steps: int) -> float:
    """Def. 5: V* = 1 - n/S, above which the *lower bound* goes negative.

    SS8.3 shows simulation does not actually collapse there (lazy
    deferred-fetch collapse); the cliff is a property of the bound only.
    """
    return 1.0 - n_agents / n_steps


def max_savings_bound(n_agents: int, n_steps: int) -> float:
    """Corollary 1: read-only artifacts (W = 0) -> bound = 1 - n/S."""
    return 1.0 - n_agents / n_steps


def theorem_table(
    n_agents: int, n_steps: int, volatilities: Sequence[float]
) -> np.ndarray:
    """Vectorized lower-bound column of the SS8.3 cliff table."""
    v = np.asarray(volatilities, dtype=np.float64)
    return 1.0 - n_agents / n_steps - v


def prompt_cache_amplification(
    volatility: float, cache_discount: float = 0.9
) -> dict[str, float]:
    """SS8.4: provider-side prompt-cache hit-rate model.

    Broadcast re-embeds artifact content each step, so the prefix is
    invalidated whenever any artifact changed: hit-rate ~= 1 - V.  Under
    coherent sync the prefix carries only O(1) references, so the
    structural prefix stays stable: hit-rate -> 1.0.  ``cache_discount``
    is the per-hit cost reduction (50-90% per the paper; default 90%).
    Returns effective cost multipliers (lower is better).
    """
    hit_broadcast = max(0.0, 1.0 - volatility)
    hit_coherent = 1.0
    eff_broadcast = 1.0 - cache_discount * hit_broadcast
    eff_coherent = 1.0 - cache_discount * hit_coherent
    return {
        "hit_rate_broadcast": hit_broadcast,
        "hit_rate_coherent": hit_coherent,
        "effective_cost_mult_broadcast": eff_broadcast,
        "effective_cost_mult_coherent": eff_coherent,
        "amplification": (
            eff_broadcast / eff_coherent if eff_coherent > 0 else float("inf")
        ),
    }
