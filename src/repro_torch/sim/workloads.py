"""Heterogeneous workload generator (beyond-paper evaluation surface).

The paper's four scenarios (SS8.1) are homogeneous: every agent acts
with the same probability, picks artifacts uniformly, and writes with a
single scalar volatility V.  Real multi-agent deployments are dominated
by *structured, skewed* access - bursty writers, hot/cold artifact
skew, planner/worker hierarchies, read-heavy retrieval, pipeline
handoff, write ping-pong - and the MESI-transfer claim is only as
strong as the access diversity it survives.

A :class:`Workload` replaces the scalar ``(p_act, volatility)`` pair
with three rate tensors:

  * ``p_act``       (n,)    per-agent activity probability;
  * ``pick``        (n, m)  artifact-selection distribution per agent
                            (rows sum to 1);
  * ``write_rate``  (n, m)  P(write | agent a selected artifact d).

These are per-simulation inputs of the sweep engine
(``repro_torch.sim.engine.compare_workloads``): every workload family
that shares a static shape runs in one batch, kernel route included.
Each family below is a small closed-form generator.

Family taxonomy (also documented in ``benchmarks/README.md``):

  ``bursty``        a small clique of hot writers carries nearly all
                    writes; everyone else reads.
  ``zipf``          hot/cold artifact skew: selection follows a Zipf
                    law over artifacts, moderate uniform write rate.
  ``hierarchical``  planner/worker team: one planner rewrites the plan
                    artifact, workers read the plan and write private
                    output artifacts.
  ``rag``           read-heavy retrieval: near-zero write rates except
                    a single index-refresher agent.
  ``pipeline``      DAG handoff: stage i consumes artifact i and
                    produces artifact i+1 (mod m).
  ``ping_pong``     adversarial invalidation churn: two agents
                    alternate writes to one contended artifact while
                    spectators try to read it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.core.acs import ACSConfig, LAZY, RateMatrices
from repro_torch.kernels.backend import resolve_device

#: floor applied before log() so zero-probability picks become
#: effectively -inf logits without producing nan under categorical.
_LOG_FLOOR = 1e-30


@dataclasses.dataclass(frozen=True)
class Workload:
    """One heterogeneous evaluation workload.

    ``acs`` supplies the static shape/strategy fields; its scalar
    ``p_act`` / ``volatility`` are ignored by the heterogeneous path
    (the rate tensors below take precedence).
    """

    name: str
    family: str
    acs: ACSConfig
    p_act: np.ndarray       # (n,)
    pick: np.ndarray        # (n, m), rows sum to 1
    write_rate: np.ndarray  # (n, m)
    seed: int
    n_runs: int = 10
    description: str = ""
    #: fraction of an artifact's chunks one write dirties (the content
    #: plane's sampled span length; see ``acs.draw_write_chunks``).  A
    #: per-simulation input of the engine, like the rate tensors - only
    #: meaningful when the workload's config enables ``chunk_tokens``.
    write_locality: float = 1.0

    def __post_init__(self):
        n, m = self.acs.n_agents, self.acs.n_artifacts
        p = np.asarray(self.p_act, np.float64)
        pick = np.asarray(self.pick, np.float64)
        wr = np.asarray(self.write_rate, np.float64)
        if p.shape != (n,) or pick.shape != (n, m) or wr.shape != (n, m):
            raise ValueError(
                f"rate shapes {p.shape}/{pick.shape}/{wr.shape} do not "
                f"match config (n={n}, m={m})")
        for arr, label in ((p, "p_act"), (pick, "pick"),
                           (wr, "write_rate")):
            if (arr < 0).any() or (arr > 1).any():
                raise ValueError(f"{label} outside [0, 1]")
        if not np.allclose(pick.sum(axis=1), 1.0, atol=1e-6):
            raise ValueError("pick rows must sum to 1")

    # -- engine interface -------------------------------------------------
    def rates(self, device=None) -> RateMatrices:
        """The float32 tensor form consumed by the engine."""
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return RateMatrices(
            p_act=f32(self.p_act),
            log_pick=torch.log(torch.clamp(f32(self.pick),
                                           min=_LOG_FLOOR)),
            write_rate=f32(self.write_rate),
        )

    def effective_volatility(self) -> float:
        """E[write | action], averaged over acting agents - the scalar
        V this workload collapses to under homogenization."""
        per_agent = (self.pick * self.write_rate).sum(axis=1)
        weights = np.asarray(self.p_act, np.float64)
        total = weights.sum()
        if total <= 0:
            return 0.0
        return float((per_agent * weights).sum() / total)

    def with_strategy(self, strategy_code: int) -> "Workload":
        return dataclasses.replace(
            self, acs=dataclasses.replace(self.acs,
                                          strategy=strategy_code))

    def with_overrides(self, **acs_overrides) -> "Workload":
        return dataclasses.replace(
            self, acs=dataclasses.replace(self.acs, **acs_overrides))

    def with_volatility(self, volatility: float) -> "Workload":
        """Rescale the write-rate tensor so ``effective_volatility()``
        hits ``volatility`` while preserving the family's *structure*
        (who writes what stays fixed; only how often changes).  Rates
        clip at 1, so the realized volatility can undershoot for
        extreme targets on saturated families - callers sweeping V use
        ``effective_volatility()`` of the result as the realized
        axis value."""
        eff = self.effective_volatility()
        if eff <= 0:
            raise ValueError(
                f"workload {self.name!r} has zero effective volatility;"
                f" cannot rescale to {volatility}")
        scaled = np.clip(np.asarray(self.write_rate, np.float64)
                         * (volatility / eff), 0.0, 1.0)
        return dataclasses.replace(self, write_rate=scaled)

    def with_locality(self, write_locality: float) -> "Workload":
        return dataclasses.replace(self,
                                   write_locality=float(write_locality))


# ---------------------------------------------------------------------------
# Shared structure helpers.


def _uniform_rows(n: int, m: int) -> np.ndarray:
    return np.full((n, m), 1.0 / m)


def zipf_weights(m: int, s: float = 1.2) -> np.ndarray:
    """Zipf-law selection weights over artifact ranks (hot -> cold)."""
    w = 1.0 / np.arange(1, m + 1, dtype=np.float64) ** s
    return w / w.sum()


def _base_cfg(n_agents: int, n_artifacts: int, **overrides) -> ACSConfig:
    params = dict(n_agents=n_agents, n_artifacts=n_artifacts,
                  artifact_tokens=4096, n_steps=40, strategy=LAZY)
    params.update(overrides)
    return ACSConfig(**params)


# ---------------------------------------------------------------------------
# Family generators.  Each returns a Workload; shapes/strategy are
# controlled by **cfg overrides so a whole zoo can share one static
# signature (= one batch).


def bursty(n_agents: int = 8, n_artifacts: int = 6, seed: int = 0,
           n_runs: int = 10, n_writers: int = 2, hot_rate: float = 0.9,
           cold_rate: float = 0.02, write_locality: float = 0.25,
           **cfg) -> Workload:
    """A small clique of hot writers; the rest of the fleet reads."""
    n, m = n_agents, n_artifacts
    wr = np.full((n, m), cold_rate)
    wr[:n_writers, :] = hot_rate
    p_act = np.full(n, 0.6)
    p_act[:n_writers] = 0.9
    return Workload(
        name=f"bursty w={n_writers}", family="bursty",
        acs=_base_cfg(n, m, **cfg), p_act=p_act,
        pick=_uniform_rows(n, m), write_rate=wr, seed=seed,
        n_runs=n_runs, write_locality=write_locality,
        description=f"{n_writers} agents carry ~all writes at "
                    f"rate {hot_rate}; others read at {cold_rate}.")


def zipf(n_agents: int = 8, n_artifacts: int = 6, seed: int = 0,
         n_runs: int = 10, skew: float = 1.2, volatility: float = 0.15,
         write_locality: float = 0.4, **cfg) -> Workload:
    """Hot/cold artifact skew: Zipf(s) selection, uniform write rate."""
    n, m = n_agents, n_artifacts
    pick = np.tile(zipf_weights(m, skew), (n, 1))
    return Workload(
        name=f"zipf s={skew}", family="zipf",
        acs=_base_cfg(n, m, **cfg), p_act=np.full(n, 0.75),
        pick=pick, write_rate=np.full((n, m), volatility), seed=seed,
        n_runs=n_runs, write_locality=write_locality,
        description=f"Zipf({skew}) artifact selection, uniform "
                    f"V={volatility}.")


def hierarchical(n_agents: int = 8, n_artifacts: int = 6, seed: int = 0,
                 n_runs: int = 10, plan_write: float = 0.35,
                 out_write: float = 0.55,
                 write_locality: float = 0.2, **cfg) -> Workload:
    """Planner/worker team: agent 0 rewrites the plan (artifact 0) and
    monitors outputs; workers read the plan and write their own output
    artifact (1 + (a-1) mod (m-1))."""
    n, m = n_agents, n_artifacts
    if m < 2:
        raise ValueError("hierarchical needs >= 2 artifacts")
    pick = np.zeros((n, m))
    wr = np.zeros((n, m))
    # planner: 60% plan focus, 40% spread over worker outputs
    pick[0, 0] = 0.6
    pick[0, 1:] = 0.4 / (m - 1)
    wr[0, 0] = plan_write
    for a in range(1, n):
        own = 1 + (a - 1) % (m - 1)
        pick[a, 0] = 0.5          # read the plan
        pick[a, own] = 0.5        # work on own output
        wr[a, own] = out_write
    return Workload(
        name="hierarchical", family="hierarchical",
        acs=_base_cfg(n, m, **cfg), p_act=np.full(n, 0.8),
        pick=pick, write_rate=wr, seed=seed, n_runs=n_runs,
        write_locality=write_locality,
        description="1 planner rewriting the plan; workers read plan, "
                    "write private outputs.")


def rag(n_agents: int = 8, n_artifacts: int = 6, seed: int = 0,
        n_runs: int = 10, skew: float = 1.1, read_write: float = 0.01,
        refresh_write: float = 0.25, write_locality: float = 0.1,
        **cfg) -> Workload:
    """Read-heavy retrieval: everyone reads Zipf-hot corpus shards;
    one index-refresher agent occasionally rewrites the hot shards."""
    n, m = n_agents, n_artifacts
    pick = np.tile(zipf_weights(m, skew), (n, 1))
    wr = np.full((n, m), read_write)
    wr[n - 1, :] = refresh_write * zipf_weights(m, skew) / zipf_weights(
        m, skew).max()
    return Workload(
        name="rag read-heavy", family="rag",
        acs=_base_cfg(n, m, **cfg), p_act=np.full(n, 0.85),
        pick=pick, write_rate=wr, seed=seed, n_runs=n_runs,
        write_locality=write_locality,
        description="near-zero write rates except one index refresher.")


def pipeline(n_agents: int = 8, n_artifacts: int = 6, seed: int = 0,
             n_runs: int = 10, produce_rate: float = 0.7,
             write_locality: float = 0.5, **cfg) -> Workload:
    """Pipeline-DAG handoff: stage i consumes artifact i mod m and
    produces artifact (i+1) mod m."""
    n, m = n_agents, n_artifacts
    pick = np.zeros((n, m))
    wr = np.zeros((n, m))
    for a in range(n):
        upstream, own = a % m, (a + 1) % m
        if upstream == own:       # m == 1 degenerate case
            pick[a, own] = 1.0
        else:
            pick[a, upstream] = 0.5
            pick[a, own] = 0.5
        wr[a, own] = produce_rate
    return Workload(
        name="pipeline dag", family="pipeline",
        acs=_base_cfg(n, m, **cfg), p_act=np.full(n, 0.75),
        pick=pick, write_rate=wr, seed=seed, n_runs=n_runs,
        write_locality=write_locality,
        description="stage i reads artifact i, writes artifact i+1.")


def ping_pong(n_agents: int = 8, n_artifacts: int = 6, seed: int = 0,
              n_runs: int = 10, spectator_focus: float = 0.7,
              write_locality: float = 0.15, **cfg) -> Workload:
    """Adversarial write ping-pong: two agents write the same contended
    artifact every action; spectators keep trying to read it.  The
    worst case for invalidation protocols - every write invalidates
    every reader, so coherent traffic approaches broadcast."""
    n, m = n_agents, n_artifacts
    if n < 2:
        raise ValueError("ping_pong needs >= 2 agents")
    pick = np.zeros((n, m))
    wr = np.zeros((n, m))
    pick[:2, 0] = 1.0
    wr[:2, 0] = 1.0
    for a in range(2, n):
        if m == 1:
            pick[a, 0] = 1.0
        else:
            pick[a, 0] = spectator_focus
            pick[a, 1:] = (1.0 - spectator_focus) / (m - 1)
    p_act = np.full(n, 0.5)
    p_act[:2] = 1.0
    return Workload(
        name="write ping-pong", family="ping_pong",
        acs=_base_cfg(n, m, **cfg), p_act=p_act,
        pick=pick, write_rate=wr, seed=seed, n_runs=n_runs,
        write_locality=write_locality,
        description="2 agents alternate writes to one hot artifact; "
                    "spectators read it.")


FAMILIES: Dict[str, Callable[..., Workload]] = {
    "bursty": bursty,
    "zipf": zipf,
    "hierarchical": hierarchical,
    "rag": rag,
    "pipeline": pipeline,
    "ping_pong": ping_pong,
}

#: deterministic per-family seeds (same convention as SS8.1 scenarios).
FAMILY_SEEDS = {f: 20260401 + i for i, f in enumerate(FAMILIES)}


def make(family: str, **kw) -> Workload:
    """Build one family instance; unknown keys go to the ACS config."""
    try:
        builder = FAMILIES[family]
    except KeyError:
        raise KeyError(
            f"unknown workload family {family!r}; "
            f"have {sorted(FAMILIES)}") from None
    kw.setdefault("seed", FAMILY_SEEDS[family])
    return builder(**kw)


def zoo(n_agents: int = 8, n_artifacts: int = 6, n_runs: int = 10,
        families: Sequence[str] = tuple(FAMILIES),
        **cfg) -> list[Workload]:
    """The standard workload zoo: one instance per family, all sharing
    one static signature so ``compare_workloads`` runs the whole zoo
    as one batch."""
    return [make(f, n_agents=n_agents, n_artifacts=n_artifacts,
                 n_runs=n_runs, **cfg) for f in families]


def random_workload(seed: int, n_agents: int = 4, n_artifacts: int = 3,
                    n_runs: int = 4, **cfg) -> Workload:
    """A fully random rate-matrix workload (property-test fodder):
    Dirichlet selection rows, iid uniform write rates and activities."""
    rng = np.random.default_rng(seed)
    n, m = n_agents, n_artifacts
    return Workload(
        name=f"random-{seed}", family="random",
        acs=_base_cfg(n, m, **cfg),
        p_act=rng.uniform(0.2, 1.0, n),
        pick=rng.dirichlet(np.ones(m), size=n),
        write_rate=rng.uniform(0.0, 1.0, (n, m)),
        seed=seed, n_runs=n_runs,
        write_locality=float(rng.uniform(0.05, 1.0)),
        description="random rates (hypothesis property tests).")
