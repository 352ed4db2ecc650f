"""Coherence-gated multi-agent LLM serving - the paper's technique as a
first-class runtime feature.

The translation of "token cost" to serving: injecting an
artifact into an agent's context costs a *prefill pass* over its tokens;
a coherent cached copy costs nothing.  Each agent's context is laid out
as

    [ artifact_0 | artifact_1 | ... | artifact_{m-1} | dialogue ]

with prefix-cache semantics: re-fetching artifact i invalidates the KV
suffix from artifact i's offset, so the re-prefill cost is every token
from that offset to the end of the resident context.  The MESI layer
(repro_torch.core.protocol) decides *when* a fetch is needed; this module
converts those decisions into real prefill compute on a zoo backbone
and accounts both tokens and FLOPs.

Beyond the paper: ``volatility_sorted=True`` enables the
*volatility-sorted suffix* layout policy: whenever an invalidation
forces a KV-suffix recompute anyway, the artifacts inside that (already
dead) suffix are re-ordered by ascending observed write count.  The
re-order is free at that moment, avoids the thrash of naive
move-to-back under multiple hot artifacts, and converges the layout to
ascending volatility so future invalidations land on the shortest
possible suffix - an optimization structurally unavailable to
flat-broadcast systems and absent from the paper.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.protocol import (AgentRuntime, ArtifactStore,
                                       CoordinatorService, EventBus)
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class ServingStats:
    prefill_tokens: int = 0          # tokens actually re-prefilled
    broadcast_tokens: int = 0        # what naive rebroadcast would pay
    prefill_flops: float = 0.0
    broadcast_flops: float = 0.0
    fetches: int = 0
    cache_hits: int = 0

    @property
    def token_savings(self) -> float:
        return 1.0 - self.prefill_tokens / max(self.broadcast_tokens, 1)

    @property
    def flops_savings(self) -> float:
        return 1.0 - self.prefill_flops / max(self.broadcast_flops, 1.0)


class CoherentAgent:
    """One serving agent: protocol client + KV prefix cache.

    ``layout`` is the placement order of resident artifacts in the
    context (prefix-cache order); first-time fetches always append at
    the end (nothing after them to recompute)."""

    def __init__(self, agent_id: str, coordinator, bus,
                 artifact_order: list[str], strategy: str) -> None:
        self.runtime = AgentRuntime(agent_id, coordinator, bus,
                                    strategy=strategy)
        self.layout: list[str] = []          # resident placement order
        self.resident: dict[str, int] = {}   # artifact -> token length

    def offset_of(self, artifact_id: str) -> int:
        off = 0
        for a in self.layout:
            if a == artifact_id:
                return off
            off += self.resident.get(a, 0)
        return off

    def resident_total(self) -> int:
        return sum(self.resident.get(a, 0) for a in self.layout)


class CoherentServingSystem:
    """n agents x m artifacts served against one backbone."""

    def __init__(self, cfg: ModelConfig, n_agents: int,
                 artifacts: dict[str, list[int]],
                 strategy: str = "lazy",
                 volatility_sorted: bool = False,
                 n_active_params: Optional[int] = None,
                 device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.strategy = strategy
        self.volatility_sorted = volatility_sorted
        self.n_active = n_active_params or 1
        self.bus = EventBus()
        self.store = ArtifactStore()
        self.coordinator = CoordinatorService(self.bus, self.store,
                                              strategy=strategy)
        order = list(artifacts)
        for aid, content in artifacts.items():
            self.coordinator.register_artifact(aid, content)
        self.agents = [
            CoherentAgent(f"agent-{i}", self.coordinator, self.bus,
                          order, strategy)
            for i in range(n_agents)]
        self.write_counts = {a: 0 for a in artifacts}
        self.stats = ServingStats()

    # ------------------------- accounting -----------------------------
    def _prefill_cost(self, n_tokens: int) -> float:
        return 2.0 * self.n_active * n_tokens

    def _sort_suffix(self, agent: CoherentAgent,
                     artifact_id: str) -> None:
        """Re-order the dead KV suffix (from artifact_id onward) by
        ascending coordinator-observed write count - free, because that
        region is being re-prefilled regardless."""
        idx = agent.layout.index(artifact_id)
        suffix = sorted(agent.layout[idx:],
                        key=lambda a: self.write_counts[a])
        agent.layout = agent.layout[:idx] + suffix

    # --------------------------- operations ---------------------------
    def agent_read(self, agent_idx: int, artifact_id: str) -> None:
        """Agent consumes an artifact: coherence check -> maybe fetch ->
        maybe KV suffix re-prefill."""
        agent = self.agents[agent_idx]
        before = self.coordinator.ledger.n_fetches
        content = agent.runtime.read(artifact_id)
        fetched = self.coordinator.ledger.n_fetches > before

        # broadcast baseline would re-inject EVERY artifact each access
        total_ctx = sum(len(self.store.get(a))
                        for a in self.write_counts)
        self.stats.broadcast_tokens += total_ctx
        self.stats.broadcast_flops += self._prefill_cost(total_ctx)

        if fetched:
            self.stats.fetches += 1
            if artifact_id in agent.resident:
                # invalidated re-fetch: the KV suffix from its old
                # offset is dead either way; re-ordering inside it is
                # free, so sort that region by ascending write count.
                offset = agent.offset_of(artifact_id)
                recompute = agent.resident_total() - offset
                if self.volatility_sorted:
                    self._sort_suffix(agent, artifact_id)
            else:
                # first placement: append at the end - nothing after it
                agent.layout.append(artifact_id)
                recompute = len(content)
            agent.resident[artifact_id] = len(content)
            self.stats.prefill_tokens += recompute
            self.stats.prefill_flops += self._prefill_cost(recompute)
        else:
            self.stats.cache_hits += 1

    def agent_write(self, agent_idx: int, artifact_id: str,
                    new_content: list[int]) -> None:
        agent = self.agents[agent_idx]
        agent.runtime.write(artifact_id, new_content)
        self.write_counts[artifact_id] += 1
        # The writer's own KV for this artifact region is now stale:
        # it pays the suffix re-prefill immediately (peers pay lazily
        # on their next read via the coherence protocol).
        if artifact_id in agent.resident:
            offset = agent.offset_of(artifact_id)
            recompute = agent.resident_total() - offset
            if self.volatility_sorted:
                self._sort_suffix(agent, artifact_id)
        else:
            agent.layout.append(artifact_id)
            recompute = len(new_content)
        agent.resident[artifact_id] = len(new_content)
        self.stats.prefill_tokens += recompute
        self.stats.prefill_flops += self._prefill_cost(recompute)

    # ----------------------- real model prefill -----------------------
    def context_tokens(self, agent_idx: int) -> list[int]:
        """The agent's resident context, in layout order, as token ids
        of the backbone's vocabulary."""
        tokens = []
        for a in self.agents[agent_idx].layout:
            tokens.extend(int(t) % self.cfg.vocab_size
                          for t in self.store.get(a))
        return tokens

    def materialize_prefill(self, params, agent_idx: int,
                            max_len: int = 256, context=None):
        """Run an actual prefill of the agent's current context through
        the backbone, on the system's device - proves the accounting
        maps to real compute and returns the last-token logits (1, 1,
        V).  ``context`` (1, T, d): the frames or vision embeddings of a
        model with cross layers."""
        tokens = self.context_tokens(agent_idx)[:max_len] or [1]
        tok = torch.tensor(tokens, dtype=torch.int64,
                           device=self.device)[None, :]
        cache = tf.init_cache(self.cfg, 1, max_len,
                              ctx_len=0 if context is None
                              else context.shape[1], device=self.device)
        logits, cache = tf.prefill(params, self.cfg, tok, cache,
                                   context=context)
        return logits


def run_workload(system: CoherentServingSystem, n_steps: int,
                 volatility, seed: int = 0,
                 p_act: float = 0.75) -> ServingStats:
    """Drive the serving system with the paper's SS8.1 workload.

    ``volatility`` may be a scalar (uniform V) or a per-artifact list -
    real deployments have skewed write rates (a plan document vs a
    scratchpad), which is where layout policies matter."""
    rng = np.random.default_rng(seed)
    artifact_ids = list(system.write_counts)
    if isinstance(volatility, (int, float)):
        v_of = {a: float(volatility) for a in artifact_ids}
    else:
        v_of = dict(zip(artifact_ids, volatility))
    n = len(system.agents)
    for _ in range(n_steps):
        for a in range(n):
            if rng.random() > p_act:
                continue
            aid = artifact_ids[rng.integers(len(artifact_ids))]
            if rng.random() < v_of[aid]:
                old = list(system.store.get(aid))
                system.agent_write(a, aid, old)  # same-size revision
                system.agent_read(a, aid)
            else:
                system.agent_read(a, aid)
    return system.stats
