"""The three verified invariants of CCS (paper SS6.2), as predicates.

These run over the vectorized ACS arrays (as numpy arrays: pass a
tensor through ``.cpu().numpy()``), one simulation at a time.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.states import MESIState

_M = int(MESIState.M)


def single_writer(state_matrix) -> bool:
    """Invariant 1 (SWMR): at most one agent in M per artifact.

    ``state_matrix``: (n_agents, n_artifacts) int array.
    """
    s = np.asarray(state_matrix)
    return bool(((s == _M).sum(axis=0) <= 1).all())


def monotonic_version(version_before, version_after) -> bool:
    """Invariant 2: artifactVersion'(d) >= artifactVersion(d), elementwise."""
    return bool(
        (np.asarray(version_after) >= np.asarray(version_before)).all())


def bounded_staleness(agent_steps, last_sync, k: int) -> bool:
    """Invariant 3: agentSteps[a] - lastSync[a] <= K for every agent.

    Follows the paper's TLA+ spec literally: ``agent_steps`` and
    ``last_sync`` are per-agent counters (steps executed vs version at
    last sync).
    """
    steps = np.asarray(agent_steps)
    sync = np.asarray(last_sync)
    return bool(((steps - sync) <= k).all())


def exclusive_means_alone(state_matrix) -> bool:
    """Auxiliary MESI sanity: if any agent holds E or M on d, every other
    agent holds I on d (strict exclusivity).  Stronger than SWMR; holds
    for the protocol as specified (upgrade invalidates all peers)."""
    s = np.asarray(state_matrix)
    excl = (s >= int(MESIState.E))
    valid = (s >= int(MESIState.S))
    n_excl = excl.sum(axis=0)
    n_valid = valid.sum(axis=0)
    # wherever someone is exclusive, exactly one valid copy exists
    return bool((np.where(n_excl > 0, n_valid == 1, True)).all())
