"""MESI coherence states for the Artifact Coherence System (ACS).

The paper (Def. 1/2) maps hardware MESI states onto artifact authorization
states with the identity mapping phi.  We encode the four stable states as
small integers so the whole (agents x artifacts) state matrix is a dense
int32 tensor that torch and the CUDA kernels can transition in bulk.

State encoding (order chosen so that ``state >= S`` is the validity
predicate T from Def. 1):

    I = 0   Invalid   - cached copy stale; coherence fill required
    S = 1   Shared    - valid here and possibly elsewhere
    E = 2   Exclusive - only copy, identical to authority; silent write ok
    M = 3   Modified  - only valid copy; authority stale
"""

from __future__ import annotations

import enum

import numpy as np


class MESIState(enum.IntEnum):
    """Stable coherence states, Sigma = {M, E, S, I} (paper Def. 1)."""

    I = 0  # noqa: E741 - paper notation
    S = 1
    E = 2
    M = 3


# Event alphabet E for the transition function delta (paper Def. 1).
class CoherenceEvent(enum.IntEnum):
    LOCAL_READ = 0      # agent reads its own cached copy
    LOCAL_WRITE = 1     # agent writes (requires E; produces M)
    UPGRADE = 2         # S -> E ownership acquisition (invalidates peers)
    FETCH = 3           # I -> S coherence fill from authority
    REMOTE_WRITE = 4    # peer acquired ownership -> our copy invalidated
    COMMIT = 5          # writer publishes: M -> S, version++


#: delta: Sigma x Event -> Sigma, dense table (rows = state, cols = event).
#: -1 marks transitions that are illegal in the protocol (guarded by the
#: caller; the model checker asserts they are never taken).
TRANSITION_TABLE = np.full((4, 6), -1, dtype=np.int32)
# LOCAL_READ: any valid state self-loops; reading from I is illegal
TRANSITION_TABLE[MESIState.S, CoherenceEvent.LOCAL_READ] = MESIState.S
TRANSITION_TABLE[MESIState.E, CoherenceEvent.LOCAL_READ] = MESIState.E
TRANSITION_TABLE[MESIState.M, CoherenceEvent.LOCAL_READ] = MESIState.M
# LOCAL_WRITE: requires exclusivity
TRANSITION_TABLE[MESIState.E, CoherenceEvent.LOCAL_WRITE] = MESIState.M
TRANSITION_TABLE[MESIState.M, CoherenceEvent.LOCAL_WRITE] = MESIState.M
# UPGRADE: S -> E (authority invalidates peers as a side effect)
TRANSITION_TABLE[MESIState.S, CoherenceEvent.UPGRADE] = MESIState.E
TRANSITION_TABLE[MESIState.E, CoherenceEvent.UPGRADE] = MESIState.E
# FETCH: I -> S
TRANSITION_TABLE[MESIState.I, CoherenceEvent.FETCH] = MESIState.S
# REMOTE_WRITE: every state collapses to I (the invalidation rule)
TRANSITION_TABLE[MESIState.I, CoherenceEvent.REMOTE_WRITE] = MESIState.I
TRANSITION_TABLE[MESIState.S, CoherenceEvent.REMOTE_WRITE] = MESIState.I
TRANSITION_TABLE[MESIState.E, CoherenceEvent.REMOTE_WRITE] = MESIState.I
TRANSITION_TABLE[MESIState.M, CoherenceEvent.REMOTE_WRITE] = MESIState.I
# COMMIT: M -> S (writer publishes and downgrades)
TRANSITION_TABLE[MESIState.M, CoherenceEvent.COMMIT] = MESIState.S


def is_valid(state: int) -> bool:
    """Validity predicate T (Def. 1): T(I)=0, T(S)=T(E)=T(M)=1."""
    return int(state) >= MESIState.S


def transition(state: int, event: int) -> int:
    """Scalar delta; raises on illegal transitions (protocol bug)."""
    nxt = int(TRANSITION_TABLE[int(state), int(event)])
    if nxt < 0:
        raise ValueError(
            f"illegal transition: delta({MESIState(state).name}, "
            f"{CoherenceEvent(event).name})"
        )
    return nxt


STATE_NAMES = {s.value: s.name for s in MESIState}
