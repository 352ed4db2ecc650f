"""Logical clocks for version ordering (paper SS7.3).

The authority assigns monotonically increasing integer versions at commit
time; a per-agent vector clock establishes the partial (happens-before)
order over writes across artifacts, following Lamport [10] / Mattern [13].
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class VectorClock:
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def tick(self, agent_id: str) -> "VectorClock":
        c = dict(self.counters)
        c[agent_id] = c.get(agent_id, 0) + 1
        return VectorClock(c)

    def merge(self, other: "VectorClock") -> "VectorClock":
        keys = set(self.counters) | set(other.counters)
        return VectorClock({
            k: max(self.counters.get(k, 0), other.counters.get(k, 0))
            for k in keys})

    def happens_before(self, other: "VectorClock") -> bool:
        """self < other in the strict causal order."""
        keys = set(self.counters) | set(other.counters)
        le = all(self.counters.get(k, 0) <= other.counters.get(k, 0)
                 for k in keys)
        lt = any(self.counters.get(k, 0) < other.counters.get(k, 0)
                 for k in keys)
        return le and lt

    def concurrent(self, other: "VectorClock") -> bool:
        return (not self.happens_before(other)
                and not other.happens_before(self)
                and self.counters != other.counters)


class MonotonicVersioner:
    """Authority-side version assignment (Invariant 2 by construction)."""

    def __init__(self) -> None:
        self._versions: Dict[str, int] = {}

    def current(self, artifact_id: str) -> int:
        return self._versions.get(artifact_id, 1)

    def bump(self, artifact_id: str) -> int:
        v = self.current(artifact_id) + 1
        self._versions[artifact_id] = v
        return v
