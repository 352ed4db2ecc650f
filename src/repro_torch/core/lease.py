"""Lease-TTL recovery for orphaned exclusive locks (paper SS5.2 / AS3).

When the authority grants an Exclusive write lock it starts a lease timer
tau.  If COMMIT does not arrive within tau, the lock is treated as
orphaned: the authority reverts to the last committed version, invalidates
everyone, and releases the grant.  Liveness under agent crash at the cost
of losing in-progress writes.

Time here is a logical clock supplied by the caller (the orchestrator's
tick counter in simulation, wall-clock seconds in a deployment).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Lease:
    agent_id: str
    artifact_id: str
    granted_at: float
    ttl: float

    def expired(self, now: float) -> bool:
        return now - self.granted_at >= self.ttl


class LeaseTable:
    DEFAULT_TTL = 30.0  # paper default: 30 s

    def __init__(self, default_ttl: float = DEFAULT_TTL) -> None:
        self.default_ttl = default_ttl
        self._leases: Dict[str, Lease] = {}  # artifact_id -> lease

    def grant(self, agent_id: str, artifact_id: str, now: float,
              ttl: Optional[float] = None) -> Lease:
        if artifact_id in self._leases:
            raise RuntimeError(
                f"artifact {artifact_id!r} already leased to "
                f"{self._leases[artifact_id].agent_id!r}")
        lease = Lease(agent_id, artifact_id, now,
                      self.default_ttl if ttl is None else ttl)
        self._leases[artifact_id] = lease
        return lease

    def holder(self, artifact_id: str) -> Optional[str]:
        lease = self._leases.get(artifact_id)
        return lease.agent_id if lease else None

    def release(self, agent_id: str, artifact_id: str) -> None:
        lease = self._leases.get(artifact_id)
        if lease is None or lease.agent_id != agent_id:
            raise RuntimeError(
                f"{agent_id!r} does not hold a lease on {artifact_id!r}")
        del self._leases[artifact_id]

    def collect_expired(self, now: float) -> List[Lease]:
        """Remove and return all expired leases (authority recovery)."""
        expired = [l for l in self._leases.values() if l.expired(now)]
        for lease in expired:
            del self._leases[lease.artifact_id]
        return expired
