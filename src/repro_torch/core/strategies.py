"""Synchronization strategy registry (paper SS5.5).

Strategy semantics live in ``repro_torch.core.acs`` (vectorized) and
``repro_torch.core.protocol`` (message-level); this module is the shared
config surface the launcher / adapters expose.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import acs


@dataclasses.dataclass(frozen=True)
class SyncStrategy:
    name: str
    code: int
    description: str
    enforces_staleness_bound: bool = True


REGISTRY: dict[str, SyncStrategy] = {
    "broadcast": SyncStrategy(
        "broadcast", acs.BROADCAST,
        "Full-state rebroadcast every step (the naive baseline)."),
    "eager": SyncStrategy(
        "eager", acs.EAGER,
        "Invalidate on upgrade grant; push fresh content to active "
        "sharers at commit (update-style; minimizes staleness window).",
        enforces_staleness_bound=False),  # paper SS8.2: eager does not
    "lazy": SyncStrategy(
        "lazy", acs.LAZY,
        "Invalidate on commit only; fetch-on-demand. Recommended default."),
    "ttl": SyncStrategy(
        "ttl", acs.TTL,
        "Epoch lease refresh decoupled from write activity."),
    "access_count": SyncStrategy(
        "access_count", acs.ACCESS_COUNT,
        "Lazy + entries expire after k reads (OpenID execution-count "
        "credential analogue)."),
}


def get(name: str) -> SyncStrategy:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; one of {sorted(REGISTRY)}"
        ) from None
