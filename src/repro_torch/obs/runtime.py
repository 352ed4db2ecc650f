"""Decision-route readiness: process-global compile-event log.

The port compiles nothing per broker config: the scan route is eager
PyTorch and the kernel route's CUDA libraries are built once per
process by ``repro_torch.kernels.build`` at their first launch.  The
log keeps the reference's two event kinds and their counts, with
these meanings here:

  ``trace``   ``note_compile``: the scan route's per-config closure was
              made (``repro_torch.service.batching._scan_decider``, an
              ``lru_cache`` keyed on the static config).  It fires once
              per config and process, where the JAX package fires once
              per jit trace of the same config, so the counts agree.
  ``warmup``  ``note_warmup``: a decider's first ``decide`` call, timed
              on the host.  On a fresh machine the first kernel-route
              call builds the CUDA libraries (nvcc), so its seconds are
              a build, not a dispatch; after the libraries exist they
              are the first dispatch with its allocations.

Telemetry snapshots read the log; the conformance leg excludes it
(events are process-global and timing-dependent by nature).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

_LOCK = threading.Lock()
_EVENTS: List[dict] = []
#: perf_counter epoch for event timestamps (Chrome trace alignment)
_T0 = time.perf_counter()


def epoch() -> float:
    """perf_counter value this module's event timestamps are relative
    to (for aligning compile events onto a span recorder's axis)."""
    return _T0


def note_compile(route: str, label: str = "") -> None:
    """Record one decision route made ready for a config (the scan
    route's per-config closure); fires once per config and process."""
    with _LOCK:
        _EVENTS.append({"kind": "trace", "route": route, "label": label,
                        "t_s": time.perf_counter() - _T0,
                        "dur_s": 0.0})


def note_warmup(route: str, dur_s: float, label: str = "") -> None:
    """Record a decision route's measured first-call wall time (a kernel
    build, where the libraries were not yet built, + first dispatch)."""
    with _LOCK:
        _EVENTS.append({"kind": "warmup", "route": route, "label": label,
                        "t_s": time.perf_counter() - _T0 - dur_s,
                        "dur_s": dur_s})


def compile_events() -> List[dict]:
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def compile_count(route: Optional[str] = None,
                  kind: str = "trace") -> int:
    with _LOCK:
        return sum(1 for e in _EVENTS
                   if e["kind"] == kind
                   and (route is None or e["route"] == route))


def reset_compile_log() -> None:
    with _LOCK:
        _EVENTS.clear()
