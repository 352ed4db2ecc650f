"""Per-request span tracing with Chrome trace-event export.

Every request the broker resolves becomes one *complete* span
(``ph: "X"``) covering submit -> respond, with the phase breakdown
(queue wait, decide, apply) attached as args; every committed
micro-batch becomes one ``decide`` span on the authority lane.  Spans
are recorded *at resolve time* from timestamps the broker already
holds, so there is no open-span bookkeeping on the hot path - one
append into a bounded ring per request.

``chrome_trace()`` dumps the ring in the Chrome trace-event JSON format
(load in ``chrome://tracing`` / Perfetto): ``pid`` is the authority
shard, ``tid`` the agent (or ``authority`` for batch spans), ``ts`` /
``dur`` are microseconds relative to the recorder's epoch.
"""

from __future__ import annotations

import collections
import json
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str        # e.g. "read artifact-3" / "decide"
    cat: str         # "request" | "batch" | "compile"
    ts_s: float      # start, seconds on the recorder's perf_counter axis
    dur_s: float
    pid: int         # authority shard
    tid: object      # agent id, or "authority"
    args: dict


class SpanRecorder:
    """Bounded ring of completed spans.

    ``n_recorded`` counts every span ever added (exact, survives ring
    wrap) - the span-lifecycle tests assert it equals the number of
    resolved requests plus committed batches.
    """

    def __init__(self, capacity: int = 1 << 14) -> None:
        self.capacity = capacity
        self.spans = collections.deque(maxlen=capacity)
        self.n_recorded = 0
        self.epoch = time.perf_counter()

    def add(self, name: str, cat: str, ts_s: float, dur_s: float,
            pid: int = 0, tid: object = 0, **args) -> None:
        self.spans.append(Span(name, cat, ts_s, max(0.0, dur_s),
                               int(pid), tid, args))
        self.n_recorded += 1

    # ------------------------------------------------------ exposition
    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace-event JSON object."""
        events = []
        for s in self.spans:
            events.append({
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": (s.ts_s - self.epoch) * 1e6,
                "dur": s.dur_s * 1e6,
                "pid": s.pid,
                "tid": (s.tid if isinstance(s.tid, int)
                        else str(s.tid)),
                "args": dict(s.args),
            })
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"n_recorded": self.n_recorded,
                              "capacity": self.capacity}}

    def to_chrome_json(self) -> str:
        return json.dumps(self.chrome_trace(), indent=2, default=float)
