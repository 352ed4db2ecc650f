"""``repro_torch.obs`` - the coherence telemetry plane (the port of
``repro.obs``).

MESI perf counters, per-request span tracing and oracle-verified
metrics for the live coherence service:

  * :mod:`repro_torch.obs.registry` - exact counters / gauges / ring-buffer
    histograms with Prometheus text + JSON snapshot exposition;
  * :mod:`repro_torch.obs.telemetry` - the per-authority ``Telemetry``
    facade: one ``record_batch`` hook per committed micro-batch feeds
    the MESI detectors (invalidation events/storms, ping-pong,
    staleness-at-serve, state occupancy) and the span recorder;
  * :mod:`repro_torch.obs.spans` - Chrome trace-event export
    (``chrome://tracing`` / Perfetto flame graphs);
  * :mod:`repro_torch.obs.runtime` - process-global log of decision
    routes being made ready (a scan closure built, a route's first
    call timed);
  * :mod:`repro_torch.obs.stats` - the unified ``stats()`` schema both
    broker flavors serve (with the legacy flat-key deprecation shim);
  * :mod:`repro_torch.obs.conformance` - the ``MetricsConformance`` oracle
    leg: every replayable counter recomputed from the captured
    ``ServiceTrace`` and asserted bit-identical to the live registry.

See ``docs/observability.md`` for the metric catalog and the
MESI-analogue rationale behind each counter.
"""

from repro_torch.obs.conformance import (CONFORMANCE_COUNTERS,
                                         CONFORMANCE_HISTOGRAMS,
                                         MetricsConformanceError,
                                         check_metrics_conformance,
                                         replay_telemetry)
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.runtime import (compile_count, compile_events,
                                     note_compile, note_warmup,
                                     reset_compile_log)
from repro_torch.obs.spans import Span, SpanRecorder
from repro_torch.obs.stats import LEGACY_KEYS, StatsView, unified_stats
from repro_torch.obs.telemetry import BatchObservation, Telemetry

__all__ = [
    "BatchObservation",
    "CONFORMANCE_COUNTERS",
    "CONFORMANCE_HISTOGRAMS",
    "Counter",
    "Gauge",
    "Histogram",
    "LEGACY_KEYS",
    "MetricsConformanceError",
    "MetricsRegistry",
    "Span",
    "SpanRecorder",
    "StatsView",
    "Telemetry",
    "check_metrics_conformance",
    "compile_count",
    "compile_events",
    "note_compile",
    "note_warmup",
    "replay_telemetry",
    "reset_compile_log",
    "unified_stats",
]
