"""Metrics registry: exact counters, gauges and ring-buffer histograms.

Hardware MESI controllers are debuggable because every coherence event
increments a perf counter; this registry is that surface for the live
coherence service.  Design constraints, in order:

  1. **Exactness.**  Counters are plain Python ints (no float drift,
     no sampling), because the ``MetricsConformance`` oracle leg
     (``repro_torch.obs.conformance``) asserts them *bit-identical* to a
     ``ServiceTrace`` replay.  Histograms keep an exact ``count`` and
     ``sum`` even after the ring buffer wraps, so conformance can
     compare those two integers while percentiles stay bounded-memory.
  2. **Low overhead.**  One dict lookup + int add per increment; label
     sets are sorted key/value tuples interned per call site.
  3. **Two exposition formats** from one store: Prometheus text
     (``to_prometheus``) and a JSON-able snapshot (``snapshot``), the
     schema both ``stats()`` surfaces and the TCP ``metrics`` verb
     serve.

Nothing here imports torch or the service layer - the registry is a leaf
module the whole system can depend on.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _prom_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotone exact counter, one cell per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.cells: Dict[LabelKey, int] = {}

    def inc(self, value: int = 1, **labels) -> None:
        key = _labelkey(labels)
        self.cells[key] = self.cells.get(key, 0) + value

    def inc_key(self, key: LabelKey, value: int = 1) -> None:
        """Hot-path increment with a pre-built label key (see
        ``_labelkey``) - skips per-call key construction."""
        self.cells[key] = self.cells.get(key, 0) + value

    def value(self, **labels) -> int:
        return self.cells.get(_labelkey(labels), 0)

    def total(self):
        return sum(self.cells.values())

    def items(self):
        return sorted(self.cells.items())


class Gauge:
    """Last-observation-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.cells: Dict[LabelKey, float] = {}

    def set(self, value, **labels) -> None:
        self.cells[_labelkey(labels)] = value

    def value(self, **labels):
        return self.cells.get(_labelkey(labels), 0)

    def items(self):
        return sorted(self.cells.items())


class _HistCell:
    """One label set's histogram state: exact count/sum/min/max plus a
    bounded ring buffer of recent samples for percentiles."""

    __slots__ = ("count", "sum", "min", "max", "ring")

    def __init__(self, window: int) -> None:
        self.count = 0
        self.sum = 0
        self.min = math.inf
        self.max = -math.inf
        self.ring = collections.deque(maxlen=window)

    def observe(self, value) -> None:
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        self.ring.append(value)

    def percentile(self, q: float):
        if not self.ring:
            return 0.0
        data = sorted(self.ring)
        idx = min(len(data) - 1, max(0, round(q / 100 * (len(data) - 1))))
        return data[idx]


class Histogram:
    """Ring-buffer histogram: exact count/sum forever, percentiles over
    the last ``window`` samples (bounds memory under open-ended load,
    same rationale as the broker's latency deque)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 window: int = 4096) -> None:
        self.name = name
        self.help = help
        self.window = window
        self.cells: Dict[LabelKey, _HistCell] = {}

    def observe(self, value, **labels) -> None:
        key = _labelkey(labels)
        cell = self.cells.get(key)
        if cell is None:
            cell = self.cells[key] = _HistCell(self.window)
        cell.observe(value)

    def cell(self, **labels) -> Optional[_HistCell]:
        return self.cells.get(_labelkey(labels))

    def cell_key(self, key: LabelKey) -> _HistCell:
        """Hot-path get-or-create with a pre-built label key."""
        cell = self.cells.get(key)
        if cell is None:
            cell = self.cells[key] = _HistCell(self.window)
        return cell

    def items(self):
        return sorted(self.cells.items())


class MetricsRegistry:
    """Named metric store with on-first-use creation.

    ``counter`` / ``gauge`` / ``histogram`` return the live metric
    object (creating it if needed); re-registration with the same name
    returns the existing instance, so every layer of the service can
    hold its own handle to the same cell.
    """

    def __init__(self) -> None:
        self.metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        metric = self.metrics.get(name)
        if metric is None:
            metric = self.metrics[name] = cls(name, help, **kw)
        elif not isinstance(metric, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(metric).__name__}, not {cls.__name__}")
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  window: int = 4096) -> Histogram:
        return self._get(Histogram, name, help, window=window)

    # ------------------------------------------------------ inspection
    def counter_value(self, name: str, **labels) -> int:
        metric = self.metrics.get(name)
        return metric.value(**labels) if metric is not None else 0

    def counter_total(self, name: str):
        metric = self.metrics.get(name)
        return metric.total() if metric is not None else 0

    def counter_cells(self, name: str) -> Dict[LabelKey, int]:
        """Label-key -> value mapping for one counter (empty if the
        counter was never touched) - the conformance comparison unit."""
        metric = self.metrics.get(name)
        return dict(metric.cells) if metric is not None else {}

    def histogram_totals(self, name: str):
        """Label-key -> (count, sum) for one histogram; exact even
        after the ring wraps."""
        metric = self.metrics.get(name)
        if metric is None:
            return {}
        return {key: (cell.count, cell.sum)
                for key, cell in metric.cells.items()}

    # ------------------------------------------------------ exposition
    def snapshot(self) -> dict:
        """JSON-able registry dump (the one schema both ``stats()``
        surfaces and the TCP ``metrics`` verb are built on)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self.metrics):
            metric = self.metrics[name]
            if metric.kind == "counter":
                out["counters"][name] = {
                    "help": metric.help,
                    "values": [{"labels": dict(k), "value": v}
                               for k, v in metric.items()]}
            elif metric.kind == "gauge":
                out["gauges"][name] = {
                    "help": metric.help,
                    "values": [{"labels": dict(k), "value": v}
                               for k, v in metric.items()]}
            else:
                out["histograms"][name] = {
                    "help": metric.help,
                    "values": [{"labels": dict(k), "count": c.count,
                                "sum": c.sum,
                                "min": (c.min if c.count else 0),
                                "max": (c.max if c.count else 0),
                                "p50": c.percentile(50),
                                "p99": c.percentile(99)}
                               for k, c in metric.items()]}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4).  Histograms are
        exported as summaries (quantiles over the ring window plus the
        exact ``_count`` / ``_sum`` series)."""
        lines = []
        for name in sorted(self.metrics):
            metric = self.metrics[name]
            if metric.help:
                lines.append(f"# HELP {name} {metric.help}")
            if metric.kind in ("counter", "gauge"):
                lines.append(f"# TYPE {name} {metric.kind}")
                for key, value in metric.items():
                    lines.append(f"{name}{_prom_labels(key)} {value}")
            else:
                lines.append(f"# TYPE {name} summary")
                for key, cell in metric.items():
                    for q in (0.5, 0.99):
                        qkey = key + (("quantile", str(q)),)
                        lines.append(
                            f"{name}{_prom_labels(qkey)} "
                            f"{cell.percentile(q * 100)}")
                    lines.append(
                        f"{name}_count{_prom_labels(key)} {cell.count}")
                    lines.append(
                        f"{name}_sum{_prom_labels(key)} {cell.sum}")
        return "\n".join(lines) + "\n"


def merge_label_cells(cells: Dict[LabelKey, int],
                      drop: Iterable[str] = ()) -> Dict[LabelKey, int]:
    """Sum counter cells over the ``drop`` label dimensions (e.g. sum a
    per-shard counter across shards for a global comparison)."""
    drop = set(drop)
    out: Dict[LabelKey, int] = {}
    for key, value in cells.items():
        merged = tuple((k, v) for k, v in key if k not in drop)
        out[merged] = out.get(merged, 0) + value
    return out
