"""The coherence telemetry plane: MESI perf counters as first-class
metrics, fed from one hook per committed micro-batch.

A hardware MESI controller exports invalidations, upgrade misses and
sharer counts per cache controller; :class:`Telemetry` is that surface
for the artifact-coherence service.  One instance is shared by an
entire authority plane (the sharded broker hands the same object to
every shard, labeled ``shard=k``), and every committed micro-batch
calls :meth:`record_batch` with a :class:`BatchObservation`.

Two classes of metric, split deliberately:

  **Replayable** (counters + the exact count/sum of two histograms):
  derivable purely from the committed decision history - token
  ledger deltas, fills/hits, invalidation *signals* (charged) and
  invalidation *events* (observed M/E/S -> I transitions), storm and
  ping-pong detections, state-occupancy integrals, staleness-at-serve.
  The ``MetricsConformance`` leg (``repro_torch.obs.conformance``) replays
  the captured ``ServiceTrace`` through a fresh Telemetry and asserts
  these **bit-identical** to the live registry.

  **Live-only** (wall-clock histograms, queue depth, spans, compile
  events): meaningful only on the live timeline; excluded from
  conformance by construction (``BatchObservation.live``).

Metric catalog and MESI-analogue rationale: ``docs/observability.md``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.states import MESIState
from repro_torch.obs import runtime
from repro_torch.obs.registry import MetricsRegistry, _labelkey
from repro_torch.obs.spans import SpanRecorder

_I = int(MESIState.I)
_STATE_NAMES = {int(s): s.name for s in MESIState}

#: ACSMetrics/ledger fields forwarded as coh_* counters.
LEDGER_COUNTERS = {
    "fetch_tokens": "coh_fetch_tokens_total",
    "signal_tokens": "coh_signal_tokens_total",
    "push_tokens": "coh_push_tokens_total",
    "n_fetches": "coh_fills_total",
    "n_hits": "coh_hits_total",
    "n_reads": "coh_reads_total",
    "n_writes": "coh_writes_total",
    "n_invalidation_signals": "coh_invalidation_signals_total",
}
WIRE_COUNTERS = {
    "delta_bytes": "coh_wire_delta_bytes_total",
    "full_bytes": "coh_wire_full_bytes_total",
    "n_chunks_fetched": "coh_chunks_fetched_total",
}


@dataclasses.dataclass
class BatchObservation:
    """Everything one committed micro-batch exposes to telemetry.

    The replay path (``obs.conformance``) constructs these from a
    ``ServiceTrace`` with ``live=False`` and no timing fields; the
    derivation below must therefore never mix timing into a replayable
    counter.
    """

    names: Tuple[str, ...]          # artifact names, local index order
    acts: np.ndarray                # (n,) bool
    arts: np.ndarray                # (n,) int, local artifact indices
    writes: np.ndarray              # (n,) bool
    miss: np.ndarray                # (n,) bool
    version: np.ndarray             # (n,) served version per agent slot
    ledger_delta: dict
    state_before: np.ndarray        # (n, m) MESI codes before decide
    state_after: np.ndarray         # (n, m) after
    ver_after: np.ndarray           # (m,) authority versions after
    wire_delta: Optional[dict] = None
    shard: int = 0
    live: bool = True
    # ---- live-only (wall clock / queue state) ----
    busy_s: float = 0.0
    route: str = ""
    queue_depth: int = 0
    t_decide: float = 0.0
    t_respond: float = 0.0
    t_submits: Optional[dict] = None    # agent -> t_submit
    latencies: Optional[dict] = None    # agent -> latency_s


class _ShardCells:
    """Pre-resolved (metric, label-key) handles for one shard label.

    ``record_batch`` runs inside the broker's single-writer event loop
    on every committed micro-batch, so it must not rebuild label keys
    or re-resolve metric names per call - that alone costs ~3x the
    bookkeeping itself and would blow the perf gate's 10% telemetry
    bound.  Everything here produces *identical* registry cells to the
    kwargs path (same ``_labelkey``), so conformance is unaffected.
    """

    __slots__ = ("skey", "batches", "req_read", "req_write",
                 "batch_size", "ledger", "wire", "inv", "flips",
                 "pingpong", "ent", "occ", "storms", "stale",
                 "decide_busy", "decide_secs", "queue_depth", "latency")

    def __init__(self, reg: MetricsRegistry, shard: int,
                 storm_threshold: int) -> None:
        skey = _labelkey({"shard": shard})
        self.skey = skey
        self.batches = (reg.counter("coh_batches_total",
                                    "committed micro-batches"), skey)
        req = reg.counter("coh_requests_total",
                          "requests resolved, by operation")
        self.req_read = (req, _labelkey({"shard": shard, "op": "read"}))
        self.req_write = (req, _labelkey({"shard": shard,
                                          "op": "write"}))
        self.batch_size = reg.histogram(
            "coh_batch_size",
            "requests per committed micro-batch").cell_key(skey)
        self.ledger = tuple(
            (field, reg.counter(name))
            for field, name in LEDGER_COUNTERS.items())
        self.wire = tuple(
            (field, reg.counter(name))
            for field, name in WIRE_COUNTERS.items())
        inv = reg.counter(
            "coh_invalidation_events_total",
            "observed valid->I transitions, per artifact")
        flips = reg.counter(
            "coh_writer_flips_total",
            "consecutive commits by different writers")
        ping = reg.counter(
            "coh_pingpong_alternations_total",
            "A->B->A writer alternations")
        # artifact-labeled keys resolve lazily (shard-local name sets)
        self.inv = (inv, {})
        self.flips = (flips, {})
        self.pingpong = (ping, {})
        ent = reg.counter(
            "coh_state_entries_total",
            "MESI state entries: M per commit, S per fill, I per "
            "invalidation event")
        self.ent = {
            s: (ent, _labelkey({"state": s, "shard": shard}))
            for s in ("M", "S", "I")}
        occ = reg.counter(
            "coh_state_occupancy_total",
            "post-batch state occupancy integral "
            "(agent-artifact cells x batches)")
        self.occ = {
            code: (sname, occ,
                   _labelkey({"state": sname, "shard": shard}))
            for code, sname in _STATE_NAMES.items()}
        self.storms = (reg.counter(
            "coh_invalidation_storms_total",
            f"batches charging >= {storm_threshold} "
            f"invalidation signals"), skey)
        self.stale = reg.histogram(
            "coh_staleness_at_serve",
            "versions the served copy lags the post-batch authority"
            ).cell_key(skey)
        self.decide_busy = (reg.counter(
            "coh_decide_busy_seconds_total",
            "wall time inside the decision route"), skey)
        # route label resolves lazily (constant per decider)
        self.decide_secs = (reg.histogram(
            "coh_decide_seconds",
            "decision-kernel wall time per micro-batch"), {})
        self.queue_depth = reg.histogram(
            "coh_queue_depth",
            "pending requests at batch cut").cell_key(skey)
        self.latency = reg.histogram(
            "coh_latency_seconds",
            "submit->respond request latency").cell_key(skey)

    def artifact_key(self, cache: dict, name: str):
        key = cache.get(name)
        if key is None:
            key = cache[name] = self.skey + (("artifact", name),)
        return key


class Telemetry:
    """Registry + spans + MESI detectors for one authority plane."""

    def __init__(self, n_agents: int, *, strategy: str = "",
                 backend: str = "", n_shards: int = 1, n_hosts: int = 1,
                 storm_threshold: Optional[int] = None,
                 span_capacity: int = 1 << 14) -> None:
        self.n_agents = n_agents
        self.strategy = strategy
        self.backend = backend
        self.n_shards = n_shards
        self.n_hosts = n_hosts
        #: a batch whose charged invalidation signals reach this count
        #: is an invalidation storm (half the fleet got blasted).
        self.storm_threshold = (storm_threshold if storm_threshold
                                else max(2, n_agents // 2))
        self.registry = MetricsRegistry()
        self.spans = SpanRecorder(span_capacity)
        #: ping-pong detector state: artifact -> (prev writer, writer)
        self._writers: Dict[str, Tuple[int, int]] = {}
        #: per-shard pre-resolved metric handles (hot-path cache)
        self._shard_cells: Dict[int, _ShardCells] = {}
        self.registry.gauge(
            "coh_build_info",
            "deployment labels of this authority plane").set(
                1, strategy=strategy, backend=backend,
                n_shards=n_shards, n_hosts=n_hosts)

    # ----------------------------------------------------------- hooks
    def record_batch(self, obs: BatchObservation) -> None:
        shard = obs.shard
        cells = self._shard_cells.get(shard)
        if cells is None:
            cells = self._shard_cells[shard] = _ShardCells(
                self.registry, shard, self.storm_threshold)
        acts = np.asarray(obs.acts, bool)
        writes = np.asarray(obs.writes, bool) & acts
        reads = acts & ~writes
        batch_size = int(acts.sum())

        cells.batches[0].inc_key(cells.batches[1], 1)
        cells.req_read[0].inc_key(cells.req_read[1], int(reads.sum()))
        cells.req_write[0].inc_key(cells.req_write[1],
                                   int(writes.sum()))
        cells.batch_size.observe(batch_size)

        delta = obs.ledger_delta
        skey = cells.skey
        for field, counter in cells.ledger:
            counter.inc_key(skey, int(delta[field]))
        if obs.wire_delta is not None:
            wire = obs.wire_delta
            for field, counter in cells.wire:
                counter.inc_key(skey, int(wire[field]))

        self._record_mesi(obs, cells, reads, writes)
        if obs.live:
            self._record_live(obs, cells, shard, batch_size, writes)

    # ------------------------------------------------- MESI detectors
    def _record_mesi(self, obs, cells, reads, writes):
        before = np.asarray(obs.state_before)
        after = np.asarray(obs.state_after)
        names = obs.names
        skey = cells.skey

        # Invalidation *events*: observed M/E/S -> I transitions, the
        # analogue of a hardware controller's invalidation counter
        # (distinct from the charged invalidation *signals*, which
        # depend on the strategy's signaling model).
        became_i = (before != _I) & (after == _I)
        inv_per_artifact = became_i.sum(axis=0)
        inv, inv_keys = cells.inv
        for d in np.flatnonzero(inv_per_artifact):
            inv.inc_key(cells.artifact_key(inv_keys, names[int(d)]),
                        int(inv_per_artifact[d]))
        ent_m, ent_s, ent_i = (cells.ent[s] for s in ("M", "S", "I"))
        ent_m[0].inc_key(ent_m[1], int(writes.sum()))
        ent_s[0].inc_key(ent_s[1], int(obs.ledger_delta["n_fetches"]))
        ent_i[0].inc_key(ent_i[1], int(inv_per_artifact.sum()))
        occupancy = np.bincount(
            after.ravel(), minlength=max(cells.occ) + 1)
        for code, (sname, occ, key) in cells.occ.items():
            count = int(occupancy[code])
            if count or sname in ("S", "I"):
                occ.inc_key(key, count)

        # Invalidation-storm detector: one batch blasted at least
        # storm_threshold invalidation signals across the fleet.
        if (int(obs.ledger_delta["n_invalidation_signals"])
                >= self.storm_threshold):
            cells.storms[0].inc_key(cells.storms[1], 1)

        # Ping-pong detector: consecutive commits to one artifact by
        # different writers (flip), and A->B->A alternation (the
        # cache-line ping-pong pathology proper).
        arts = np.asarray(obs.arts)
        flips, flip_keys = cells.flips
        ping, ping_keys = cells.pingpong
        for agent in np.flatnonzero(writes):
            name = names[int(arts[agent])]
            prev = self._writers.get(name)
            if prev is not None and prev[1] != int(agent):
                flips.inc_key(
                    cells.artifact_key(flip_keys, name), 1)
                if prev[0] == int(agent):
                    ping.inc_key(
                        cells.artifact_key(ping_keys, name), 1)
            self._writers[name] = ((prev[1] if prev else -1),
                                   int(agent))

        # Staleness-at-serve: for every served read, how many versions
        # the returned copy already lags the post-batch authority
        # (>0 = a same-batch commit superseded what you just read).
        read_idx = np.flatnonzero(reads)
        if read_idx.size:
            ver_after = np.asarray(obs.ver_after)
            version = np.asarray(obs.version)
            stale = cells.stale
            lags = ver_after[arts[read_idx]] - version[read_idx]
            for lag in lags.tolist():
                stale.observe(int(lag))

    # ---------------------------------------------------- live timing
    def _record_live(self, obs, cells, shard, batch_size, writes):
        cells.decide_busy[0].inc_key(cells.decide_busy[1], obs.busy_s)
        decide_h, route_cells = cells.decide_secs
        route_cell = route_cells.get(obs.route)
        if route_cell is None:
            route_cell = route_cells[obs.route] = decide_h.cell_key(
                cells.skey + (("route", obs.route),))
        route_cell.observe(obs.busy_s)
        cells.queue_depth.observe(obs.queue_depth)
        lat = cells.latency
        for latency in (obs.latencies or {}).values():
            lat.observe(latency)

        # one complete span per request + one per batch, recorded at
        # resolve time (no open-span state on the hot path)
        t_apply_end = obs.t_respond
        decide_end = obs.t_decide + obs.busy_s
        self.spans.add("decide", "batch", obs.t_decide, obs.busy_s,
                       pid=shard, tid="authority",
                       batch_size=batch_size, route=obs.route,
                       queue_depth=obs.queue_depth)
        arts = np.asarray(obs.arts)
        for agent, t_submit in (obs.t_submits or {}).items():
            name = obs.names[int(arts[agent])]
            op = "write" if writes[agent] else "read"
            self.spans.add(
                f"{op} {name}", "request", t_submit,
                t_apply_end - t_submit, pid=shard, tid=int(agent),
                queue_s=max(0.0, obs.t_decide - t_submit),
                decide_s=obs.busy_s,
                apply_s=max(0.0, t_apply_end - decide_end))

    # --------------------------------------------------------- L1 plane
    def record_l1_fill(self, host: int, level: str, nbytes: int) -> None:
        """Attribute one coherence fill to the L1 or L2 plane."""
        reg = self.registry
        reg.counter("coh_l1_fills_total" if level == "l1"
                    else "coh_l2_fills_total",
                    f"fills served by the {level.upper()} plane").inc(
                        1, host=host)
        reg.counter("coh_l1_bytes_total" if level == "l1"
                    else "coh_l2_bytes_total",
                    f"fill bytes served by the {level.upper()} plane"
                    ).inc(int(nbytes), host=host)

    def record_l1_invalidation(self, host: int) -> None:
        self.registry.counter(
            "coh_l1_invalidations_total",
            "host-L1 entries dropped by the commit invalidation path"
            ).inc(1, host=host)

    # ------------------------------------------------------ exposition
    def snapshot(self) -> dict:
        """Registry snapshot plus runtime (compile/span) accounting."""
        out = self.registry.snapshot()
        out["runtime"] = {
            "compile_events": runtime.compile_events(),
            "spans_recorded": self.spans.n_recorded,
            "span_capacity": self.spans.capacity,
        }
        return out

    def prometheus(self) -> str:
        return self.registry.to_prometheus()

    def chrome_trace(self) -> dict:
        trace = self.spans.chrome_trace()
        shift = runtime.epoch() - self.spans.epoch
        for e in runtime.compile_events():
            trace["traceEvents"].append({
                "name": f"{e['kind']}:{e['route']}", "cat": "compile",
                "ph": "X", "ts": (e["t_s"] + shift) * 1e6,
                "dur": e["dur_s"] * 1e6, "pid": -1, "tid": "runtime",
                "args": {"label": e["label"]}})
        return trace
