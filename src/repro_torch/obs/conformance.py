"""MetricsConformance: the telemetry plane's own oracle leg.

Production metrics pipelines are trusted, never *checked*.  This repo
can do better: every replayable counter in the live registry is
recomputed from the broker's captured ``ServiceTrace`` - the committed
decision history, replayed step by step through a **fresh**
``BatchDecider`` + ``Telemetry`` - and asserted **bit-identical**,
label set by label set, to what the live async path recorded.

What this catches: any scheduling, attribution or accounting bug in
the async layer (double-counted batch, dropped increment, wrong shard
label, detector state corrupted by interleaving) shows up as a counter
mismatch.  What it deliberately shares: the counter *derivation* code
(``Telemetry.record_batch``) is the same on both sides - semantic
correctness of the decisions themselves is the four-way differential
oracle's job (``trace.verify_broker``), which the service test tier
already runs on every family.  The two legs compose: the oracle proves
the history is right; this leg proves the registry reflects exactly
that history.

Wall-clock metrics (decide seconds, latency, queue depth), spans and
compile events are live-only by construction and excluded.
"""

from __future__ import annotations

import numpy as np

#: counters compared bit-identically, every label set.
CONFORMANCE_COUNTERS = (
    "coh_batches_total",
    "coh_requests_total",
    "coh_reads_total",
    "coh_writes_total",
    "coh_fetch_tokens_total",
    "coh_signal_tokens_total",
    "coh_push_tokens_total",
    "coh_fills_total",
    "coh_hits_total",
    "coh_invalidation_signals_total",
    "coh_invalidation_events_total",
    "coh_invalidation_storms_total",
    "coh_writer_flips_total",
    "coh_pingpong_alternations_total",
    "coh_state_entries_total",
    "coh_state_occupancy_total",
    "coh_wire_delta_bytes_total",
    "coh_wire_full_bytes_total",
    "coh_chunks_fetched_total",
)
#: histograms whose exact (count, sum) integers are compared.
CONFORMANCE_HISTOGRAMS = ("coh_batch_size", "coh_staleness_at_serve")


class MetricsConformanceError(AssertionError):
    """A live registry counter diverged from its trace replay."""


def _replay_steps(tel, steps, cfg, names, n_agents: int,
                  shard_label: int, device=None) -> None:
    """Drive one authority's step sub-stream through a fresh decider on
    ``device`` into ``tel`` (shard-local artifact index space)."""
    from repro_torch.content.chunks import n_chunks as _n_chunks
    from repro_torch.obs.telemetry import BatchObservation
    from repro_torch.service.batching import BatchDecider

    decider = BatchDecider(cfg, "scan", device=device)
    C = (_n_chunks(cfg.artifact_tokens, cfg.chunk_tokens)
         if cfg.chunk_tokens > 0 else 0)
    for rec in steps:
        acts = np.zeros(n_agents, bool)
        arts = np.zeros(n_agents, np.int32)
        writes = np.zeros(n_agents, bool)
        mask = np.zeros((n_agents, C), bool) if C else None
        chunks = rec.chunks or ((),) * len(rec.agents)
        for agent, d, w, ch in zip(rec.agents, rec.arts, rec.writes,
                                   chunks):
            acts[agent] = True
            arts[agent] = d
            writes[agent] = w
            if mask is not None and w:
                mask[agent, list(ch)] = True
        state_before = decider.host_state.copy()
        decision = decider.decide(acts, arts, writes,
                                  write_chunks=mask)
        tel.record_batch(BatchObservation(
            names=names, acts=acts, arts=arts, writes=writes,
            miss=decision.miss, version=decision.version,
            ledger_delta=decision.ledger_delta,
            state_before=state_before,
            state_after=decider.host_state,
            ver_after=decider.host_version.astype(np.int64),
            wire_delta=decision.wire_delta,
            shard=shard_label, live=False))


def replay_telemetry(trace, names, storm_threshold=None, device=None):
    """Rebuild a Telemetry registry purely from a captured trace.

    ``names`` is the global artifact-name tuple (the trace stores only
    indices; labels need names).  Sharded traces replay shard by shard
    - per-artifact serialization order is preserved because every
    artifact's history lives entirely inside one shard's sub-stream.
    The replay's scan decider runs on ``device`` (``None``: CUDA).
    Returns the fresh :class:`repro_torch.obs.telemetry.Telemetry`.
    """
    from repro_torch.core import acs
    from repro_torch.obs.telemetry import Telemetry

    names = tuple(names)
    if len(names) != trace.n_artifacts:
        raise ValueError(
            f"{len(names)} artifact names for a {trace.n_artifacts}"
            f"-artifact trace")
    tel = Telemetry(trace.n_agents, strategy=trace.strategy,
                    backend="scan", n_shards=trace.n_shards,
                    storm_threshold=storm_threshold)

    def cfg_for(m: int) -> acs.ACSConfig:
        return acs.ACSConfig(
            n_agents=trace.n_agents, n_artifacts=m,
            artifact_tokens=trace.artifact_tokens, n_steps=1,
            strategy=acs.STRATEGY_CODES[trace.strategy],
            access_k=trace.access_k,
            max_stale_steps=trace.max_stale_steps,
            chunk_tokens=trace.chunk_tokens)

    if trace.n_shards <= 1:
        _replay_steps(tel, trace.steps, cfg_for(trace.n_artifacts),
                      names, trace.n_agents, shard_label=0,
                      device=device)
        return tel

    for shard in range(trace.n_shards):
        cols = [d for d, s in enumerate(trace.artifact_shards)
                if s == shard]
        if not cols:
            continue
        local = {d: i for i, d in enumerate(cols)}
        sub_steps = []
        for rec in trace.steps:
            if rec.shard != shard:
                continue
            sub_steps.append(rec.__class__(
                agents=rec.agents,
                arts=tuple(local[d] for d in rec.arts),
                writes=rec.writes, miss=rec.miss, version=rec.version,
                latency_s=rec.latency_s, chunks=rec.chunks,
                shard=shard, decide_s=rec.decide_s,
                batch_size=rec.batch_size))
        _replay_steps(tel, sub_steps, cfg_for(len(cols)),
                      tuple(names[d] for d in cols), trace.n_agents,
                      shard_label=shard, device=device)
    return tel


def _compare(live_reg, replay_reg, name: str) -> int:
    """Bit-compare every label set of one counter; return cells seen."""
    live = live_reg.counter_cells(name)
    rep = replay_reg.counter_cells(name)
    if live != rep:
        only_live = {k: v for k, v in live.items()
                     if rep.get(k) != v}
        only_rep = {k: v for k, v in rep.items()
                    if live.get(k) != v}
        raise MetricsConformanceError(
            f"registry counter {name} diverged from trace replay:\n"
            f"  live   : {only_live}\n  replay : {only_rep}")
    return len(live)


def check_metrics_conformance(broker, name: str = "metrics") -> dict:
    """Replay the broker's captured trace through a fresh telemetry
    plane and assert every replayable counter (and exact histogram
    count/sum) bit-identical to the live registry.

    Works for both broker flavors; sharded brokers additionally get
    the L1/L2 attribution-conservation check (L1 counters depend on
    live content equality, so they are conservation-checked against
    the trace's read misses rather than replayed).  The replay runs on
    the broker's own device.  Returns a report dict; raises
    :class:`MetricsConformanceError` on any divergence.
    """
    tel = getattr(broker, "telemetry", None)
    if tel is None:
        raise ValueError(
            "broker runs with telemetry disabled; metrics conformance "
            "needs the live registry (telemetry=True)")
    sharded = getattr(broker, "is_sharded", False)
    capture = (broker.config.service.capture_trace if sharded
               else broker.config.capture_trace)
    if not capture:
        raise ValueError(
            "broker was started with capture_trace=False; metrics "
            "conformance replays the captured ServiceTrace")
    trace = broker.trace
    if broker.n_batches != trace.n_steps:
        raise ValueError(
            f"trace has {trace.n_steps} steps but the broker committed "
            f"{broker.n_batches} batches - partial capture cannot be "
            f"verified")

    authority = broker.brokers[0] if sharded else broker
    replayed = replay_telemetry(trace, broker.names,
                                storm_threshold=tel.storm_threshold,
                                device=authority.decider.device)
    cells = 0
    for counter in CONFORMANCE_COUNTERS:
        cells += _compare(tel.registry, replayed.registry, counter)
    for hist in CONFORMANCE_HISTOGRAMS:
        live = tel.registry.histogram_totals(hist)
        rep = replayed.registry.histogram_totals(hist)
        if live != rep:
            raise MetricsConformanceError(
                f"registry histogram {hist} (count, sum) diverged "
                f"from trace replay:\n  live   : {live}\n"
                f"  replay : {rep}")
        cells += len(live)

    report = {
        "name": name,
        "bit_exact": True,
        "counters_compared": len(CONFORMANCE_COUNTERS),
        "histograms_compared": len(CONFORMANCE_HISTOGRAMS),
        "label_cells_compared": cells,
        "n_steps": trace.n_steps,
        "n_actions": trace.n_actions,
    }
    if sharded:
        read_misses = sum(
            sum(1 for w, miss in zip(s.writes, s.miss)
                if miss and not w) for s in trace.steps)
        reg = tel.registry
        attributed = (reg.counter_total("coh_l1_fills_total")
                      + reg.counter_total("coh_l2_fills_total"))
        if attributed != read_misses:
            raise MetricsConformanceError(
                f"L1/L2 fill counters lost fills: {attributed} "
                f"attributed vs {read_misses} read misses in the trace")
        if (reg.counter_total("coh_l1_fills_total")
                != broker.l1_wire["l1_fills"]
                or reg.counter_total("coh_l2_fills_total")
                != broker.l1_wire["l2_fills"]):
            raise MetricsConformanceError(
                f"L1 registry counters diverged from the broker's "
                f"l1_wire ledger: registry "
                f"({reg.counter_total('coh_l1_fills_total')}, "
                f"{reg.counter_total('coh_l2_fills_total')}) vs "
                f"{broker.l1_wire}")
        report["l1_fills_conserved"] = True
    return report
