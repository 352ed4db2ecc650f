"""One ``stats()`` schema for every broker flavor.

``CoherenceBroker.stats()`` and ``ShardedCoherenceBroker.stats()`` had
drifted into two ad-hoc flat dicts (the sharded one omitted latency
percentiles, the plain one omitted capacity metrics).  Both now
delegate here: :func:`unified_stats` builds one **nested canonical
schema** (identical key set for both flavors, superset of everything
either reported) and attaches the old flat key names as a deprecation
shim - reading a legacy key still works everywhere it used to, but
warns once per process per key.  Serialization keeps the flat keys
(TCP ``stats`` consumers parse them), so the shim is wire-compatible.

Canonical schema (``schema_version`` 1)::

    strategy, backend                      # deployment
    topology:  n_shards, n_hosts, shard_artifacts
    decision:  n_actions, n_batches, mean_batch, decide_busy_s,
               decide_busy_max_s, decisions_per_s
    ledger:    total/fetch/signal/push tokens, fills, hits, reads,
               writes, invalidation signals, cache_hit_rate
    latency:   p50_ms, p99_ms, n_samples
    telemetry: enabled, spans_recorded, compile_traces
    mesi:      invalidation events/storms, writer flips, ping-pong
               alternations, staleness-at-serve mean  (telemetry on)
    wire:      delta/full bytes, chunks fetched, savings, unique
               chunks                                  (content plane)
    l1:        l1/l2 fills + bytes, fill rate, invalidations
                                                       (sharded plane)
"""

from __future__ import annotations

import warnings

import numpy as np

#: flat keys kept as the deprecation shim (the union of the two
#: pre-unification stats() dicts).
LEGACY_KEYS = frozenset({
    "n_actions", "n_batches", "mean_batch",
    "total_tokens", "fetch_tokens", "signal_tokens", "push_tokens",
    "n_fetches", "n_hits", "cache_hit_rate",
    "p50_ms", "p99_ms", "decide_busy_s",
    "n_shards", "n_hosts", "shard_artifacts",
    "decide_busy_max_s", "decisions_per_s",
    "l1_fills", "l2_fills", "l1_bytes", "l2_bytes", "l1_fill_rate",
    "delta_bytes", "full_bytes", "n_chunks_fetched",
    "bytes_savings_vs_full", "unique_chunks",
})

_warned: set = set()


class StatsView(dict):
    """The stats mapping: canonical nested keys plus legacy flat
    aliases that warn (once per process per key) on access."""

    def __getitem__(self, key):
        if key in LEGACY_KEYS and key not in _warned:
            _warned.add(key)
            warnings.warn(
                f"stats()[{key!r}] is a deprecated flat alias; read "
                f"the nested schema (see repro_torch.obs.stats docstring / "
                f"docs/observability.md)",
                DeprecationWarning, stacklevel=2)
        return super().__getitem__(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


def _percentiles(latencies) -> dict:
    lat = (np.asarray(latencies, float) if len(latencies)
           else np.zeros(1))
    return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "n_samples": int(len(latencies))}


def _mesi_section(tel) -> dict:
    reg = tel.registry
    stale = reg.histogram_totals("coh_staleness_at_serve")
    count = sum(c for c, _ in stale.values())
    total = sum(s for _, s in stale.values())
    occ = {}
    for key, value in reg.counter_cells(
            "coh_state_occupancy_total").items():
        state = dict(key).get("state", "?")
        occ[state] = occ.get(state, 0) + value
    return {
        "invalidation_events": reg.counter_total(
            "coh_invalidation_events_total"),
        "invalidation_storms": reg.counter_total(
            "coh_invalidation_storms_total"),
        "writer_flips": reg.counter_total("coh_writer_flips_total"),
        "pingpong_alternations": reg.counter_total(
            "coh_pingpong_alternations_total"),
        "staleness_served_mean": total / max(count, 1),
        "occupancy": occ,
    }


def unified_stats(broker) -> StatsView:
    """Build the canonical nested stats mapping (+ legacy flat aliases)
    for a plain or sharded broker."""
    sharded = getattr(broker, "is_sharded", False)
    led = broker.ledger
    tel = getattr(broker, "telemetry", None)

    if sharded:
        strategy = broker.config.core.strategy
        backend = broker.brokers[0].decider.backend
        n_shards = broker.n_shards
        n_hosts = broker.config.topology.n_hosts
        shard_artifacts = [len(c) for c in broker._shard_cols]
        busy = broker.decision_busy()
        latencies = [x for b in broker.brokers for x in b.latencies]
        chunked = broker.chunked
        unique_chunks = (sum(b.chunks.n_unique_chunks
                             for b in broker.brokers)
                         if chunked else 0)
    else:
        strategy = broker.config.strategy
        backend = broker.decider.backend
        n_shards, n_hosts = 1, 1
        shard_artifacts = [len(broker.names)]
        busy = (broker.decide_busy_s,)
        latencies = list(broker.latencies)
        chunked = broker.chunks is not None
        unique_chunks = (broker.chunks.n_unique_chunks
                         if chunked else 0)

    n_actions = led.n_reads + led.n_writes
    out = StatsView({
        "schema_version": 1,
        "strategy": strategy,
        "backend": backend,
        "topology": {"n_shards": n_shards, "n_hosts": n_hosts,
                     "shard_artifacts": shard_artifacts},
        "decision": {
            "n_actions": n_actions,
            "n_batches": broker.n_batches,
            "mean_batch": n_actions / max(broker.n_batches, 1),
            "decide_busy_s": sum(busy),
            "decide_busy_max_s": max(busy),
            "decisions_per_s": n_actions / max(max(busy), 1e-12),
        },
        "ledger": {
            "total_tokens": led.total_tokens,
            "fetch_tokens": led.fetch_tokens,
            "signal_tokens": led.signal_tokens,
            "push_tokens": led.push_tokens,
            "n_fetches": led.n_fetches,
            "n_hits": led.n_hits,
            "n_reads": led.n_reads,
            "n_writes": led.n_writes,
            "n_invalidation_signals": led.n_invalidation_signals,
            "cache_hit_rate": led.n_hits / max(led.n_hits
                                               + led.n_fetches, 1),
        },
        "latency": _percentiles(latencies),
        "telemetry": {
            "enabled": tel is not None,
            "spans_recorded": (tel.spans.n_recorded if tel else 0),
            "compile_traces": 0,
        },
    })
    if tel is not None:
        from repro_torch.obs import runtime
        out["telemetry"]["compile_traces"] = runtime.compile_count()
        out["mesi"] = _mesi_section(tel)
    if chunked:
        wire = dict(broker.wire)
        wire["bytes_savings_vs_full"] = 1.0 - (
            wire["delta_bytes"] / max(wire["full_bytes"], 1))
        wire["unique_chunks"] = unique_chunks
        out["wire"] = wire
    if sharded:
        l1 = dict(broker.l1_wire)
        fills = l1["l1_fills"] + l1["l2_fills"]
        l1["l1_fill_rate"] = l1["l1_fills"] / max(fills, 1)
        l1["l1_invalidations"] = sum(h.n_invalidations
                                     for h in broker.l1)
        out["l1"] = l1

    # ---- legacy flat aliases (deprecation shim; warn on access)
    flat = {}
    flat.update({k: out["decision"][k] for k in (
        "n_actions", "n_batches", "mean_batch", "decide_busy_s")})
    flat.update({k: out["ledger"][k] for k in (
        "total_tokens", "fetch_tokens", "signal_tokens", "push_tokens",
        "n_fetches", "n_hits", "cache_hit_rate")})
    flat.update({k: out["latency"][k] for k in ("p50_ms", "p99_ms")})
    if chunked:
        flat.update({k: out["wire"][k] for k in (
            "delta_bytes", "full_bytes", "n_chunks_fetched",
            "bytes_savings_vs_full", "unique_chunks")})
    if sharded:
        flat.update({
            "n_shards": n_shards, "n_hosts": n_hosts,
            "shard_artifacts": tuple(shard_artifacts),
            "decide_busy_max_s": out["decision"]["decide_busy_max_s"],
            "decisions_per_s": out["decision"]["decisions_per_s"],
        })
        flat.update({k: out["l1"][k] for k in (
            "l1_fills", "l2_fills", "l1_bytes", "l2_bytes",
            "l1_fill_rate")})
    dict.update(out, flat)
    return out
