"""Coherence-service launcher (the port's twin of
``repro.launch.service``): run the broker under load or as a JSON-lines
TCP frontend (stdlib asyncio only - no web framework).  The authority's
directories live on the card unless ``--device cpu``; ``--shards K``
gives each of K authority shards its own CUDA stream there.

In-process load run (the default)::

    PYTHONPATH=src python -m repro_torch.launch.service \
        --family zipf --clients 32 --rounds 40 --verify

TCP frontend (one JSON object per line, newline-terminated replies)::

    PYTHONPATH=src python -m repro_torch.launch.service --tcp 8788

    request : {"op": "read",  "agent": 0, "artifact": "a0"}
              {"op": "write", "agent": 0, "artifact": "a0",
               "content": [1, 2, ...]}            # optional content
              {"op": "stats"}
              {"op": "metrics"}   # Prometheus text + registry snapshot
    reply   : {"ok": true, "version": 3, "hit": false,
               "content": [...]} | {"ok": false, "error": "..."}

The wire layer is deliberately a veneer: every connection handler just
awaits the same broker coroutines the in-process clients use, so TCP
requests coalesce into the same micro-batches.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import pathlib
from typing import Optional

from repro_torch.service import (CoherenceBroker, CoherenceConfig,
                                 connect, drive_workload, verify_broker)
from repro_torch.sim import workloads


def artifact_names(n_artifacts: int) -> tuple:
    return tuple(f"artifact-{d}" for d in range(n_artifacts))


def build_workload(family: str, n_clients: int, n_artifacts: int,
                   artifact_tokens: int, n_rounds: int,
                   volatility: Optional[float] = None,
                   seed: Optional[int] = None):
    """A workload-zoo family sized for the service (``uniform`` is the
    paper's homogeneous SS8.1 scenario: uniform pick, scalar V)."""
    import dataclasses
    if family == "uniform":
        v = 0.10 if volatility is None else volatility
        w = workloads.zipf(
            n_agents=n_clients, n_artifacts=n_artifacts, skew=0.0,
            volatility=v, artifact_tokens=artifact_tokens,
            n_steps=n_rounds)
        return dataclasses.replace(
            w, name=f"uniform V={v:.2f}", family="uniform",
            seed=w.seed if seed is None else seed,
            description="paper SS8.1 homogeneous scenario "
                        "(uniform pick, scalar V).")
    if volatility is not None:
        raise ValueError("--volatility only applies to --family uniform")
    kw = {} if seed is None else {"seed": seed}
    return workloads.make(family, n_agents=n_clients,
                          n_artifacts=n_artifacts,
                          artifact_tokens=artifact_tokens,
                          n_steps=n_rounds, **kw)


# ---------------------------------------------------------------------------
# TCP frontend.


async def handle_connection(broker: CoherenceBroker,
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
    try:
        while True:
            line = await reader.readline()
            if not line:
                break
            try:
                req = json.loads(line)
                op = req.get("op")
                if op == "read":
                    r = await broker.read(int(req["agent"]),
                                          req["artifact"])
                    reply = {"ok": True, "version": r.version,
                             "hit": r.hit, "content": list(r.content)}
                elif op == "write":
                    w = await broker.write(int(req["agent"]),
                                           req["artifact"],
                                           req.get("content"))
                    reply = {"ok": True, "version": w.version}
                elif op == "stats":
                    reply = {"ok": True, "stats": broker.stats()}
                elif op == "metrics":
                    tel = getattr(broker, "telemetry", None)
                    if tel is None:
                        reply = {"ok": False,
                                 "error": "telemetry disabled "
                                          "(telemetry=False)"}
                    else:
                        reply = {"ok": True,
                                 "prometheus": tel.prometheus(),
                                 "snapshot": tel.snapshot()}
                else:
                    reply = {"ok": False,
                             "error": f"unknown op {op!r}"}
            except Exception as e:  # noqa: BLE001 - wire errors go to
                reply = {"ok": False,  # the client, not the server log
                         "error": f"{type(e).__name__}: {e}"}
            writer.write(json.dumps(reply).encode() + b"\n")
            await writer.drain()
    finally:
        writer.close()


async def serve_tcp(broker: CoherenceBroker, host: str = "127.0.0.1",
                    port: int = 8788) -> asyncio.base_events.Server:
    """Start the JSON-lines frontend; caller owns the server object."""
    # a write request carries artifact_tokens JSON ints on one line;
    # asyncio's default 64 KiB readline limit would drop the connection
    # instead of answering, so size the limit to the artifact slot.
    tokens = getattr(broker.config, "artifact_tokens", None)
    if tokens is None:          # layered config (sharded plane)
        tokens = broker.config.core.artifact_tokens
    limit = max(1 << 16, tokens * 16 + (1 << 12))
    return await asyncio.start_server(
        lambda r, w: handle_connection(broker, r, w), host, port,
        limit=limit)


# ---------------------------------------------------------------------------
# CLI.


async def run_load(args) -> dict:
    w = build_workload(args.family, args.clients, args.artifacts,
                       args.artifact_tokens, args.rounds,
                       volatility=args.volatility, seed=args.seed)
    cfg = CoherenceConfig.make(
        args.clients, artifact_names(args.artifacts),
        artifact_tokens=args.artifact_tokens, strategy=args.strategy,
        backend=args.backend, shards=args.shards, hosts=args.hosts,
        telemetry=not args.no_telemetry)
    async with connect(cfg, device=args.device) as broker:
        rep = await drive_workload(broker, w, args.rounds,
                                   seed=args.seed,
                                   lockstep=not args.open_loop,
                                   think_time_s=args.think_time)
        stats = broker.stats()
        summary = {
            "family": w.family, "workload": w.name,
            "strategy": args.strategy, "backend": stats["backend"],
            "clients": args.clients, "rounds": rep.n_rounds,
            "actions": rep.n_actions,
            "batches": stats["decision"]["n_batches"],
            "mean_batch": round(stats["decision"]["mean_batch"], 2),
            "throughput_dps": round(rep.throughput_dps, 1),
            "capacity_dps": round(rep.capacity_dps, 1),
            "p50_ms": round(rep.latency_ms(50), 3),
            "p99_ms": round(rep.latency_ms(99), 3),
            "coherent_tokens": rep.coherent_tokens,
            "broadcast_tokens": rep.broadcast_tokens,
            "savings_vs_broadcast": round(rep.savings_vs_broadcast, 4),
            "cache_hit_rate": round(stats["ledger"]["cache_hit_rate"],
                                    4),
        }
        if args.shards > 1 or args.hosts > 1:
            topo = stats["topology"]
            l1 = stats["l1"]
            summary.update({
                "shards": topo["n_shards"], "hosts": topo["n_hosts"],
                "shard_artifacts": list(topo["shard_artifacts"]),
                "l1_fills": l1["l1_fills"],
                "l2_fills": l1["l2_fills"],
                "l1_fill_rate": round(l1["l1_fill_rate"], 4),
            })
        if args.trace_out:
            pathlib.Path(args.trace_out).write_text(
                broker.trace.to_json())
            summary["trace_out"] = args.trace_out
        if args.verify:
            report = verify_broker(broker, name=f"service:{w.family}")
            summary["oracle"] = {
                "bit_exact": True,
                "implementations": list(report.implementations),
                "n_actions": report.trace.n_actions,
            }
        if args.verify_metrics:
            from repro_torch.obs import check_metrics_conformance
            summary["metrics_conformance"] = check_metrics_conformance(
                broker, name=f"metrics:{w.family}")
        return summary


async def run_tcp(args) -> None:
    # an open-ended frontend must not grow an unbounded audit trace;
    # use the load-generator mode for oracle-replayable captures.
    cfg = CoherenceConfig.make(
        args.clients, artifact_names(args.artifacts),
        artifact_tokens=args.artifact_tokens, strategy=args.strategy,
        backend=args.backend, capture_trace=False,
        shards=args.shards, hosts=args.hosts)
    async with connect(cfg, device=args.device) as broker:
        server = await serve_tcp(broker, args.host, args.tcp)
        addr = server.sockets[0].getsockname()
        print(f"coherence broker on {addr[0]}:{addr[1]} "
              f"({args.clients} agent slots, {args.artifacts} artifacts,"
              f" strategy={args.strategy})")
        async with server:
            await server.serve_forever()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--family", default="uniform",
                    choices=("uniform",) + tuple(workloads.FAMILIES),
                    help="load-generator workload family")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--artifacts", type=int, default=6)
    ap.add_argument("--artifact-tokens", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--strategy", default="lazy",
                    choices=("lazy", "eager", "access_count"))
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "scan", "kernel"),
                    help="decision route (see "
                    "repro_torch.service.batching)")
    ap.add_argument("--shards", type=int, default=1,
                    help="authority-plane shard count (K directory "
                    "shards, hash-of-artifact routed; 1 = the single "
                    "broker)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="L1 placement domains (per-host L1 "
                    "directories in front of the shards; 1 = no L1 "
                    "plane)")
    ap.add_argument("--volatility", type=float, default=None,
                    help="write probability for --family uniform")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--open-loop", action="store_true",
                    help="clients free-run with think-time jitter "
                    "instead of lockstep rounds")
    ap.add_argument("--think-time", type=float, default=0.0,
                    help="max per-action think-time sleep (s), "
                    "open-loop mode")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the captured ServiceTrace JSON here")
    ap.add_argument("--verify", action="store_true",
                    help="replay the captured trace through the "
                    "four-way differential oracle before exiting")
    ap.add_argument("--verify-metrics", action="store_true",
                    help="replay the captured trace through a fresh "
                    "telemetry plane and assert every replayable "
                    "counter bit-identical to the live registry "
                    "(repro_torch.obs.conformance)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="run with the telemetry plane disabled (the "
                    "overhead baseline)")
    ap.add_argument("--tcp", type=int, default=None, metavar="PORT",
                    help="serve the JSON-lines TCP frontend instead of "
                    "running the load generator")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="device the directories live on (default: the "
                    "CUDA card; 'cpu' runs the kernels' plain versions)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.tcp is not None:
        asyncio.run(run_tcp(args))
        return {}
    summary = asyncio.run(run_load(args))
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()
