"""The port's coherence-service launcher
(``repro_torch.launch.service``) against the JAX package's: the same
workloads, the JSON-lines TCP frontend (``read`` / ``write`` /
``stats`` / ``metrics``) answering a scripted sequence as the reference
does, and ``main``'s summary equal to the reference ``main``'s on the
same arguments, timing keys aside."""

import asyncio
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import service as rservice  # noqa: E402
from repro.launch import service as rlaunch  # noqa: E402
from repro_torch import service  # noqa: E402
from repro_torch.launch import service as launch  # noqa: E402

pytestmark = pytest.mark.torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fields(w) -> dict:
    out = {}
    for f in dataclasses.fields(w):
        v = getattr(w, f.name)
        out[f.name] = (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                       else np.asarray(v).tolist()
                       if isinstance(v, np.ndarray) else v)
    return out


@pytest.mark.parametrize("family",
                         ["uniform"] + sorted(launch.workloads.FAMILIES))
def test_build_workload_equals_the_reference(family):
    args = (family, 12, 5, 256, 9)
    assert _fields(launch.build_workload(*args)) == _fields(
        rlaunch.build_workload(*args))
    assert _fields(launch.build_workload(*args, seed=77)) == _fields(
        rlaunch.build_workload(*args, seed=77))
    if family == "uniform":
        w = launch.build_workload(*args, volatility=0.3, seed=4)
        assert _fields(w) == _fields(rlaunch.build_workload(
            *args, volatility=0.3, seed=4))
    else:
        with pytest.raises(ValueError, match="volatility"):
            launch.build_workload(*args, volatility=0.3)
    assert launch.artifact_names(3) == rlaunch.artifact_names(3)


def test_chip_smoke_service_cell_is_the_launchers():
    """``chip_smoke.py``'s service workloads are the launcher's, at the
    service bench's grid and seeds."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cell = smoke.SERVICE
    for family in smoke.SERVICE_FAMILIES:
        assert _fields(smoke.service_workload(family)) == _fields(
            rlaunch.build_workload(
                family, cell["clients"], cell["artifacts"],
                cell["artifact_tokens"], cell["rounds"],
                seed=smoke.SERVICE_SEEDS[family]))


async def _rpc(reader, writer, obj):
    writer.write(json.dumps(obj).encode() + b"\n")
    await writer.drain()
    return json.loads(await reader.readline())


SCRIPT = (
    {"op": "read", "agent": 0, "artifact": "artifact-0"},
    {"op": "write", "agent": 1, "artifact": "artifact-0"},
    {"op": "read", "agent": 0, "artifact": "artifact-0"},
    {"op": "read", "agent": 2, "artifact": "artifact-0"},
    {"op": "write", "agent": 3, "artifact": "artifact-1",
     "content": list(range(100, 116))},
    {"op": "read", "agent": 1, "artifact": "artifact-1"},
    {"op": "read", "agent": 0, "artifact": "nope"},
    {"op": "write", "agent": 0, "artifact": "artifact-1",
     "content": [1, 2]},
    {"op": "frobnicate"},
)


def _serve_script(package, serve_tcp, opts, **topology):
    """The scripted requests over a socket, then ``stats`` and
    ``metrics``; returns the replies and the broker."""
    async def main():
        cfg = package.CoherenceConfig.make(4, ("artifact-0", "artifact-1"),
                                           artifact_tokens=16, **topology)
        async with package.connect(cfg, **opts) as broker:
            server = await serve_tcp(broker, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            replies = [await _rpc(reader, writer, req) for req in SCRIPT]
            stats = await _rpc(reader, writer, {"op": "stats"})
            metrics = await _rpc(reader, writer, {"op": "metrics"})
            writer.close()
            server.close()
            await server.wait_closed()
            return replies, stats, metrics, broker
    return asyncio.run(main())


@pytest.mark.parametrize("topology", [{}, {"shards": 2, "hosts": 2}],
                         ids=["single", "sharded"])
def test_tcp_replies_equal_the_reference(topology):
    got, stats, metrics, broker = _serve_script(
        service, launch.serve_tcp, {"device": "cpu"}, **topology)
    want, rstats, rmetrics, _ = _serve_script(
        rservice, rlaunch.serve_tcp, {}, **topology)
    assert got == want
    assert got[0]["ok"] and got[0]["version"] == 1 and not got[0]["hit"]
    assert got[1] == {"ok": True, "version": 2}
    assert not got[6]["ok"] and "unknown artifact" in got[6]["error"]
    assert not got[7]["ok"] and "fixed 16-token" in got[7]["error"]
    assert not got[8]["ok"] and "unknown op" in got[8]["error"]
    assert stats["ok"] and stats["stats"]["n_actions"] == 6
    for key in ("ledger", "topology") + (("l1",) if topology else ()):
        assert stats["stats"][key] == rstats["stats"][key]
    assert metrics["ok"] and "coh_fetch_tokens_total" in metrics["prometheus"]
    counters = metrics["snapshot"]["counters"]
    assert counters["coh_reads_total"]["values"] == \
        rmetrics["snapshot"]["counters"]["coh_reads_total"]["values"]
    # the metrics verb reports the registry's counters
    reg = broker.telemetry.registry
    for name in ("coh_reads_total", "coh_writes_total",
                 "coh_fetch_tokens_total"):
        assert sum(v["value"] for v in counters[name]["values"]) == \
            reg.counter_total(name)


def test_tcp_metrics_disabled_and_long_lines():
    async def main():
        cfg = service.CoherenceConfig.make(2, ("a",), artifact_tokens=8192,
                                           telemetry=False)
        async with service.connect(cfg, device="cpu") as broker:
            server = await launch.serve_tcp(broker, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", port, limit=1 << 20)
            m = await _rpc(reader, writer, {"op": "metrics"})
            assert not m["ok"] and "telemetry" in m["error"]
            # a write line longer than asyncio's 64 KiB default limit
            content = [1_000_000 + t for t in range(8192)]
            w = await _rpc(reader, writer, {"op": "write", "agent": 0,
                                            "artifact": "a",
                                            "content": content})
            assert w == {"ok": True, "version": 2}
            r = await _rpc(reader, writer, {"op": "read", "agent": 1,
                                            "artifact": "a"})
            assert r["content"] == content
            writer.close()
            server.close()
            await server.wait_closed()
    asyncio.run(main())


#: summary keys read off a clock
TIMING = ("throughput_dps", "capacity_dps", "p50_ms", "p99_ms")


@pytest.mark.parametrize("topology", [[], ["--shards", "2", "--hosts", "2"]],
                         ids=["K=1", "K=2"])
def test_main_summary_equals_the_reference(topology, capsys):
    argv = ["--family", "uniform", "--clients", "6", "--artifacts", "3",
            "--artifact-tokens", "32", "--rounds", "6", "--verify",
            "--verify-metrics"] + topology
    got = launch.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == json.dumps(got, indent=2,
                                                 default=float) + "\n"
    want = rlaunch.main(argv)
    assert got["backend"] == "kernel" and want["backend"] == "scan"
    assert got["oracle"]["implementations"] == [
        "kernel" if leg == "pallas" else leg
        for leg in want["oracle"]["implementations"]]
    for summary in (got, want):
        for key in TIMING + ("backend", "oracle"):
            summary.pop(key)
    assert got == want
    assert got["metrics_conformance"]["bit_exact"]


def test_parser_routes_and_device():
    args = launch.build_parser().parse_args([])
    assert (args.backend, args.device, args.shards, args.hosts) == (
        "auto", None, 1, 1)
    with pytest.raises(SystemExit):
        launch.build_parser().parse_args(["--backend", "pallas"])
    args = launch.build_parser().parse_args(["--backend", "kernel",
                                             "--device", "cpu"])
    assert (args.backend, args.device) == ("kernel", "cpu")
