"""The port's telemetry plane (``repro_torch.obs``) against the JAX
package's: the registry's exposition for one sequence of observations,
the live MESI counters of the same lockstep load through both brokers,
the unified stats schema and the compile-event log."""

import asyncio
import json
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro.obs import MetricsRegistry as RRegistry  # noqa: E402
from repro.obs import conformance as rconf  # noqa: E402
from repro.service import BrokerConfig as RConfig  # noqa: E402
from repro.service import CoherenceBroker as RBroker  # noqa: E402
from repro.service import drive_workload as rdrive  # noqa: E402
from repro.sim import workloads as rworkloads  # noqa: E402
from repro_torch.obs import MetricsRegistry as TRegistry  # noqa: E402
from repro_torch.obs import SpanRecorder  # noqa: E402
from repro_torch.obs import runtime as obs_runtime  # noqa: E402
from repro_torch.service import BrokerConfig as TConfig  # noqa: E402
from repro_torch.service import CoherenceBroker as TBroker  # noqa: E402
from repro_torch.service import drive_workload as tdrive  # noqa: E402
from repro_torch.sim import workloads as tworkloads  # noqa: E402

pytestmark = pytest.mark.torch


def _observe(reg) -> None:
    c = reg.counter("coh_test_total", "a counter")
    c.inc(3, shard=0, artifact="a")
    c.inc(2, shard=1, artifact="b")
    c.inc(artifact="a", shard=0)
    reg.gauge("coh_gauge", "a gauge").set(7, strategy="lazy")
    h = reg.histogram("coh_hist", "a histogram", window=4)
    for v in (1, 5, 2, 9, 3, 4):
        h.observe(v, route="scan")
    h.observe(11, route="kernel")


def test_registry_exposition_matches():
    port, ref = TRegistry(), RRegistry()
    _observe(port)
    _observe(ref)
    assert port.snapshot() == ref.snapshot()
    assert json.loads(json.dumps(port.snapshot())) == port.snapshot()
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.counter_value("coh_test_total", shard=0, artifact="a") == 4
    assert port.histogram_totals("coh_hist") == ref.histogram_totals(
        "coh_hist")


def test_span_recorder_bounded():
    rec = SpanRecorder(capacity=3)
    for i in range(5):
        rec.add("decide", "batch", rec.epoch + i, 0.5, tid="authority")
    trace = json.loads(rec.to_chrome_json())
    assert rec.n_recorded == 5 and len(trace["traceEvents"]) == 3


def _run(package, family: str, backend: str, chunk_tokens: int):
    names = tuple(f"artifact-{d}" for d in range(4))
    if package == "port":
        Config, Broker, drive, wl = TConfig, TBroker, tdrive, tworkloads
        kw = {"device": "cpu"}
    else:
        Config, Broker, drive, wl = RConfig, RBroker, rdrive, rworkloads
        kw = {}

    async def main():
        w = wl.make(family, n_agents=6, n_artifacts=4, artifact_tokens=64,
                    n_steps=8)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            cfg = Config(n_agents=6, artifacts=names, artifact_tokens=64,
                         backend=backend, chunk_tokens=chunk_tokens)
        async with Broker(cfg, **kw) as broker:
            await drive(broker, w, 8, seed=3)
            return broker
    return asyncio.run(main())


@pytest.mark.parametrize("family,backend,chunk_tokens", [
    ("ping_pong", "kernel", 0), ("hierarchical", "scan", 16)])
def test_live_counters_and_stats_match_the_reference(family, backend,
                                                     chunk_tokens):
    port = _run("port", family, backend, chunk_tokens)
    ref = _run("ref", family, "scan", chunk_tokens)
    for name in rconf.CONFORMANCE_COUNTERS:
        assert (port.telemetry.registry.counter_cells(name)
                == ref.telemetry.registry.counter_cells(name)), name
    for name in rconf.CONFORMANCE_HISTOGRAMS:
        assert (port.telemetry.registry.histogram_totals(name)
                == ref.telemetry.registry.histogram_totals(name)), name
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ps, rs = port.stats(), ref.stats()
    assert set(ps) == set(rs)
    for section in ("topology", "decision", "ledger", "latency",
                    "telemetry", "mesi") + (("wire",) if chunk_tokens
                                            else ()):
        assert set(ps[section]) == set(rs[section]), section
    for section in ("ledger", "mesi") + (("wire",) if chunk_tokens else ()):
        assert ps[section] == rs[section], section
    assert ps["backend"] == backend and rs["backend"] == "scan"
    for key in ("n_actions", "n_batches", "mean_batch"):
        assert ps["decision"][key] == rs["decision"][key]


def test_compile_log_counts_one_event_per_config():
    before = obs_runtime.compile_count("scan")
    names = ("artifact-0", "artifact-1", "artifact-2")

    async def main():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            # a shape no other test uses: the closure is made anew
            cfg = TConfig(n_agents=13, artifacts=names, artifact_tokens=48,
                          backend="scan")
        for _ in range(2):
            async with TBroker(cfg, device="cpu") as broker:
                await broker.read(0, "artifact-0")
    asyncio.run(main())
    assert obs_runtime.compile_count("scan") == before + 1
    warm = [e for e in obs_runtime.compile_events()
            if e["kind"] == "warmup" and "agents=13" in e["label"]]
    assert len(warm) == 2 and all(e["dur_s"] > 0.0 for e in warm)
