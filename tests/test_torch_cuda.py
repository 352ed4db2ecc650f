"""The port's CUDA kernels on a card: each kernel against its plain
PyTorch version on the same CUDA tensors, and the engine's kernel route
against its scan route.  Needs a CUDA device and nvcc; elsewhere every
test skips.  Imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import chunk_diff, mesi_transition  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.ref import (attention_plain,  # noqa: E402
                                     decode_attention_plain, rmsnorm_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    rwkv6_scan, rwkv6_scan_bwd, rwkv6_scan_bwd_plain, rwkv6_scan_checkpoints,
    rwkv6_scan_plain)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.acs import draw_write_chunks  # noqa: E402
from repro_torch.sim import SCENARIOS, run_workload, run_scenario, zoo  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.cuda]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _ints(gen, lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _mesi_inputs(gen, B, n, m):
    state = _ints(gen, 0, 2, B, n, m)
    version = _ints(gen, 1, 5, B, m)
    sync = torch.where(state > 0, version[:, None, :], 0).to(torch.int32)
    return (state, version, sync, _ints(gen, 0, 6, B, n, m),
            _ints(gen, 0, 2, B, n), _ints(gen, 0, m, B, n),
            _ints(gen, 0, 2, B, n))


@pytest.mark.parametrize("B,n,m", [
    (1, 1, 1), (33, 4, 3), (300, 16, 16),
    (24576, 16, 16),          # the content fleet
    (16384, 4, 3),            # the four scenarios' batch
    (1003, 16, 16),           # B not a multiple of a block's simulations
    (77, 32, 32),             # the staged path's widest slab
    (64, 40, 40),             # agents and artifacts past the staged budget
    (50, 8, 33),              # artifacts past it: the direct path
])
@pytest.mark.parametrize("eager,access_k", [(False, 0), (True, 0),
                                            (False, 3)])
def test_mesi_kernel_equals_plain(gen, B, n, m, eager, access_k):
    """Every output of the tick equal to the plain version's, on the
    staged path and, past its budget of a warp's lanes (n, m <= 32), on
    the direct path: ``plan`` says which ran."""
    staged = n <= 32 and m <= 32
    assert (mesi_transition.plan(n, m) > 0) == staged
    inputs = _mesi_inputs(gen, B, n, m)
    opts = dict(artifact_tokens=64, eager=eager, access_k=access_k)
    launches = mesi_transition.mesi_tick_.launches
    out = mesi_transition.mesi_tick(*inputs, **opts)
    torch.cuda.synchronize()
    assert mesi_transition.mesi_tick_.launches == launches + 1
    plain = [t.clone() for t in inputs[:4]]
    plain += list(mesi_transition.mesi_tick_plain_(*plain, *inputs[4:],
                                                   **opts))
    for got, exp in zip(out, plain):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("B,n,m", [(24576, 16, 16), (16384, 4, 3),
                                   (64, 40, 40)])
@pytest.mark.parametrize("eager,access_k", [(False, 0), (True, 0),
                                            (False, 3)])
def test_mesi_repeated_launches_agree(gen, B, n, m, eager, access_k):
    """50 launches of the in-place tick, each from the same inputs: every
    output equal to the first bit for bit."""
    inputs = _mesi_inputs(gen, B, n, m)
    opts = dict(artifact_tokens=64, eager=eager, access_k=access_k)

    def tick():
        state = [t.clone() for t in inputs[:4]]
        return state + list(mesi_transition.mesi_tick_(*state, *inputs[4:],
                                                       **opts))
    first = tick()
    for i in range(50):
        assert all(torch.equal(a, b) for a, b in zip(tick(), first)), i


def _chunk_inputs(gen, B, n, m, C, chain=False):
    """A MESI tick's ``miss`` and random chunk vectors lagging the
    authority by 0 or 1, write spans of 30 % of the chunks; with
    ``chain`` every agent fills and writes artifact 0 instead."""
    *_, acts, arts, writes = _mesi_inputs(gen, B, n, m)
    miss = mesi_transition.mesi_tick(*_mesi_inputs(gen, B, n, m)[:4], acts,
                                     arts, writes, artifact_tokens=64)[5]
    wact = (acts * writes).contiguous()
    if chain:
        miss, wact = torch.ones_like(miss), torch.ones_like(wact)
        arts = torch.zeros_like(arts)
    cv = _ints(gen, 1, 4, B, m, C)
    cs = torch.clamp(cv[:, None] - _ints(gen, 0, 2, B, n, m, C), min=0)
    return (cv, cs, (cv > 1).to(torch.int32), miss, wact, arts,
            draw_write_chunks(prng.split(prng.prng_key(5, "cuda"), B), n,
                              C, 0.3).to(torch.int32))


@pytest.mark.parametrize("B,n,m,C,chunk,tokens,chain", [
    (1, 1, 1, 1, 16, 11, False), (37, 4, 3, 5, 16, 75, False),
    (100, 16, 16, 70, 16, 1115, False),
    (300, 16, 16, 64, 64, 4096, False),   # the fleet's rows
    (64, 16, 16, 64, 64, 4090, True),     # one artifact, fill and write
    (64, 40, 40, 64, 64, 4096, False),    # past the staged budget
    (3, 16, 16, 4096, 1, 4096, False),    # 1-token chunks: rows in tiles
    (1, 16, 16, 64, 64, 4096, False),     # B = 1
    (50, 4, 3, 6, 16, 96, False),         # the content goldens' rows:
    (50, 4, 3, 3, 40, 96, False),         # 96 tokens, 16- and 40-token
])
def test_chunk_kernel_equals_plain(gen, B, n, m, C, chunk, tokens, chain):
    """Every output of the tick equal to the plain version's, on the
    staged path and where it does not take the shape (n or m above 32,
    C no multiple of 4) on the direct path: ``plan`` says which ran."""
    staged = n <= 32 and m <= 32 and C % 4 == 0
    assert (chunk_diff.plan(n, m, C) > 0) == staged
    opts = dict(artifact_tokens=tokens, chunk_tokens=chunk)
    inputs = _chunk_inputs(gen, B, n, m, C, chain)
    launches = chunk_diff.chunk_tick_.launches
    out = chunk_diff.chunk_tick(*inputs, **opts)
    torch.cuda.synchronize()
    assert chunk_diff.chunk_tick_.launches == launches + 1
    plain = [t.clone() for t in inputs[:3]]
    plain += list(chunk_diff.chunk_tick_plain_(*plain, *inputs[3:], **opts))
    for got, exp in zip(out, plain):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("B,n,m,C", [(24576, 16, 16, 64), (1000, 16, 16, 70)])
def test_chunk_tick_repeated_launches_agree(gen, B, n, m, C):
    """50 launches of the in-place tick, each from the same inputs: every
    output equal to the first bit for bit."""
    inputs = _chunk_inputs(gen, B, n, m, C)
    opts = dict(artifact_tokens=64 * C - 7, chunk_tokens=64)

    def tick():
        state = [t.clone() for t in inputs[:3]]
        return state + list(chunk_diff.chunk_tick_(*state, *inputs[3:],
                                                   **opts))
    first = tick()
    for i in range(50):
        assert all(torch.equal(a, b) for a, b in zip(tick(), first)), i


#: the service's tick shapes: the staged path's top (B = n + 1 prefix
#: simulations at n = 32 clients), the direct path at n > 32, and the
#: content plane's one-simulation chunk tick; then a shard's share of the
#: 6 artifacts on the sharded plane (K = 2: 2 / 4, K = 4: 1 / 2 / 1 / 2)
SERVICE_MESI_SHAPES = [(33, 32, 6), (49, 48, 6),
                       (33, 32, 1), (33, 32, 2), (33, 32, 4)]
SERVICE_CHUNK_SHAPES = [(1, 32, 6, 64),
                        (1, 32, 1, 64), (1, 32, 2, 64), (1, 32, 4, 64)]


@pytest.mark.parametrize("B,n,m", SERVICE_MESI_SHAPES)
@pytest.mark.parametrize("eager,access_k", [(False, 0), (True, 0),
                                            (False, 3)])
def test_mesi_service_shapes_exact_and_repeated(gen, B, n, m, eager,
                                                access_k):
    """The tick at the service's shapes: equal to the plain version, and
    50 more launches from the same inputs equal to the first bit for
    bit."""
    assert (mesi_transition.plan(n, m) > 0) == (n <= 32)
    inputs = _mesi_inputs(gen, B, n, m)
    opts = dict(artifact_tokens=4096, eager=eager, access_k=access_k)

    def tick():
        state = [t.clone() for t in inputs[:4]]
        return state + list(mesi_transition.mesi_tick_(*state, *inputs[4:],
                                                       **opts))
    first = tick()
    plain = [t.clone() for t in inputs[:4]]
    plain += list(mesi_transition.mesi_tick_plain_(*plain, *inputs[4:],
                                                   **opts))
    assert all(torch.equal(a, b) for a, b in zip(first, plain))
    for i in range(50):
        assert all(torch.equal(a, b) for a, b in zip(tick(), first)), i


@pytest.mark.parametrize("B,n,m,C", SERVICE_CHUNK_SHAPES)
def test_chunk_service_shape_exact_and_repeated(gen, B, n, m, C):
    inputs = _chunk_inputs(gen, B, n, m, C)
    opts = dict(artifact_tokens=64 * C, chunk_tokens=64)

    def tick():
        state = [t.clone() for t in inputs[:3]]
        return state + list(chunk_diff.chunk_tick_(*state, *inputs[3:],
                                                   **opts))
    first = tick()
    plain = [t.clone() for t in inputs[:3]]
    plain += list(chunk_diff.chunk_tick_plain_(*plain, *inputs[3:], **opts))
    assert all(torch.equal(a, b) for a, b in zip(first, plain))
    for i in range(50):
        assert all(torch.equal(a, b) for a, b in zip(tick(), first)), i


@pytest.mark.parametrize("strategy,chunk_tokens", [
    ("lazy", 64), ("eager", 0), ("access_count", 64)])
def test_decider_routes_agree_on_the_card(gen, strategy, chunk_tokens):
    """The decision layer's two routes on card-resident directories:
    equal decisions batch by batch, one tick launch (and with content one
    chunk tick launch) per kernel-route batch and none on the scan
    route."""
    import numpy as np
    from repro_torch.core import acs
    from repro_torch.service import BatchDecider
    n, m = 32, 6
    cfg = acs.ACSConfig(n_agents=n, n_artifacts=m, artifact_tokens=4096,
                        n_steps=1, strategy=acs.STRATEGY_CODES[strategy],
                        access_k=3, chunk_tokens=chunk_tokens)
    scan = BatchDecider(cfg, "scan", device="cuda")
    kernel = BatchDecider(cfg, "kernel", device="cuda")
    rng = np.random.default_rng(3)
    C = acs.content_chunks(cfg) if chunk_tokens else 0
    for step in range(12):
        acts = rng.random(n) < 0.7
        arts = rng.integers(0, m, n).astype(np.int32)
        writes = rng.random(n) < 0.3
        wc = (rng.random((n, C)) < 0.25) if C else None
        before = (mesi_transition.mesi_tick_.launches,
                  chunk_diff.chunk_tick_.launches)
        a = scan.decide(acts, arts, writes, write_chunks=wc)
        mid = (mesi_transition.mesi_tick_.launches,
               chunk_diff.chunk_tick_.launches)
        b = kernel.decide(acts, arts, writes, write_chunks=wc)
        after = (mesi_transition.mesi_tick_.launches,
                 chunk_diff.chunk_tick_.launches)
        assert mid == before
        assert (after[0] - mid[0], after[1] - mid[1]) == (1, int(bool(C)))
        np.testing.assert_array_equal(a.miss, b.miss)
        np.testing.assert_array_equal(a.version, b.version)
        assert a.ledger_delta == b.ledger_delta
        assert a.wire_delta == b.wire_delta
        if C:
            np.testing.assert_array_equal(a.fetched_chunks,
                                          b.fetched_chunks)
        np.testing.assert_array_equal(scan.host_state, kernel.host_state)
        np.testing.assert_array_equal(scan.host_version,
                                      kernel.host_version)
    for leaf in ("state", "version", "last_sync") + (
            ("chunk_version", "chunk_sync", "chunk_dirty") if C else ()):
        assert torch.equal(getattr(scan.arrays, leaf),
                           getattr(kernel.arrays, leaf)), leaf


def _sharded_plane(device, chunk_tokens, rounds=10):
    """A K = 4, hosts 4 plane over the service grid's 32 clients and 6
    artifacts of 4096 tokens, driven through ``rounds`` lockstep rounds
    of ``uniform``; returns the plane and the tick launches."""
    import asyncio
    from repro_torch.launch.service import artifact_names, build_workload
    from repro_torch.service import connect, drive_workload

    async def main():
        plane = connect(n_agents=32, artifacts=artifact_names(6),
                        artifact_tokens=4096, chunk_tokens=chunk_tokens,
                        shards=4, hosts=4, device=device)
        before = (mesi_transition.mesi_tick_.launches,
                  chunk_diff.chunk_tick_.launches)
        async with plane:
            await drive_workload(plane, build_workload(
                "uniform", 32, 6, 4096, rounds, seed=11), rounds, seed=11)
        return plane, (mesi_transition.mesi_tick_.launches - before[0],
                       chunk_diff.chunk_tick_.launches - before[1])
    return asyncio.run(main())


def _same_plane(a, b):
    import numpy as np
    assert dataclasses.astuple(a.ledger) == dataclasses.astuple(b.ledger)
    assert a.wire == b.wire and a.l1_wire == b.l1_wire
    for view in ("directory_state", "versions", "last_sync"):
        assert np.array_equal(getattr(a, view), getattr(b, view)), view
    assert a.trace.n_steps == b.trace.n_steps > 0
    for s1, s2 in zip(a.trace.steps, b.trace.steps):
        assert ((s1.agents, s1.arts, s1.writes, s1.miss, s1.version,
                 s1.chunks, s1.shard)
                == (s2.agents, s2.arts, s2.writes, s2.miss, s2.version,
                    s2.chunks, s2.shard))


@pytest.mark.parametrize("chunk_tokens", [0, 64])
def test_sharded_plane_on_four_streams_equals_the_cpu(gen, chunk_tokens):
    """K = 4 shards on four streams (of the one card, or round-robin over
    the host's cards): one tick launch (and with content one chunk tick)
    per shard micro-batch; equal to the same plane on the CPU, and to a
    second card run, to the integer."""
    from repro_torch.service import verify_broker
    card, launches = _sharded_plane("cuda", chunk_tokens)
    streams = {(s.device, s.stream_id) for s in card.streams}
    assert len(streams) == 4
    assert all(s.stream_id != torch.cuda.default_stream(s.device).stream_id
               for s in card.streams)
    assert all(s.device == d for d, s in card.placements)
    batches = sum(b.n_batches for b in card.brokers)
    assert launches == (batches, batches if chunk_tokens else 0)
    again, _ = _sharded_plane("cuda", chunk_tokens)
    cpu, cpu_launches = _sharded_plane("cpu", chunk_tokens)
    assert cpu_launches == (0, 0)
    _same_plane(card, again)
    _same_plane(card, cpu)
    assert "kernel" in verify_broker(card).implementations


def test_engine_routes_agree_on_the_card(gen):
    scn = dataclasses.replace(SCENARIOS["C"], n_runs=64)
    kern = run_scenario(scn, tick_backend="kernel")
    scan = run_scenario(scn, tick_backend="scan")
    assert (kern.per_run_total_tokens == scan.per_run_total_tokens).all()
    assert (kern.per_run_chr == scan.per_run_chr).all()
    w = zoo(n_agents=8, n_artifacts=6, n_runs=32, chunk_tokens=256)[0]
    kern = run_workload(w, tick_backend="kernel")
    scan = run_workload(w, tick_backend="scan")
    assert kern.stats.delta_bytes_mean == scan.stats.delta_bytes_mean
    assert (kern.per_run_total_tokens == scan.per_run_total_tokens).all()


# --- the sweep engine's shards (``engine._placed``): streams of one card
# --- stand in for cards; per-run ledgers equal to the unsharded run's

def _stream_shards(n):
    from repro_torch.sim import engine
    return engine._placed([("cuda:0", torch.cuda.Stream())
                           for _ in range(n)])


def _grid(items, cell_of, n_runs, devices, route=None):
    """Every per-run array of both variants of the grid of ``items``."""
    from repro_torch.sim import engine
    return engine._run_grid(items[0].acs, items, cell_of, n_runs, True,
                            route, torch.device("cuda"), True, devices)


def _same_grid(a, b):
    assert len(a) == len(b)
    for va, vb in zip(a, b):
        assert va.keys() == vb.keys()
        for key in va:
            assert (va[key] == vb[key]).all(), key


def _ticks():
    return (mesi_transition.mesi_tick_.launches,
            chunk_diff.chunk_tick_.launches)


@pytest.mark.parametrize("runs,shards,axis", [
    (256, 4, "runs"), (255, 4, "runs"), (257, 3, "workloads")])
def test_sweep_on_streams_equals_unsharded(gen, runs, shards, axis):
    """The content fleet's grid over streams of the card: every per-run
    ledger of both variants as unsharded, one launch of each tick per
    shard a step, on the runs, padded and workloads-axis plans."""
    from repro_torch.sim import engine
    ws = zoo(n_agents=16, n_artifacts=16, n_runs=runs, chunk_tokens=64)
    ref = _grid(ws, engine._workload_cell, runs, 1)
    with _stream_shards(shards):
        plan = engine.shard_plan(len(ws), runs, shards)
        before = _ticks()
        got = _grid(ws, engine._workload_cell, runs, shards)
        launched = tuple(a - b for a, b in zip(_ticks(), before))
    assert plan.axis == axis and plan.devices == shards
    assert launched == (shards * ws[0].acs.n_steps,) * 2
    _same_grid(got, ref)


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_scenarios_on_streams_equal_unsharded(gen, route):
    from repro_torch.sim import engine
    scns = [dataclasses.replace(SCENARIOS[k], n_runs=64) for k in "ABCD"]
    ref = _grid(scns, engine._scenario_cell, 64, 1, route)
    with _stream_shards(4):
        got = _grid(scns, engine._scenario_cell, 64, 4, route)
    _same_grid(got, ref)


def test_sharded_sweep_queues_without_host_sync(gen, monkeypatch):
    """Between building the shards' inputs and reading their outputs
    back, nothing waits for the card: every shard's draws and episodes
    are queued under ``set_sync_debug_mode("error")``, on both routes,
    with and without content, TTL included.  A read-back under that
    mode raises (the control)."""
    from repro_torch.core import acs
    from repro_torch.sim import compare_grid, compare_workloads, engine
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones(1, device="cuda").cpu()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    queue, queued = engine._queue, []

    def checked(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            queued.append(queue(*args))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return queued[-1]

    monkeypatch.setattr(engine, "_queue", checked)
    fleet = zoo(n_agents=16, n_artifacts=16, n_runs=64, chunk_tokens=64)
    small = zoo(n_agents=4, n_artifacts=3, n_runs=16, artifact_tokens=64,
                n_steps=5, chunk_tokens=16)
    scns = [dataclasses.replace(SCENARIOS[k], n_runs=64) for k in "ABCD"]
    ttl = dataclasses.replace(SCENARIOS["C"], n_runs=64).with_strategy(
        acs.TTL)
    with _stream_shards(4):
        compare_workloads(fleet, devices=4)
        compare_workloads(small, tick_backend="scan", devices=4)
        compare_grid(scns, devices=4)
        compare_grid(scns + [ttl], tick_backend="scan", devices=4)
    assert len(queued) == 4 * 5


def test_sweep_over_the_cards(gen, monkeypatch):
    """With two or more cards, ``REPRO_SWEEP_DEVICES=auto`` shards the
    public ``devices=None`` path over them (shard i on cuda:i) with every
    per-run ledger as on one card; unset, and on a named card, the grid
    is one batch (one launch of each tick a step); and a K = 4 plane's
    shards take min(4, cards) cards."""
    from repro_torch.launch.mesh import shard_devices
    from repro_torch.sim import compare_workloads, engine
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    runs = 64 * cards
    ws = zoo(n_agents=16, n_artifacts=16, n_runs=runs, chunk_tokens=64)
    steps = ws[0].acs.n_steps
    one = _grid(ws, engine._workload_cell, runs, None)
    for device in ("cuda", "cuda:1"):
        before = _ticks()
        assert compare_workloads(ws, device=device) == compare_workloads(
            ws, devices=1)
        launched = tuple(a - b for a, b in zip(_ticks(), before))
        assert launched == (2 * steps,) * 2
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", "auto")
    plan = engine.shard_plan(len(ws), runs)
    assert plan == engine.ShardPlan(cards, "runs", runs)
    before = _ticks()
    got = _grid(ws, engine._workload_cell, runs, None)
    launched = tuple(a - b for a, b in zip(_ticks(), before))
    assert launched == (cards * steps,) * 2
    _same_grid(got, one)
    assert compare_workloads(ws) == compare_workloads(ws, devices=1)
    placed = shard_devices(4)
    assert [d.index for d, _ in placed] == [s % min(4, cards)
                                            for s in range(4)]
    assert all(s.device == d for d, s in placed)


# --- model kernels: fp32 within 1e-5 on unit-scale inputs, bf16 within
# --- one bf16 ulp (rmsnorm) or 1e-2 (attention) of the plain version

def _normal(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, exp, dtype, atol):
    assert got.dtype == exp.dtype and got.shape == exp.shape
    err = (got.float() - exp.float()).abs().max().item()
    assert err <= (1e-5 if dtype == torch.float32 else atol), err


def _rmsnorm_checked(x, w):
    """The kernel once (one launch) against the plain version: bf16
    within one bf16 ulp of the plain value, fp32 within 1e-5."""
    launches = rmsnorm.launches
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == launches + 1
    exp = rmsnorm_plain(x, w)
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if x.dtype == torch.bfloat16:
        # one bf16 ulp of the plain value: x = m * 2**e with m in
        # [0.5, 1) has 8 significant bits, so its ulp is 2**(e - 8)
        ulp = torch.ldexp(torch.ones_like(exp, dtype=torch.float32),
                          torch.frexp(exp.float()).exponent - 8)
        assert bool(((got.float() - exp.float()).abs() <= ulp).all())
    else:
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 32), (7, 128), (300, 2048),
                                   (2, 3, 5, 256), (4, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_equals_plain(gen, shape, dtype):
    _rmsnorm_checked(_normal(gen, *shape, dtype=dtype),
                     _normal(gen, shape[-1], dtype=dtype))


@pytest.mark.parametrize("d", [64, 100, 128, 2048, 8192])
@pytest.mark.parametrize("rows", [1, 4, 33, 2113])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_widths_rows_and_views(gen, d, rows, offset, dtype):
    """Every team width (a warp a row up to 4 KB of row, 2-8 warps up to
    d 8192), row counts that leave the persistent grid's teams uneven
    (2113 is no multiple of a block's 8 one-warp teams), and x as a view
    one element into its buffer (offset 1): no 16-byte aligned pointer,
    so the kernel reads and writes element by element, as it does at
    d = 100, a width that is no multiple of its vector."""
    x = _normal(gen, rows * d + offset, dtype=dtype)[offset:].view(rows, d)
    _rmsnorm_checked(x, _normal(gen, d, dtype=dtype))


def _bf16_row_err(got, exp):
    """max |got - exp| over one bf16 ulp of exp plus 2**-10 of the rms of
    exp's row (last axis): at most 1 when both round nearly the same fp32
    result, as chip_smoke.py's check_attention holds attention."""
    exp32 = exp.float()
    ulp = torch.where(exp32 == 0, 0.0, torch.ldexp(
        torch.ones_like(exp32), torch.frexp(exp32).exponent - 8))
    allow = ulp + 2.0 ** -10 * exp32.square().mean(dim=-1,
                                                    keepdim=True).sqrt()
    return float(((got.float() - exp32).abs() / allow).max())


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,lq,lk", [
    (1, 2, 2, 1, 1),          # one row, one key
    (2, 8, 1, 70, 70),        # ragged tails, MQA (group 8)
    (1, 4, 2, 33, 130),       # Lq < Lk causal, group 2
    (2, 2, 2, 128, 128),      # whole tiles
    (1, 8, 1, 1000, 1000),    # group 8 over 8 q blocks and 16 key tiles
    (2, 4, 2, 200, 777),      # Lq < Lk, both ragged
    (1, 2, 2, 2048, 2048),    # 16 q blocks, 32 key tiles round the ring
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain(gen, d, b, hq, hkv, lq, lk,
                                             dtype):
    """fp32 within 1e-5; bf16 within 1e-2 and, element by element, within
    one bf16 ulp plus 2**-10 of its row's rms (a kernel that rounds P to
    bf16 before P V fails that)."""
    q = _normal(gen, b, hq, lq, d, dtype=dtype)
    k = _normal(gen, b, hkv, lk, d, dtype=dtype)
    v = _normal(gen, b, hkv, lk, d, dtype=dtype)
    for causal in (True, False):
        launches = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == launches + 1
        exp = attention_plain(q, k, v, causal=causal)
        _close(got, exp, dtype, 1e-2)
        if dtype == torch.bfloat16:
            assert _bf16_row_err(got, exp) <= 1.0, (causal, d)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (1, 8, 1, 6144, 6144, 256),   # one agent's prefill: 2 ring stages
    (2, 4, 2, 200, 777, 256),     # ragged, Lq < Lk
    (2, 4, 2, 1000, 1000, 128),   # ragged, 4 ring stages
])
def test_flash_attention_repeated_launches_agree(gen, b, hq, hkv, lq, lk, d):
    """Causal bf16 launched 60 times: every output passes the row gate
    and equals the first bit for bit.  Each element is summed in a fixed
    order, so a difference means a ring stage was overwritten while a
    warpgroup still read it, which depends on timing and may spare any
    single launch."""
    q = _normal(gen, b, hq, lq, d, dtype=torch.bfloat16)
    k, v = (_normal(gen, b, hkv, lk, d, dtype=torch.bfloat16)
            for _ in range(2))
    exp = attention_plain(q, k, v, causal=True)
    first = flash_attention(q, k, v, causal=True)
    for i in range(60):
        got = flash_attention(q, k, v, causal=True) if i else first
        assert _bf16_row_err(got, exp) <= 1.0, i
        assert torch.equal(got, first), i


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "flash_wgmma"),
                                         (torch.float32, "flash_fp32")])
def test_flash_attention_type_chooses_the_kernel(gen, dtype, entry):
    """bf16 runs the tensor-core kernel, fp32 the CUDA-core one (whose
    products stay fp32, not TF32): one launch each, named by the
    profiler, within the type's limit of the plain version."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = (_normal(gen, 1, 4, 300, 128, dtype=dtype) for _ in range(3))
    launches = flash_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    names = [ev.key for ev in prof.key_averages() if "flash_" in ev.key]
    assert len(names) == 1 and entry in names[0], names
    _close(got, attention_plain(q, k, v), dtype, 1e-2)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,L", [
    (4, 8, 1, 6176),          # gemma-2b's serving shape
    (3, 2, 1, 100),           # group 2, ragged cache
    (2, 4, 4, 1),             # group 1, one key
    (1, 8, 2, 257),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_equals_plain(gen, d, b, hq, hkv, L, dtype):
    q = _normal(gen, b, hq, d, dtype=dtype)
    kc = _normal(gen, b, hkv, L, d, dtype=dtype)
    vc = _normal(gen, b, hkv, L, d, dtype=dtype)
    lens = torch.randint(1, L + 1, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    for kv_len in (None, lens):
        launches = decode_attention.launches
        got = decode_attention(q, kc, vc, kv_len)
        torch.cuda.synchronize()
        assert decode_attention.launches == launches + 1
        _close(got, decode_attention_plain(q, kc, vc, kv_len), dtype, 1e-2)


def _decode_checked(q, kc, vc, kv_len):
    """The kernel once (one launch) against the plain version: fp32
    within 1e-5, bf16 within 1e-2 and the row gate."""
    launches = decode_attention.launches
    got = decode_attention(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert decode_attention.launches == launches + 1
    exp = decode_attention_plain(q, kc, vc, kv_len)
    _close(got, exp, q.dtype, 1e-2)
    if q.dtype == torch.bfloat16:
        assert _bf16_row_err(got, exp) <= 1.0
    return got


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,L", [
    (3, 8, 1, 1000),          # group 8 (MQA)
    (2, 6, 2, 300),           # group 3
    (3, 5, 5, 130),           # group 1 (MHA)
    (2, 8, 2, 777),           # group 4
    (1, 7, 1, 6176),          # group 7, gemma-2b's cache length
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kv_len_edges(gen, d, b, hq, hkv, L, dtype):
    """kv_len 1, 63, 64, 65, on the launch's split boundary and one past
    it, L, above L (masks nothing) and None, the other batch rows a few
    keys shorter: the split that holds the last key, the tile that holds
    it and the merge of the splits before it."""
    q = _normal(gen, b, hq, d, dtype=dtype)
    kc = _normal(gen, b, hkv, L, d, dtype=dtype)
    vc = _normal(gen, b, hkv, L, d, dtype=dtype)
    split_keys = plan(b, hq, hkv, L, d, dtype, q.device)[0]
    for n in (1, 63, 64, 65, split_keys, split_keys + 1, L, L + 7, None):
        lens = None if n is None else torch.tensor(
            [n] + [max(1, n - 3 * i) for i in range(1, b)],
            dtype=torch.int32, device="cuda")
        _decode_checked(q, kc, vc, lens)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_zero_kv_len_is_nan_as_plain(gen, d, dtype):
    """kv_len 0 masks every key, and the kernel writes NaN rows exactly
    where the plain version's softmax over no key gives NaN (the
    reference's 0/0); the other rows pass the usual gates."""
    q = _normal(gen, 4, 4, d, dtype=dtype)
    kc, vc = (_normal(gen, 4, 2, 300, d, dtype=dtype) for _ in range(2))
    lens = torch.tensor([0, 17, 0, 300], dtype=torch.int32, device="cuda")
    got = decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    exp = decode_attention_plain(q, kc, vc, lens)
    assert bool(exp[[0, 2]].isnan().all()) and not bool(
        exp[[1, 3]].isnan().any())
    assert torch.equal(got.isnan(), exp.isnan())
    _close(got[[1, 3]], exp[[1, 3]], dtype, 1e-2)
    if dtype == torch.bfloat16:
        assert _bf16_row_err(got[[1, 3]], exp[[1, 3]]) <= 1.0


@pytest.mark.parametrize("b,hq,hkv,L,d", [
    (4, 8, 1, 6176, 256),     # gemma-2b's batched decode
    (1, 8, 1, 6176, 256),     # one agent: 97 splits, two merge levels
    (8, 16, 8, 2048, 128),
])
def test_decode_attention_repeated_launches_agree(gen, b, hq, hkv, L, d):
    """bf16 launched 60 times over ragged lengths: every output passes
    the gates and equals the first bit for bit.  The splits finish in
    any order, so an output that changed would mean a merge that did not
    run in split order or a ticket not back at 0."""
    q = _normal(gen, b, hq, d, dtype=torch.bfloat16)
    kc, vc = (_normal(gen, b, hkv, L, d, dtype=torch.bfloat16)
              for _ in range(2))
    lens = torch.randint(L // 2, L + 1, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    first = _decode_checked(q, kc, vc, lens)
    for i in range(60):
        assert torch.equal(decode_attention(q, kc, vc, lens), first), i


def test_decode_attention_on_two_streams_at_once(gen):
    """bf16 decode calls queued on two streams at once, 30 on each, over
    different inputs, each launch merging its splits behind tickets:
    every output equals its inputs' first output bit for bit, so the
    streams' launches never take each other's tickets."""
    b, hq, hkv, L, d = 4, 8, 1, 6176, 256
    inputs = []
    for _ in range(2):
        q = _normal(gen, b, hq, d, dtype=torch.bfloat16)
        kc, vc = (_normal(gen, b, hkv, L, d, dtype=torch.bfloat16)
                  for _ in range(2))
        lens = torch.randint(L // 2, L + 1, (b,), generator=gen,
                             device="cuda", dtype=torch.int32)
        inputs.append((q, kc, vc, lens))
    assert plan(b, hq, hkv, L, d, torch.bfloat16, "cuda")[3] > 0
    firsts = [_decode_checked(*args) for args in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    outs = [[], []]
    torch.cuda.synchronize()
    for _ in range(30):
        for stream, args, got in zip(streams, inputs, outs):
            with torch.cuda.stream(stream):
                got.append(decode_attention(*args))
    torch.cuda.synchronize()
    for got, first in zip(outs, firsts):
        for i, out in enumerate(got):
            assert torch.equal(out, first), i


#: one decode call per kv_len under the profiler, in a fresh process: in a
#: process that had already run a device-only profiler session, a later
#: session recorded no device kernel of the cluster launch
_PROFILE_DECODE = """
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.decode_attention import decode_attention
gen = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn((4, 8, 256), generator=gen, device="cuda").bfloat16()
kc, vc = (torch.randn((4, 1, 3000, 256), generator=gen,
                      device="cuda").bfloat16() for _ in range(2))
lens = torch.tensor([2999, 3000, 3100, 17], dtype=torch.int32, device="cuda")
decode_attention(q, kc, vc, lens)    # built, planned, attributes set
torch.cuda.synchronize()
found = []
for kv_len in (lens, None):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_attention(q, kc, vc, kv_len)
        torch.cuda.synchronize()
    found.append([ev.name for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA
                  and not ev.is_user_annotation])
print(json.dumps(found))
"""


def test_decode_attention_launches_only_its_kernel(gen):
    """A call is one launch of the port's kernel and nothing else: no
    clamp, cast or fill of kv_len, no merge launch (the profiler sees one
    device kernel), with and without kv_len."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(src), env.get("PYTHONPATH")) if p)
    run = subprocess.run([sys.executable, "-c", _PROFILE_DECODE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    for kernels in json.loads(run.stdout.strip().splitlines()[-1]):
        assert len(kernels) == 1 and "decode_kernel" in kernels[0], kernels


def test_decode_attention_refuses_what_it_does_not_take(gen):
    q = _normal(gen, 2, 4, 64)
    kc = _normal(gen, 2, 2, 50, 64)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, kc, kc, torch.tensor([3, 50], device="cuda"))
    with pytest.raises(ValueError, match="query group"):
        decode_attention(_normal(gen, 2, 18, 64), kc, kc)
    with pytest.raises(RuntimeError, match="launch failed"):
        # a cache 4 bytes into its buffer: the kernel's 16-byte copies
        # refuse it
        kc_off = _normal(gen, kc.numel() + 1)[1:].view(kc.shape)
        decode_attention(q, kc_off, kc_off)


# --- rwkv6_scan: the final state bit for bit (the kernel rounds where the
# --- plain version's ops do); y in fp32 within 1e-5 of the rms of its
# --- head's output over the sequence, and in bf16 within one bf16 ulp of
# --- the plain value plus 2**-10 of its row's rms.  Not 1e-5 of the row's
# --- own rms in fp32: early in a sequence the state has low rank and a
# --- row of y is a sum that cancels, so even the plain version lies up to
# --- 1e-4 of such a row's rms from the same sum taken in fp64.

def _wkv_inputs(gen, b, t, h, dh, dtype, state):
    r, k, v = (_normal(gen, b, t, h, dh, dtype=dtype) for _ in range(3))
    # the model's decay range: exp(-exp(U(-8, -5)))
    w = torch.exp(-torch.exp(torch.rand((b, t, h, dh), generator=gen,
                                        device="cuda") * 3 - 8)).to(dtype)
    bonus = _normal(gen, h, dh) * 0.1
    s0 = _normal(gen, b, h, dh, dh) if state else None
    return r, k, v, w, bonus, s0


def _wkv_err(got, exp):
    """max |got - exp| over each element's allowance, y (B, T, H, dh):
    in fp32 1e-5 of the rms of its (b, h) head over T and dh; in bf16 one
    bf16 ulp of exp plus 2**-10 of its row's rms."""
    if exp.dtype != torch.float32:
        return _bf16_row_err(got, exp)
    exp32 = exp.float()
    allow = 1e-5 * exp32.square().mean(dim=(1, 3), keepdim=True).sqrt()
    return float(((got.float() - exp32).abs() / allow).max())


@pytest.mark.parametrize("b,t,h,dh,state", [
    (1, 1, 1, 64, False),       # one step
    (4, 1, 32, 64, True),       # a decode step of rwkv6-1.6b
    (2, 37, 3, 32, True),       # ragged T (not a multiple of the stage)
    (1, 200, 2, 32, False),     # the smoke configs' head size
    (2, 1000, 8, 64, False),
    (1, 6144, 32, 64, False),   # one agent's prefill of rwkv6-1.6b
    (4, 6144, 32, 64, False),   # its batched prefill
    (1, 77, 1, 64, True),       # B*H below the column split
    (1, 45, 1, 32, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel_equals_plain(gen, b, t, h, dh, state, dtype):
    args = _wkv_inputs(gen, b, t, h, dh, dtype, state)
    launches = rwkv6_scan.launches
    y, s = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == launches + 1
    ey, es = rwkv6_scan_plain(*args)
    assert y.dtype == dtype and s.dtype == torch.float32
    assert y.shape == ey.shape and s.shape == es.shape
    assert torch.equal(s, es)
    assert _wkv_err(y, ey) <= 1.0


@pytest.mark.parametrize("b,t,h,dh", [(4, 6144, 32, 64), (1, 6144, 32, 64),
                                     (4, 1, 32, 64), (3, 77, 5, 32)])
def test_rwkv6_scan_repeated_launches_agree(gen, b, t, h, dh):
    """fp32 launched 50 times more: y and the final state equal to the
    first launch's bit for bit (a stage of the ring refilled too early, or
    partial sums read before they are complete, would show in some
    launches and not others)."""
    args = _wkv_inputs(gen, b, t, h, dh, torch.float32, True)
    y, s = rwkv6_scan(*args)
    for i in range(50):
        y2, s2 = rwkv6_scan(*args)
        assert torch.equal(y2, y) and torch.equal(s2, s), i


def test_rwkv6_scan_cpu_tensors_never_reach_the_kernel(gen):
    args = [None if a is None else a.cpu()
            for a in _wkv_inputs(gen, 1, 5, 2, 64, torch.float32, True)]
    launches = rwkv6_scan.launches
    y, s = rwkv6_scan(*args)
    assert rwkv6_scan.launches == launches
    assert y.device.type == "cpu" and s.device.type == "cpu"
    with pytest.raises(ValueError, match="one CUDA device"):
        rwkv6_scan(args[0].cuda(), *args[1:])


# ---------------------------------------------------------------- training
# The backward kernels against autograd of their plain versions.  Gates
# (PERF.md section 2): fp32 max-abs within 1e-4 of the reference tensor's
# largest magnitude; bf16 relative L2 within 1e-2 per tensor and each
# element within 2 bf16 ulps of the reference plus 2**-8 of its tensor's
# rms.

def _grad_gate(got, exp, what=""):
    assert got.dtype == exp.dtype and got.shape == exp.shape, what
    g, e = got.float(), exp.float()
    if exp.dtype == torch.float32:
        err = float((g - e).abs().max())
        assert err <= 1e-4 * max(float(e.abs().max()), 1e-30), (what, err)
        return
    rel = float(torch.linalg.vector_norm(g - e)
                / torch.linalg.vector_norm(e).clamp_min(1e-30))
    assert rel <= 1e-2, (what, rel)
    ulp = torch.where(e == 0, 0.0, torch.ldexp(
        torch.ones_like(e), torch.frexp(e).exponent - 8))
    allow = 2 * ulp + 2.0 ** -8 * e.square().mean().sqrt()
    assert bool(((g - e).abs() <= allow).all()), (what, float(
        ((g - e).abs() / allow).max()))


def _attention_grads(gen, b, hq, hkv, lq, lk, d, dtype, causal=True):
    from repro_torch.kernels.ref import attention_bwd_plain
    q = _normal(gen, b, hq, lq, d, dtype=dtype)
    k, v = (_normal(gen, b, hkv, lk, d, dtype=dtype) for _ in range(2))
    dout = _normal(gen, b, hq, lq, d, dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + 1
    return got, attention_bwd_plain(q, k, v, dout, causal=causal), (
        q, k, v, dout)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("lq,lk", [(64, 64), (100, 100), (37, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_equals_plain(gen, d, hq, hkv, lq, lk, dtype):
    """dq, dk, dv through the autograd route (forward kernel with row
    statistics, backward kernel) against autograd of the plain version:
    query groups 1, 2 and 8, every head dim, whole and ragged tiles,
    Lq < Lk."""
    got, exp, _ = _attention_grads(gen, 2, hq, hkv, lq, lk, d, dtype)
    for name, g, e in zip("qkv", got, exp):
        _grad_gate(g, e, f"d{name}")


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_equals_plain(gen, d, dtype):
    """The forward's row statistics (natural log-sum-exp of the scaled
    logits) against the plain version's, and the output unchanged by
    writing them."""
    from repro_torch.kernels.flash_attention import _forward
    from repro_torch.kernels.ref import attention_lse_plain
    q = _normal(gen, 2, 4, 150, d, dtype=dtype)
    k, v = (_normal(gen, 2, 2, 200, d, dtype=dtype) for _ in range(2))
    out, lse = _forward(q, k, v, True, None, with_lse=True)
    plain, none = _forward(q, k, v, True, None, with_lse=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, plain)
    err = float((lse - attention_lse_plain(q, k)).abs().max())
    assert err <= (1e-5 if dtype == torch.float32 else 1e-3), err


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (4, 8, 1, 2048, 2048, 256),   # gemma-2b's training shape
    (2, 16, 8, 300, 300, 128),    # qwen3-1.7b's heads, ragged
])
def test_flash_attention_bwd_repeated_launches_agree(gen, b, hq, hkv, lq,
                                                     lk, d):
    """The backward launched 20 times more on the same inputs: dq, dk, dv
    equal to the first bit for bit (no atomics: gemma-2b's dk and dv sum
    over its 8 query heads in one fixed order)."""
    first, exp, (q, k, v, dout) = _attention_grads(
        gen, b, hq, hkv, lq, lk, d, torch.bfloat16)
    for name, g, e in zip("qkv", first, exp):
        _grad_gate(g, e, f"d{name}")
    _, lse = _lse(q, k, v)
    for i in range(20):
        again = flash_attention_bwd(q, k, v, dout, lse)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


def _lse(q, k, v):
    from repro_torch.kernels.flash_attention import _forward
    return _forward(q, k, v, True, None, with_lse=True)


@pytest.mark.parametrize("hq,hkv,lq,lk,d", [
    (8, 1, 2049, 2049, 256),   # one past a 64-key tile (and a 128-row one)
    (4, 2, 2049, 2049, 64),
    (8, 1, 1, 1001, 128),      # a single query row at the end of 1001 keys
    (8, 1, 63, 1001, 64),
    (8, 1, 65, 1001, 256),
    (4, 2, 65, 1001, 32),
])
def test_flash_attention_bwd_ragged_tiles(gen, hq, hkv, lq, lk, d):
    """bf16 lengths that end one past a tile and short query blocks at the
    end of a long key range: the dQ pass's skipped warpgroups, the padded
    row statistics (+inf and 0 past Lq) and the dK/dV pass's first causal
    q tile."""
    got, exp, _ = _attention_grads(gen, 1, hq, hkv, lq, lk, d,
                                   torch.bfloat16)
    for name, g, e in zip("qkv", got, exp):
        _grad_gate(g, e, f"d{name}")


@pytest.mark.parametrize("lq,d", [(300, 128), (2048, 256)])
def test_flash_attention_bwd_head_split_on_and_off(gen, monkeypatch, lq, d):
    """Group 8 (MQA) with the dK/dV pass's head split forced off (the plan
    read on a card of one SM) and on (on a card so wide that the group
    splits in 4, two heads a block): dQ bit-equal either way (the dQ pass
    does not depend on it), dK and dV each within the gate of autograd of
    the plain version (the split sums the partials in another order),
    and 20 more launches with the split on bit-equal (the partials are
    summed in split order, not in the order blocks finish)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_bwd_plain
    b, hq, hkv = (4, 8, 1) if d == 256 else (2, 8, 1)
    q = _normal(gen, b, hq, lq, d, dtype=torch.bfloat16)
    k, v = (_normal(gen, b, hkv, lq, d, dtype=torch.bfloat16)
            for _ in range(2))
    dout = _normal(gen, b, hq, lq, d, dtype=torch.bfloat16)
    _, lse = _lse(q, k, v)
    exp = attention_bwd_plain(q, k, v, dout, causal=True)
    runs = {}
    for sms in (1, 100_000):
        assert fa.bwd_plan(b, hq, hkv, lq, lq, d, sms).head_splits == (
            1 if sms == 1 else 4)
        monkeypatch.setattr(fa, "_sm_count", lambda index, n=sms: n)
        runs[sms] = flash_attention_bwd(q, k, v, dout, lse)
        torch.cuda.synchronize()
        for name, g, e in zip("qkv", runs[sms], exp):
            _grad_gate(g, e, f"d{name}, {sms} SMs")
        if sms > 1:
            for i in range(20):
                again = flash_attention_bwd(q, k, v, dout, lse)
                assert all(torch.equal(a, f)
                           for a, f in zip(again, runs[sms])), i
    assert torch.equal(runs[1][0], runs[100_000][0])


#: the share of a cast-first bf16 ``rmsnorm``'s elements that may differ
#: from its plain twin (the first rounding of x_hat falls the other way in
#: a few elements a million; the TPU kernel's order differs in ~1/4)
CAST_FIRST_DIFF_SHARE = 1e-4


@pytest.mark.parametrize("shape", [(1, 32), (7, 128), (300, 2048),
                                   (2, 3, 5, 256), (4, 8192), (33, 100),
                                   (2113, 128), (8192, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_cast_first_equals_its_plain_twin(gen, shape, dtype):
    """The cast-first order (the model's ``norm_apply``) with a trained
    scale, one launch each way: the forward against
    ``rmsnorm_cast_first_plain`` (bf16: within |w| one ulp of x_hat plus
    half an ulp each of the two results, since the first rounding may
    fall the other way where the two sums of squares differ, and in at
    most ``CAST_FIRST_DIFF_SHARE`` of the elements, at least one; the
    TPU kernel's order, as a control, must differ in more, checked at
    4096 elements or more, where its quarter lies far above the limit;
    fp32 within 1e-5), the
    backward through autograd against autograd of the twin at the
    gradient gates."""
    from repro_torch.kernels.ref import (rmsnorm_bwd_plain,
                                         rmsnorm_cast_first_plain)
    x = _normal(gen, *shape, dtype=dtype)
    w = (1 + 0.3 * _normal(gen, shape[-1])).to(dtype)
    dy = _normal(gen, *shape, dtype=dtype)
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    fwd, bwd = rmsnorm.launches, rmsnorm_bwd.launches
    out = rmsnorm(*leaves, cast_first=True)
    got = torch.autograd.grad(out, leaves, dy)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm_bwd.launches) == (fwd + 1, bwd + 1)
    exp = rmsnorm_cast_first_plain(x, w)
    if dtype == torch.float32:
        torch.testing.assert_close(out.detach(), exp, rtol=1e-5, atol=1e-5)
    else:
        e32 = exp.float()
        x32 = x.float()
        xhat = (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                                  + 1e-6)).to(dtype).float()

        def ulp(t):
            return torch.where(t == 0, 0.0, torch.ldexp(
                torch.ones_like(t), torch.frexp(t).exponent - 8))
        got32 = out.detach().float()
        allow = w.float().abs() * ulp(xhat) + 0.5 * (ulp(got32) + ulp(e32))
        assert bool(((got32 - e32).abs() <= allow).all())
        limit = max(CAST_FIRST_DIFF_SHARE * x.numel(), 1)
        assert int((out.detach() != exp).sum()) <= limit
        if x.numel() >= 4096:
            assert int((rmsnorm(x, w) != exp).sum()) > limit
    for name, g, e in zip(("dx", "dw"), got, rmsnorm_bwd_plain(
            x, w, dy, cast_first=True)):
        _grad_gate(g, e, name)


@pytest.mark.parametrize("rows,d", [(8192, 2048), (8192 * 16, 128)])
def test_rmsnorm_cast_first_repeated_launches_agree(gen, rows, d):
    """Both kernels in the cast-first order, 50 launches more each,
    bit-equal."""
    x, dy = (_normal(gen, rows, d, dtype=torch.bfloat16) for _ in range(2))
    w = (1 + 0.3 * _normal(gen, d)).bfloat16()
    first_fwd = rmsnorm(x, w, cast_first=True)
    first = rmsnorm_bwd(x, w, dy, cast_first=True)
    for i in range(50):
        assert torch.equal(rmsnorm(x, w, cast_first=True), first_fwd), i
        again = rmsnorm_bwd(x, w, dy, cast_first=True)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


@pytest.mark.parametrize("shape", [(1, 32), (7, 128), (300, 2048),
                                   (2, 3, 5, 256), (4, 8192), (33, 100),
                                   (2113, 128), (8192, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_equals_plain(gen, shape, dtype):
    """dx and dweight through the autograd route against autograd of the
    plain version: every team width, a width that is no multiple of the
    vector (element by element), uneven teams, gemma-2b's rows."""
    from repro_torch.kernels.ref import rmsnorm_bwd_plain
    x = _normal(gen, *shape, dtype=dtype)
    w = _normal(gen, shape[-1], dtype=dtype)
    dy = _normal(gen, *shape, dtype=dtype)
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    fwd, bwd = rmsnorm.launches, rmsnorm_bwd.launches
    got = torch.autograd.grad(rmsnorm(*leaves), leaves, dy)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm_bwd.launches) == (fwd + 1, bwd + 1)
    for name, g, e in zip(("dx", "dw"), got, rmsnorm_bwd_plain(x, w, dy)):
        _grad_gate(g, e, name)


@pytest.mark.parametrize("rows,d", [(8192, 2048), (8192 * 16, 128)])
def test_rmsnorm_bwd_repeated_launches_agree(gen, rows, d):
    """20 launches more, bit-equal: dweight's partials are summed in a
    fixed order."""
    x, dy = (_normal(gen, rows, d, dtype=torch.bfloat16) for _ in range(2))
    w = _normal(gen, d, dtype=torch.bfloat16)
    first = rmsnorm_bwd(x, w, dy)
    for i in range(20):
        again = rmsnorm_bwd(x, w, dy)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


def _rmsnorm_bwd_case(gen, rows, d, dtype, offset=0):
    """x, w, dy of the backward; offset 1 makes x and dy views one
    element into their buffers, so no pointer is 16-byte aligned."""
    x, dy = (_normal(gen, rows * d + offset, dtype=dtype)[offset:]
             .view(rows, d) for _ in range(2))
    w = (1 + 0.3 * _normal(gen, d)).to(dtype)
    return x, w, dy


#: the ring design's edges (rows, d, dtype name, offset): fewer rows than
#: the grid's blocks, so that most blocks have none; row counts that are
#: no multiple of a stage's rows (4 at bf16 d 2048, 64 at d 128) or of
#: the blocks; fp32 d 8192, the widest row (one block an SM, one row a
#: stage); bf16 d 100, 200-byte rows the bulk copy cannot take; views one
#: element into their buffers (no pointer 16-byte aligned)
RING_EDGES = [(1, 2048, "bfloat16", 0), (5, 2048, "bfloat16", 0),
              (131, 2048, "bfloat16", 0), (8191, 2048, "bfloat16", 0),
              (1001, 128, "bfloat16", 0), (300, 8192, "float32", 0),
              (333, 100, "bfloat16", 0), (257, 2048, "bfloat16", 1),
              (65, 1000, "float32", 1)]


@pytest.mark.parametrize("rows,d,dtype,offset", RING_EDGES)
@pytest.mark.parametrize("cast_first", [False, True])
def test_rmsnorm_bwd_ring_edges(gen, rows, d, dtype, offset, cast_first):
    """One launch each against autograd of the plain version in the same
    cast order, at the gradient gates."""
    from repro_torch.kernels.ref import rmsnorm_bwd_plain
    x, w, dy = _rmsnorm_bwd_case(gen, rows, d, getattr(torch, dtype), offset)
    launches = rmsnorm_bwd.launches
    got = rmsnorm_bwd(x, w, dy, cast_first=cast_first)
    torch.cuda.synchronize()
    assert rmsnorm_bwd.launches == launches + 1
    exp = rmsnorm_bwd_plain(x, w, dy, cast_first=cast_first)
    for name, g, e in zip(("dx", "dw"), got, exp):
        _grad_gate(g, e, name)


@pytest.mark.parametrize("cast_first", [False, True])
def test_rmsnorm_bwd_element_path_repeats_bit_equal(gen, cast_first):
    """bf16 d 100 (rows loaded element by element): 20 launches more,
    bit-equal."""
    x, w, dy = _rmsnorm_bwd_case(gen, 333, 100, torch.bfloat16)
    first = rmsnorm_bwd(x, w, dy, cast_first=cast_first)
    for i in range(20):
        again = rmsnorm_bwd(x, w, dy, cast_first=cast_first)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


@pytest.mark.parametrize("rows,d", [(8192, 2048), (8192 * 16, 128),
                                    (300, 8192)])
def test_rmsnorm_bwd_scratch_is_the_grids_partial_rows(gen, rows, d):
    """The call's device memory beyond its inputs and outputs (the peak
    during the call) is at most the grid's partial rows, blocks * d
    floats, plus 64 KiB for the allocator's rounding (the earlier
    per-block-partials design took 1024 * d floats)."""
    from repro_torch.kernels.backend import sm_count
    from repro_torch.kernels.rmsnorm import bwd_plan
    x, w, dy = _rmsnorm_bwd_case(gen, rows, d, torch.bfloat16)
    rmsnorm_bwd(x, w, dy)   # built and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    outputs = sum(g.numel() * g.element_size() for g in got)
    extra = torch.cuda.max_memory_allocated() - before - outputs
    plan = bwd_plan(d, 2, sm_count(x.get_device()))
    assert plan.scratch_floats == plan.blocks * d < 1024 * d
    assert extra <= 4 * plan.blocks * d + (1 << 16), extra


@pytest.mark.parametrize("d", [1, 64, 100, 128, 1000, 2048, 4100, 8192])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_rmsnorm_bwd_plan_is_the_kernels_layout(gen, d, itemsize):
    """The wrapper's plan asks for the shared memory that the kernel's
    layout takes (``rmsnorm_bwd_smem``), which the card allows."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import sm_count
    from repro_torch.kernels.rmsnorm import bwd_plan
    smem = build.entry("rmsnorm_bwd", "rmsnorm_bwd_smem",
                       [ctypes.c_int] * 4)
    plan = bwd_plan(d, itemsize, sm_count(0))
    dtype = 0 if itemsize == 4 else 1
    assert smem(d, dtype, plan.rows_per_stage, plan.stages) == \
        plan.smem_bytes > 0


def test_kernels_without_backward_raise_under_grad(gen):
    """decode_attention has no backward kernel: with an input that
    requires a gradient under grad mode it raises, so no output leaves the
    autograd graph unnoticed; under no_grad it launches.  rwkv6_scan has
    one: under grad mode its result carries a gradient, the backward
    kernel's, held to autograd of the plain version; under no_grad it is
    the serving launch, no checkpoints."""
    q = _normal(gen, 2, 4, 64).requires_grad_(True)
    kc, vc = (_normal(gen, 2, 2, 16, 64) for _ in range(2))
    with pytest.raises(NotImplementedError, match="backward"):
        decode_attention(q, kc, vc)
    args = list(_wkv_inputs(gen, 1, 5, 2, 64, torch.float32, False))
    args[0] = args[0].requires_grad_(True)
    before = rwkv6_scan.launches, rwkv6_scan_bwd.launches
    y, _ = rwkv6_scan(*args)
    dy = _normal(gen, *y.shape)
    (dr,) = torch.autograd.grad(y, args[0], dy)
    assert (rwkv6_scan.launches, rwkv6_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _grad_gate(dr, rwkv6_scan_bwd_plain(*[a.detach() if a is not None
                                          else None for a in args],
                                        dy)[0], "dr")
    with torch.no_grad():
        decode_attention(q, kc, vc)
        rwkv6_scan(*args)
    torch.cuda.synchronize()


def _train_launches(cfg) -> dict:
    """Kernel launches of one train step of a dense model with each
    superblock checkpointed: the forward's norms (two a layer, two more
    with qk-norm, the final norm) and attention, the recomputed layers'
    again, then one backward launch each (the final norm's included)."""
    norms = (2 + 2 * cfg.use_qk_norm) * cfg.n_layers
    return {"rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1,
            "flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-1.7b"])
def test_value_and_grad_step_on_the_card_equals_the_cpu(gen, arch):
    """One smoke train step (fp32, ``value_and_grad_step``'s optimizer)
    on the card, through the forward and backward kernels, against the
    same step on the CPU's plain route: the loss within 1e-4 relative,
    every gradient leaf within 1e-4 of the leaf's largest magnitude, and
    the card's AdamW update equal, within 1e-6, to the CPU's update from
    the card's own gradients.  (Params after the step
    are not compared across devices directly: AdamW's first step moves
    each param by lr * g / (|g| + eps), so a gradient near eps = 1e-8
    that differs in its last bits moves its param by up to lr.)"""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = smoke_config(arch)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    cpu = init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    wrappers = {"rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd,
                "flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd}
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), cpu)
        before = {k: fn.launches for k, fn in wrappers.items()}
        loss, grads = steps.value_and_grad(
            params, cfg, {"tokens": toks.to(dev), "labels": toks.to(dev)})
        torch.cuda.synchronize()
        launches = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        updated, _, _ = adamw.apply_updates(
            opt, params, grads, adamw.init_state(opt, params))
        out[dev] = float(loss), grads, updated, launches
    assert out["cpu"][3] == dict.fromkeys(wrappers, 0)
    assert out["cuda"][3] == _train_launches(cfg)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for i, (a, b) in enumerate(zip(tree_leaves(out["cuda"][1]),
                                   tree_leaves(out["cpu"][1]))):
        assert a.device.type == "cuda"
        _grad_gate(a.cpu(), b, f"leaf {i}")
    card_grads = tree_map(lambda t: t.cpu(), out["cuda"][1])
    again, _, _ = adamw.apply_updates(opt, tree_map(torch.clone, cpu),
                                      card_grads, adamw.init_state(opt, cpu))
    for a, b in zip(tree_leaves(out["cuda"][2]), tree_leaves(again)):
        assert float((a.cpu() - b).abs().max()) <= 1e-6


# --- the WKV backward (rwkv6_scan_bwd.cu) against the plain reverse
# --- recurrence, at the fp32 gate of the backward kernels (max-abs within
# --- 1e-4 of the reference tensor's largest magnitude)

def _wkv_bwd_case(gen, b, t, h, dh, state, dstate, every=None):
    args = _wkv_inputs(gen, b, t, h, dh, torch.float32, state)
    dy = _normal(gen, b, t, h, dh)
    ds = _normal(gen, b, h, dh, dh) if dstate else None
    return args, dy, ds


@pytest.mark.parametrize("b,t,h,dh,state,dstate", [
    (1, 1, 1, 64, False, False),     # one step
    (2, 333, 2, 64, True, True),     # ragged T, past a checkpoint
    (1, 45, 1, 32, True, False),     # the smoke head size, one chunk
    (3, 130, 4, 32, False, True),    # T one past two checkpoints
    (2, 1000, 8, 64, False, False),
    (4, 2048, 32, 64, False, False),  # rwkv6-1.6b's training shape
])
def test_rwkv6_scan_bwd_equals_plain(gen, b, t, h, dh, state, dstate):
    args, dy, ds = _wkv_bwd_case(gen, b, t, h, dh, state, dstate)
    y, s, ckpt = rwkv6_scan_checkpoints(*args)
    launches = rwkv6_scan_bwd.launches
    got = rwkv6_scan_bwd(*args[:5], ckpt, dy, ds)
    torch.cuda.synchronize()
    assert rwkv6_scan_bwd.launches == launches + 1
    exp = rwkv6_scan_bwd_plain(*args, dy, ds)
    for name, g, e in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                          exp):
        _grad_gate(g, e, name)


@pytest.mark.parametrize("b,t,h,dh,every", [
    (3, 77, 5, 32, 64),      # dh 32 (clusters of 2), odd B * H
    (2, 5, 3, 64, 64),       # T below one 8-step sub-chunk
    (3, 6, 5, 32, 32),
    (2, 65, 3, 64, 64),      # T one past a multiple of 8 (and of every)
    (1, 33, 2, 32, 32),
    (2, 129, 2, 64, 128),
    (8, 300, 40, 64, 64),    # 1280 blocks: more than one resident wave
])
def test_rwkv6_scan_bwd_cluster_edges(gen, b, t, h, dh, every):
    """The backward's cluster of a head's row groups at its edges, with
    an initial state and a final state's gradient: every gradient at the
    fp32 gate against the plain reverse recurrence."""
    args, dy, ds = _wkv_bwd_case(gen, b, t, h, dh, True, True)
    ckpt = rwkv6_scan_checkpoints(*args, every=every)[2]
    got = rwkv6_scan_bwd(*args[:5], ckpt, dy, ds, every=every)
    torch.cuda.synchronize()
    exp = rwkv6_scan_bwd_plain(*args, dy, ds)
    for name, g, e in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                          exp):
        _grad_gate(g, e, name)


@pytest.mark.parametrize("b,t,h,dh", [(4, 2048, 32, 64), (2, 1000, 8, 64),
                                     (3, 77, 5, 32)])
def test_rwkv6_scan_bwd_scratch_is_not_proportional_to_t(gen, b, t, h, dh):
    """The backward's device memory beyond its inputs and outputs (the
    peak during the call) is at most B * H * dh floats, du's partials,
    plus a fixed allowance for the allocator's rounding: dv is summed in
    the cluster's shared memory, not in a (dh / 16) * B * T * H * dh-float
    scratch."""
    from repro_torch.kernels.rwkv6_scan import bwd_scratch_floats
    args, dy, ds = _wkv_bwd_case(gen, b, t, h, dh, True, True)
    ckpt = rwkv6_scan_checkpoints(*args)[2]
    rwkv6_scan_bwd(*args[:5], ckpt, dy, ds)   # built and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = rwkv6_scan_bwd(*args[:5], ckpt, dy, ds)
    torch.cuda.synchronize()
    outputs = sum(g.numel() * g.element_size() for g in got)
    extra = torch.cuda.max_memory_allocated() - before - outputs
    assert bwd_scratch_floats(b, h, dh) == b * h * dh
    assert extra <= 4 * b * h * dh + (1 << 20), extra


def test_rwkv6_scan_checkpoints_are_the_forward_states(gen):
    """The checkpointing launch gives the serving launch's y and final
    state bit for bit, and checkpoint c is, bit for bit, the final state
    of the first c * CKPT steps (checkpoint 0 the initial state)."""
    from repro_torch.kernels.rwkv6_scan import CKPT
    args = _wkv_inputs(gen, 2, 3 * CKPT + 5, 4, 64, torch.float32, True)
    y, s, ckpt = rwkv6_scan_checkpoints(*args)
    ey, es = rwkv6_scan(*args)
    assert torch.equal(y, ey) and torch.equal(s, es)
    assert ckpt.shape == (2, 4, 4, 64, 64)
    assert torch.equal(ckpt[:, :, 0], args[5])
    r, k, v, w, bonus, s0 = args
    for c in range(1, 4):
        cut = c * CKPT
        _, sc = rwkv6_scan(r[:, :cut].contiguous(), k[:, :cut].contiguous(),
                           v[:, :cut].contiguous(), w[:, :cut].contiguous(),
                           bonus, s0)
        assert torch.equal(ckpt[:, :, c], sc), c


def test_rwkv6_scan_bwd_does_not_depend_on_the_checkpoint_spacing(gen):
    """Checkpoints 32, 64, 128 or 256 steps apart give the same gradients
    bit for bit: every state the backward recomputes equals the forward's
    (dw reads each of them)."""
    args, dy, ds = _wkv_bwd_case(gen, 2, 600, 4, 64, True, True)
    outs = []
    for every in (32, 64, 128, 256):
        ckpt = rwkv6_scan_checkpoints(*args, every=every)[2]
        outs.append(rwkv6_scan_bwd(*args[:5], ckpt, dy, ds, every=every))
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other, outs[0]))


@pytest.mark.parametrize("b,t,h,dh", [(4, 2048, 32, 64), (2, 333, 2, 64),
                                     (3, 77, 5, 32)])
def test_rwkv6_scan_bwd_repeated_launches_agree(gen, b, t, h, dh):
    """50 more launches equal the first bit for bit: no atomics, every
    sum in a fixed order."""
    args, dy, ds = _wkv_bwd_case(gen, b, t, h, dh, True, True)
    ckpt = rwkv6_scan_checkpoints(*args)[2]
    first = rwkv6_scan_bwd(*args[:5], ckpt, dy, ds)
    for i in range(50):
        again = rwkv6_scan_bwd(*args[:5], ckpt, dy, ds)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


def test_rwkv6_scan_grad_through_autograd(gen):
    """Every input's gradient through the autograd function (one
    checkpointing forward and one backward launch) against autograd of
    the plain version, with an initial state and a used final state; a
    bf16 input under grad raises."""
    args, dy, ds = _wkv_bwd_case(gen, 2, 200, 4, 64, True, True)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = rwkv6_scan.launches, rwkv6_scan_bwd.launches
    y, s = rwkv6_scan(*leaves)
    got = torch.autograd.grad((y, s), leaves, (dy, ds))
    assert (rwkv6_scan.launches, rwkv6_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [a.clone().requires_grad_(True) for a in args]
    exp = torch.autograd.grad(rwkv6_scan_plain(*plain), plain, (dy, ds))
    for i, (g, e) in enumerate(zip(got, exp)):
        _grad_gate(g, e, f"input {i}")
    half = [a.to(torch.bfloat16).requires_grad_(True) for a in args[:4]]
    with pytest.raises(TypeError, match="fp32"):
        rwkv6_scan(*half, args[4], None)


def test_rwkv6_train_step_on_the_card_equals_the_cpu(gen):
    """One rwkv6 smoke train step (fp32, T = 32, two of its 16-step
    chunks) on the card through the WKV forward and backward kernels and
    the norm kernels, against the CPU's plain route: the loss within 1e-4
    relative and every gradient leaf within 1e-4 of its largest
    magnitude; per step 3 norms a layer twice (the recompute) plus the
    final norm, and twice a layer the WKV forward, once its backward."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime import steps
    cfg = smoke_config("rwkv6-1.6b")
    cpu = init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    wrappers = {"rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd,
                "rwkv6_scan": rwkv6_scan, "rwkv6_scan_bwd": rwkv6_scan_bwd}
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), cpu)
        before = {k: fn.launches for k, fn in wrappers.items()}
        loss, grads = steps.value_and_grad(
            params, cfg, {"tokens": toks.to(dev), "labels": toks.to(dev)})
        torch.cuda.synchronize()
        out[dev] = float(loss), grads, {
            k: fn.launches - before[k] for k, fn in wrappers.items()}
    n = cfg.n_layers
    assert out["cpu"][2] == dict.fromkeys(wrappers, 0)
    assert out["cuda"][2] == {"rmsnorm": 6 * n + 1, "rmsnorm_bwd": 3 * n + 1,
                              "rwkv6_scan": 2 * n, "rwkv6_scan_bwd": n}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for i, (a, b) in enumerate(zip(tree_leaves(out["cuda"][1]),
                                   tree_leaves(out["cpu"][1]))):
        _grad_gate(a.cpu(), b, f"leaf {i}")


# --- the MoE feed-forward (models/moe.py, batched PyTorch, no kernel of
# --- its own): the card against the CPU in fp32, and bf16 repeats

def _moe_layer(cfg, device, dtype, drawn_on="cpu"):
    """An MoE layer's params drawn from seed 0 on ``drawn_on``, on
    ``device``."""
    from repro_torch.models import moe
    gen = torch.Generator(device=drawn_on).manual_seed(0)
    p = moe.moe_init(gen, cfg, dtype, drawn_on)
    return {k: v.to(device) for k, v in p.items()}


@pytest.mark.parametrize("slices", [1, 4])
def test_moe_apply_on_the_card_equals_the_cpu(gen, slices):
    """olmoe's smoke MoE layer (8 experts, top 4) in fp32 at 256 tokens,
    with tight capacity (1.25, so tokens drop): the experts chosen and the
    tokens dropped alike, y within 1e-5 and the aux loss within 1e-6 of
    the CPU's."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    cfg = smoke_config("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25, dispatch_slices=slices))
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        p = _moe_layer(cfg, dev, torch.float32)
        y, aux = moe.moe_apply(p, cfg, x.to(dev))
        out[dev] = y.cpu(), float(aux)
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 1e-5
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-6


def test_bf16_moe_repeats_bit_equal(gen):
    """An olmoe-1b-7b layer's MoE at its registered width (d 2048, 64
    experts, top 8 of 1024) in bf16 over 4096 tokens: 20 more calls equal
    the first bit for bit (the combine adds in a fixed order, no
    atomics)."""
    from repro_torch.configs import get
    from repro_torch.models import moe
    cfg = get("olmoe-1b-7b")
    p = _moe_layer(cfg, "cuda", torch.bfloat16, drawn_on="cuda")
    x = _normal(gen, 2, 2048, cfg.d_model, dtype=torch.bfloat16)
    y, aux = moe.moe_apply(p, cfg, x)
    for i in range(20):
        y2, aux2 = moe.moe_apply(p, cfg, x)
        assert torch.equal(y2, y) and torch.equal(aux2, aux), i


# --- the attention kernels in the modes cross-attention and the encoder
# --- run: non-causal flash with Lq != Lk (forward and backward) and
# --- decode over a whole write-once cross cache


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,dtype", [
    (2, 8, 2, 700, 300, 64, torch.float32),     # Lq > Lk
    (2, 8, 2, 700, 300, 64, torch.bfloat16),
    (1, 8, 1, 333, 1001, 256, torch.bfloat16),  # a ragged last key tile
    (1, 16, 16, 1536, 1024, 64, torch.bfloat16),   # whisper's cross heads
    (1, 64, 8, 600, 1024, 128, torch.bfloat16),    # the vlm's cross heads
    (1, 4, 2, 1000, 1, 128, torch.bfloat16),    # one key
])
def test_flash_attention_non_causal_any_lengths(gen, b, hq, hkv, lq, lk, d,
                                                dtype):
    """Non-causal attention, Lq above and below Lk, against the plain
    version: fp32 within 1e-5, bf16 within 1e-2 and the row gate; the
    row statistics within LSE_REL of the plain ones."""
    from repro_torch.kernels.flash_attention import _forward
    from repro_torch.kernels.ref import attention_lse_plain
    q = _normal(gen, b, hq, lq, d, dtype=dtype)
    k, v = (_normal(gen, b, hkv, lk, d, dtype=dtype) for _ in range(2))
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    exp = attention_plain(q, k, v, causal=False)
    _close(got, exp, dtype, 1e-2)
    if dtype == torch.bfloat16:
        assert _bf16_row_err(got, exp) <= 1.0
    out, lse = _forward(q, k, v, False, None, with_lse=True)
    assert torch.equal(out, got)
    want = attention_lse_plain(q, k, causal=False)
    assert float((lse - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,dtype", [
    (2, 8, 2, 300, 700, 64, torch.float32),
    (2, 8, 2, 700, 300, 64, torch.float32),     # Lq > Lk
    (2, 8, 2, 700, 300, 64, torch.bfloat16),
    (1, 8, 1, 333, 1001, 256, torch.bfloat16),  # ragged, group 8 split
    (1, 16, 16, 256, 1024, 64, torch.bfloat16),   # whisper's cross heads
    (1, 16, 16, 1001, 1001, 64, torch.bfloat16),  # its encoder's, ragged
    (2, 4, 2, 65, 5, 128, torch.bfloat16),      # five keys, Lq > Lk
])
def test_flash_attention_bwd_non_causal_equals_plain(gen, b, hq, hkv, lq, lk,
                                                     d, dtype):
    """dq, dk, dv of non-causal attention through the autograd route
    against autograd of the plain version: every q tile reaches every key
    tile, whatever Lq and Lk.  (Not one key: there P = 1 and dq is 0 in
    exact arithmetic, so a relative gate compares rounding noise.)"""
    got, exp, _ = _attention_grads(gen, b, hq, hkv, lq, lk, d, dtype,
                                   causal=False)
    for name, g, e in zip("qkv", got, exp):
        _grad_gate(g, e, f"d{name}")


@pytest.mark.parametrize("b,hq,hkv,L,d", [
    (4, 16, 16, 4096, 64),     # whisper's cross cache (group 1)
    (4, 64, 8, 1024, 128),     # the vlm's cross cache (group 8)
    (2, 8, 2, 1001, 64),       # ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_over_a_whole_cross_cache(gen, b, hq, hkv, L, d,
                                                   dtype):
    """One token over a whole write-once cache, ``kv_len = L`` for every
    row (the cross sublayer's decode): the key split without a ragged
    tail, equal to ``kv_len=None``."""
    q = _normal(gen, b, hq, d, dtype=dtype)
    kc, vc = (_normal(gen, b, hkv, L, d, dtype=dtype) for _ in range(2))
    full = torch.full((b,), L, dtype=torch.int32, device="cuda")
    got = _decode_checked(q, kc, vc, full)
    assert torch.equal(got, decode_attention(q, kc, vc, None))


def _wake(tree, g):
    """Every gate to 1, every norm scale to 1 + 0.3 N(0, 1) and every bias
    to 0.1 N(0, 1), drawn from ``g``, in place."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _wake(leaf, g)
        elif key == "gate":
            leaf.fill_(1.0)
        elif key == "scale":
            leaf.copy_(1.0 + 0.3 * torch.randn(leaf.shape, generator=g))
        elif key in ("bias", "bq", "bk", "bv", "bo", "b_in", "b_out"):
            leaf.copy_(0.1 * torch.randn(leaf.shape, generator=g))


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_context_model_on_the_card_equals_the_cpu(gen, arch):
    """A smoke model with cross layers (fp32; every gate 1, the layernorm
    scales and the biases moved off their init) prefilled with a context
    and 4 greedy steps on the card, through the kernels, against the same
    on the CPU's plain route: every logit within 1e-4 of the largest and
    the greedy tokens equal; the launch counts of the path exact."""
    from repro_torch import models
    from repro_torch.configs import smoke_config
    from repro_torch.models.common import tree_map
    cfg = smoke_config(arch)
    cpu = models.init_params(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(1)
    _wake(cpu, g)
    t = 16 if cfg.family == "vlm" else 300
    ctx = torch.randn((2, t, cfg.d_model), generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, 77), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda a: a.to(dev, copy=True), cpu)
        before = (flash_attention.launches, decode_attention.launches)
        cache = models.init_cache(cfg, 2, 81, ctx_len=t, device=dev)
        logits, cache = models.prefill(params, cfg, toks.to(dev), cache,
                                       context=ctx.to(dev))
        steps = [logits.cpu()]
        for _ in range(4):
            nxt = torch.argmax(logits[:, -1], -1)[:, None]
            logits, cache = models.decode_step(params, cfg, nxt, cache)
            steps.append(logits.cpu())
        torch.cuda.synchronize()
        out[dev] = torch.cat(steps, 1), (
            flash_attention.launches - before[0],
            decode_attention.launches - before[1])
    specs = models.layer_specs(cfg)
    mixers = sum(sp.mixer in ("attn", "cross") for sp in specs)
    subs = sum(sp.cross for sp in specs)
    assert out["cpu"][1] == (0, 0)
    assert out["cuda"][1] == (mixers + subs + cfg.encoder_layers,
                              4 * (mixers + subs))
    got, exp = out["cuda"][0], out["cpu"][0]
    assert float((got - exp).abs().max()) <= 1e-4 * float(exp.abs().max())
    assert torch.equal(got.argmax(-1), exp.argmax(-1))


def _tp_inputs():
    """The vlm's smoke model (fp32, awake) on the CPU, 2 x 16 vision
    embeddings and 2 x 77 prompt tokens."""
    from repro_torch import models
    from repro_torch.configs import smoke_config
    cfg = smoke_config("llama-3.2-vision-90b")
    params = models.init_params(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(1)
    _wake(params, g)
    ctx = torch.randn((2, cfg.vision.n_image_tokens, cfg.d_model),
                      generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, 77), generator=g)
    return cfg, params, ctx, toks


TP_STEPS = 4


def _tp_rank(rank, store, out):
    """One of two gloo ranks on card 0 serving the vlm's smoke model over
    (data 1, model 2): a prefill and ``TP_STEPS`` greedy steps through
    the tensor-parallel steps; its logits and launches to ``out``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import steps
    from repro_torch.runtime import tensor_parallel as tp
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        cfg, params, ctx, toks = _tp_inputs()
        local = tp.shard_params(cfg, tree_map(lambda a: a.cuda(), params),
                                mesh)
        cache = tp.init_cache(cfg, 2, 77 + TP_STEPS, ctx_len=ctx.shape[1],
                              mesh=mesh, device="cuda")
        before = (flash_attention.launches, decode_attention.launches,
                  rmsnorm.launches)
        logits, cache = steps.make_prefill_step(cfg, mesh)(
            local, {"tokens": toks.cuda(), "vision_embeds": ctx.cuda()},
            cache)
        decode = steps.make_decode_step(cfg, mesh)
        out_steps = [logits.cpu()]
        for _ in range(TP_STEPS):
            logits, cache = decode(
                local, torch.argmax(logits[:, -1], -1)[:, None], cache)
            out_steps.append(logits.cpu())
        torch.cuda.synchronize()
        after = (flash_attention.launches, decode_attention.launches,
                 rmsnorm.launches)
        torch.save({"logits": torch.cat(out_steps, 1),
                    "launches": [a - b for a, b in zip(after, before)]},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_tensor_parallel_vlm_on_one_card_equals_the_cpu(gen, tmp_path):
    """Two gloo ranks on card 0, each half the vlm smoke model's heads,
    FFN channels and vocab, through the kernels, against the one-rank
    model on the CPU's plain route: every logit within 1e-4 of the
    largest, the greedy tokens equal, each rank's launches exact (5
    flash, 5 decode a step, 11 rmsnorm a forward)."""
    import multiprocessing
    import time
    from repro_torch import models
    from repro_torch.kernels import build
    build.build(["flash_attention", "decode_attention", "rmsnorm"])
    cfg, params, ctx, toks = _tp_inputs()
    cache = models.init_cache(cfg, 2, 77 + TP_STEPS, ctx_len=ctx.shape[1],
                              device="cpu")
    logits, cache = models.prefill(params, cfg, toks, cache, context=ctx)
    want = [logits]
    for _ in range(TP_STEPS):
        logits, cache = models.decode_step(
            params, cfg, torch.argmax(logits[:, -1], -1)[:, None], cache)
        want.append(logits)
    want = torch.cat(want, 1)
    ctx_mp = multiprocessing.get_context("spawn")
    procs = [ctx_mp.Process(target=_tp_rank,
                            args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not any(alive) and all(p.exitcode == 0 for p in procs)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["launches"] == [5, 5 * TP_STEPS, 11 * (1 + TP_STEPS)]
        err = float((got["logits"] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (r, err)
        assert torch.equal(got["logits"].argmax(-1), want.argmax(-1))


# --- MLA's head-dim pair: a q / k head of 192 (128 + 64 rope) and a v head
# --- of 128 (deepseek-v2-lite), forward, backward and decode, each at the
# --- gates of its equal-dim instances

MLA = (192, 128)


def _pair_inputs(gen, b, hq, hkv, lq, lk, dtype):
    dk, dv = MLA
    return (_normal(gen, b, hq, lq, dk, dtype=dtype),
            _normal(gen, b, hkv, lk, dk, dtype=dtype),
            _normal(gen, b, hkv, lk, dv, dtype=dtype))


@pytest.mark.parametrize("b,hq,hkv,lq,lk", [
    (1, 2, 2, 1, 1),          # one row, one key
    (2, 16, 16, 70, 70),      # deepseek's heads, ragged tails
    (1, 4, 2, 33, 130),       # Lq < Lk, group 2
    (2, 2, 2, 128, 128),      # whole tiles
    (1, 16, 16, 1000, 1000),  # 8 q blocks, 16 key tiles round the ring
    (2, 4, 4, 200, 777),      # Lq < Lk, both ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_pair_equals_plain(gen, b, hq, hkv, lq, lk,
                                               dtype):
    """The (192, 128) instance, causal and not, at MLA's scale: fp32
    within 1e-5, bf16 within 1e-2 and the row gate; the output is 128
    wide."""
    q, k, v = _pair_inputs(gen, b, hq, hkv, lq, lk, dtype)
    for causal in (True, False):
        launches = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal, scale=192 ** -0.5)
        torch.cuda.synchronize()
        assert flash_attention.launches == launches + 1
        assert got.shape == (b, hq, lq, MLA[1])
        exp = attention_plain(q, k, v, causal=causal, scale=192 ** -0.5)
        _close(got, exp, dtype, 1e-2)
        if dtype == torch.bfloat16:
            assert _bf16_row_err(got, exp) <= 1.0, causal


def test_flash_attention_mla_pair_repeated_launches_agree(gen):
    """Causal bf16 at deepseek's heads over 2048 tokens, 60 launches:
    every output passes the row gate and equals the first bit for bit (the
    4-stage K/V ring shared by two warpgroups)."""
    q, k, v = _pair_inputs(gen, 1, 16, 16, 2048, 2048, torch.bfloat16)
    exp = attention_plain(q, k, v, causal=True)
    first = flash_attention(q, k, v, causal=True)
    for i in range(60):
        got = flash_attention(q, k, v, causal=True) if i else first
        assert _bf16_row_err(got, exp) <= 1.0, i
        assert torch.equal(got, first), i


def _pair_grads(gen, b, hq, hkv, lq, lk, dtype, causal=True):
    from repro_torch.kernels.ref import attention_bwd_plain
    q, k, v = _pair_inputs(gen, b, hq, hkv, lq, lk, dtype)
    dout = _normal(gen, b, hq, lq, MLA[1], dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + 1
    return got, attention_bwd_plain(q, k, v, dout, causal=causal), (
        q, k, v, dout)


@pytest.mark.parametrize("hq,hkv,lq,lk,dtype", [
    (hq, hkv, lq, lk, dtype)
    for hq, hkv in ((2, 2), (4, 2), (16, 16))
    for lq, lk in ((64, 64), (100, 100), (37, 130))
    for dtype in (torch.float32, torch.bfloat16)]
    + [(16, 16, 2049, 2049, torch.bfloat16)])
def test_flash_attention_bwd_mla_pair_equals_plain(gen, hq, hkv, lq, lk,
                                                   dtype):
    """dq (192 wide), dk (192) and dv (128) through the autograd route
    against autograd of the plain version, causal and not: groups 1 and
    2, whole and ragged tiles, Lq < Lk, and at deepseek's heads one past
    a 64-key tile."""
    for causal in (True, False):
        got, exp, _ = _pair_grads(gen, 1, hq, hkv, lq, lk, dtype, causal)
        for name, g, e in zip("qkv", got, exp):
            _grad_gate(g, e, f"d{name}, causal {causal}")


def test_flash_attention_bwd_mla_pair_repeats_bit_equal(gen):
    """deepseek-v2-lite's training shape (4, 16, 16, 2048): the backward
    launched 50 times more, dq, dk, dv equal to the first bit for bit (no
    atomics; group 1 never splits its heads)."""
    from repro_torch.kernels import flash_attention as fa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fa.bwd_plan(4, 16, 16, 2048, 2048, 192, sms).head_splits == 1
    first, exp, (q, k, v, dout) = _pair_grads(gen, 4, 16, 16, 2048, 2048,
                                              torch.bfloat16)
    for name, g, e in zip("qkv", first, exp):
        _grad_gate(g, e, f"d{name}")
    _, lse = _lse(q, k, v)
    for i in range(50):
        again = flash_attention_bwd(q, k, v, dout, lse)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


@pytest.mark.parametrize("b,hq,hkv,L", [
    (4, 16, 16, 6176),        # deepseek's batched decode
    (3, 4, 4, 100),           # ragged cache
    (2, 2, 2, 1),             # one key
    (1, 8, 4, 257),           # group 2
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_mla_pair_equals_plain(gen, b, hq, hkv, L, dtype):
    """One token over a 192-wide key cache and a 128-wide value cache at
    MLA's scale, ragged kv_len (1, a split boundary, L) and None."""
    dk, dv = MLA
    q = _normal(gen, b, hq, dk, dtype=dtype)
    kc = _normal(gen, b, hkv, L, dk, dtype=dtype)
    vc = _normal(gen, b, hkv, L, dv, dtype=dtype)
    lens = torch.randint(1, L + 1, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    edges = [torch.full((b,), n, dtype=torch.int32, device="cuda")
             for n in sorted({1, min(64, L), min(65, L), L})]
    for kv_len in [None, lens] + edges:
        launches = decode_attention.launches
        got = decode_attention(q, kc, vc, kv_len, scale=dk ** -0.5)
        torch.cuda.synchronize()
        assert decode_attention.launches == launches + 1
        assert got.shape == (b, hq, dv)
        exp = decode_attention_plain(q, kc, vc, kv_len, scale=dk ** -0.5)
        _close(got, exp, dtype, 1e-2)
        if dtype == torch.bfloat16:
            assert _bf16_row_err(got, exp) <= 1.0


def test_decode_attention_mla_pair_repeated_launches_agree(gen):
    dk, dv = MLA
    q = _normal(gen, 4, 16, dk, dtype=torch.bfloat16)
    kc = _normal(gen, 4, 16, 6176, dk, dtype=torch.bfloat16)
    vc = _normal(gen, 4, 16, 6176, dv, dtype=torch.bfloat16)
    lens = torch.tensor([6145, 6150, 6176, 6160], dtype=torch.int32,
                        device="cuda")
    first = decode_attention(q, kc, vc, lens)
    for i in range(50):
        assert torch.equal(decode_attention(q, kc, vc, lens), first), i


def test_unlisted_head_dim_pairs_raise_on_the_card(gen):
    """A pair the kernels are not built for, (192, 64), raises on CUDA
    tensors (no launch, no plain version), forward, backward and decode."""
    q = _normal(gen, 1, 2, 70, 192, dtype=torch.bfloat16)
    k = _normal(gen, 1, 2, 70, 192, dtype=torch.bfloat16)
    v = _normal(gen, 1, 2, 70, 64, dtype=torch.bfloat16)
    before = (flash_attention.launches, flash_attention_bwd.launches,
              decode_attention.launches)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v)
    lse = torch.zeros((1, 2, 70), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_bwd(q, k, v, _normal(gen, 1, 2, 70, 64,
                                             dtype=torch.bfloat16), lse)
    with pytest.raises(ValueError, match="head dims"):
        decode_attention(q[:, :, 0].contiguous(), k, v)
    assert before == (flash_attention.launches, flash_attention_bwd.launches,
                      decode_attention.launches)


# ------------------------------------------------------------------ Mamba
# The causal conv: the output equal to its plain version bit for bit in
# bf16 and within one ulp of its type in fp32 (the kernel and PyTorch's
# SiLU both take x / (1 + expf(-x)); the share of differing elements is
# printed), the new state bit for bit.  The selective scan: y and the
# final state within 1e-5 of their rms; its gated mode within one ulp of
# the unfused chain it replaces (the fp32 mode between mamba.py's torch
# ops; bit for bit expected, the share that differs printed), its state
# bit for bit the fp32 mode's.  The backward kernels at the backward gates
# above at d_state 8 and 16, 50 more launches bit-equal (no atomics).

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import selective_scan as scan_mod  # noqa: E402
from repro_torch.kernels.causal_conv1d import (  # noqa: E402
    causal_conv1d, causal_conv1d_bwd, causal_conv1d_bwd_plain,
    causal_conv1d_plain)
from repro_torch.kernels.ref import selective_scan_gated_plain  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan, selective_scan_bwd, selective_scan_bwd_plain,
    selective_scan_checkpoints, selective_scan_gated, selective_scan_plain)

#: (B, T, d_inner, d_state, with a state): the smoke config's shape, a
#: ragged one (d_inner 384, not a power of two), a decode step of jamba
#: from a state, jamba's training shape
MAMBA_SHAPES = [(2, 64, 256, 8, False), (2, 333, 384, 16, True),
                (4, 1, 16384, 16, True), (4, 2048, 16384, 16, False)]


def _conv_case(gen, b, t, d, dtype, state):
    """x as the x half of an input projection (row stride 2d), the
    weights, a bias off its init, a state or None."""
    xz = _normal(gen, b, t, 2 * d, dtype=dtype)
    return (xz[..., :d], (_normal(gen, 4, d) * 0.3).to(dtype),
            (_normal(gen, d) * 0.1).to(dtype),
            _normal(gen, b, 3, d, dtype=dtype) if state else None)


def _ulp_err(got, exp):
    """max |got - exp| in ulps of exp's type at exp."""
    e = exp.float()
    bits = 8 if exp.dtype == torch.bfloat16 else 24
    ulp = torch.ldexp(torch.ones_like(e), torch.frexp(e).exponent - bits)
    return float(((got.float() - e).abs() / ulp).max())


#: the conv's packed path at its edges besides ``MAMBA_SHAPES``: a tile
#: shorter than the rows a thread has in flight, a 64-step tile and 6 more
#: steps on 17 threads' worth of channels, from a state
CONV_EDGES = [(1, 7, 128, 0, True), (3, 70, 136, 0, True)]


@pytest.mark.parametrize("b,t,d,n,state", MAMBA_SHAPES + CONV_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv1d_kernel_equals_plain(gen, b, t, d, n, state, dtype):
    args = _conv_case(gen, b, t, d, dtype, state)
    launches = causal_conv1d.launches
    out, new = causal_conv1d(*args)
    torch.cuda.synchronize()
    assert causal_conv1d.launches == launches + 1
    eo, en = causal_conv1d_plain(*args)
    assert out.dtype == dtype and out.shape == eo.shape
    assert torch.equal(new, en)
    share = float((out != eo).float().mean())
    print(f"conv {dtype} {(b, t, d)}: differing share {share}")
    assert _ulp_err(out, eo) <= 1.0


#: the conv backward at its edges besides ``MAMBA_SHAPES`` and
#: ``CONV_EDGES``: fewer steps than its ring of rows in flight and than
#: the 3 rows past a tile, one tile and 2 steps from a state
CONV_BWD_EDGES = [(2, 2, 128, 0, True), (1, 130, 384, 0, True)]


@pytest.mark.parametrize("b,t,d,n,state",
                         MAMBA_SHAPES + CONV_EDGES + CONV_BWD_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv1d_bwd_equals_plain(gen, b, t, d, n, state, dtype):
    x, w, bias, st = _conv_case(gen, b, t, d, dtype, state)
    dout = _normal(gen, b, t, d, dtype=dtype)
    dnew = _normal(gen, b, 3, d, dtype=dtype) if state else None
    launches = causal_conv1d_bwd.launches
    got = causal_conv1d_bwd(x, w, bias, st, dout, dnew)
    torch.cuda.synchronize()
    assert causal_conv1d_bwd.launches == launches + 1
    exp = causal_conv1d_bwd_plain(x, w, bias, st, dout, dnew)
    for name, g, e in zip(("dx", "dw", "db", "dstate"), got, exp):
        _grad_gate(g, e, name)


@pytest.mark.parametrize("b,t,d,state,dtype", [
    (4, 2048, 16384, False, torch.bfloat16),   # jamba's training shape
    (2, 333, 384, True, torch.float32)])
def test_causal_conv1d_bwd_repeated_launches_agree(gen, b, t, d, state,
                                                    dtype):
    x, w, bias, st = _conv_case(gen, b, t, d, dtype, state)
    dout = _normal(gen, b, t, d, dtype=dtype)
    dnew = _normal(gen, b, 3, d, dtype=dtype) if state else None
    first = causal_conv1d_bwd(x, w, bias, st, dout, dnew)
    for i in range(50):
        again = causal_conv1d_bwd(x, w, bias, st, dout, dnew)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


def _scan_case(gen, b, t, d, n, state):
    """dt as the model makes it (softplus around its bias's init), a =
    -(1..n) scaled, b, c, x N(0, 1), d_skip around 1, a state or None."""
    dt = torch.nn.functional.softplus(_normal(gen, b, t, d) - 3.0)
    a = -torch.exp(_normal(gen, d, n) * 0.3) * torch.arange(
        1, n + 1, device="cuda")
    return (dt, a, _normal(gen, b, t, n), _normal(gen, b, t, n),
            _normal(gen, b, t, d), 1 + 0.3 * _normal(gen, d),
            _normal(gen, b, d, n) * 0.5 if state else None)


def _rms_err(got, exp):
    return float((got - exp).abs().max() / exp.square().mean().sqrt())


@pytest.mark.parametrize("b,t,d,n,state", MAMBA_SHAPES)
def test_selective_scan_kernel_equals_plain(gen, b, t, d, n, state):
    args = _scan_case(gen, b, t, d, n, state)
    launches = selective_scan.launches
    y, s = selective_scan(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == launches + 1
    ey, es = selective_scan_plain(*args)
    print(f"scan {(b, t, d, n)}: state bit-equal {torch.equal(s, es)}")
    assert _rms_err(y, ey) <= 1e-5 and _rms_err(s, es) <= 1e-5


@pytest.mark.parametrize("b,t,d,n,state", MAMBA_SHAPES)
def test_selective_scan_checkpoints_and_bwd_equal_plain(gen, b, t, d, n,
                                                        state):
    """The checkpointing forward's y and state bit-equal to the serving
    launch's, then the backward from its checkpoints against the plain
    reverse recurrence, with the final state's gradient."""
    args = _scan_case(gen, b, t, d, n, state)
    y, s = selective_scan(*args)
    y2, s2, ck = selective_scan_checkpoints(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    dy, dstate = _normal(gen, b, t, d), _normal(gen, b, d, n) * 0.5
    launches = selective_scan_bwd.launches
    got = selective_scan_bwd(*args[:6], ck, dy, dstate)
    torch.cuda.synchronize()
    assert selective_scan_bwd.launches == launches + 1
    exp = selective_scan_bwd_plain(*args, dy, dstate)
    for name, g, e in zip(("ddt", "da", "db", "dc", "dx", "dd_skip",
                           "dstate0"), got, exp):
        _grad_gate(g, e, name)


def _gated_case(gen, b, t, d, n, state, dtype):
    """The gated mode's inputs: dt's raw projection 0.5 N(0, 1) and its
    bias at its init (the inverse softplus of U(1e-3, 1e-1)), x and z
    (z the strided half of an input projection) in ``dtype``, a, b, c,
    d_skip and the state as ``_scan_case``."""
    _, a, bm, cm, _, dskip, st = _scan_case(gen, b, t, d, n, state)
    dt0 = 1e-3 + (1e-1 - 1e-3) * torch.rand(d, generator=gen, device="cuda")
    z = _normal(gen, b, t, 2 * d, dtype=dtype)[..., d:]
    return ((0.5 * _normal(gen, b, t, d)).to(dtype),
            torch.log(torch.expm1(dt0)), a, bm, cm,
            _normal(gen, b, t, d, dtype=dtype), z, dskip, st)


def _unfused(raw, bias, a, bm, cm, x, z, dskip, st):
    """The chain the gated mode replaces: the fp32 mode between the torch
    ops of ``models/mamba.py`` (softplus, the casts, the SiLU gate)."""
    y, h = selective_scan(torch.nn.functional.softplus(raw.float() + bias),
                          a, bm, cm, x.float(), dskip, st)
    return y.to(x.dtype) * torch.nn.functional.silu(z), h


def _gated_checked(args):
    """One gated launch against the unfused chain (within one ulp, bit for
    bit expected; the state bit for bit) and against the plain chain (the
    state within 1e-5 of its rms); returns the output and state."""
    launches = selective_scan.launches
    out, s = selective_scan_gated(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == launches + 1
    co, cs = _unfused(*args)
    po, ps = selective_scan_gated_plain(*args)
    x = args[5]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"gated {tuple(x.shape)} {x.dtype} lanes "
          f"{scan_mod.plan(x.shape[0], x.shape[2], sms)}: differing share "
          f"vs unfused {float((out != co).float().mean())}, vs plain max "
          f"ulps {_ulp_err(out, po)}")
    assert out.dtype == x.dtype and out.shape == x.shape
    assert _ulp_err(out, co) <= 1.0 and torch.equal(s, cs)
    assert _rms_err(s, ps) <= 1e-5
    return out, s


@pytest.mark.parametrize("b,t,d,n,state", MAMBA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_gated_equals_the_unfused_chain(gen, b, t, d, n,
                                                       state, dtype):
    _gated_checked(_gated_case(gen, b, t, d, n, state, dtype))


#: (B, T, d_inner, d_state, with a state) at each lane split's edges: one
#: stage short of a full one in one block, a ragged tail over three
#: blocks at d_state 8, exactly one stage, a decode step from a state
LANE_EDGES = [(1, 5, 128, 16, False), (2, 17, 384, 8, True),
              (3, 8, 256, 16, True), (2, 1, 128, 8, True)]


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("b,t,d,n,state", LANE_EDGES)
def test_selective_scan_every_lane_split(gen, monkeypatch, lanes, b, t, d,
                                         n, state):
    """Both modes with the channel's states forced onto 1, 2 or 4 lanes:
    the fp32 mode against the plain scan, the gated mode against its
    chain; the states equal whatever the split."""
    monkeypatch.setattr(scan_mod, "plan", lambda *_: lanes)
    args = _scan_case(gen, b, t, d, n, state)
    y, s = selective_scan(*args)
    ey, es = selective_scan_plain(*args)
    assert _rms_err(y, ey) <= 1e-5 and _rms_err(s, es) <= 1e-5
    _, gs = _gated_checked(_gated_case(gen, b, t, d, n, state,
                                       torch.bfloat16))
    monkeypatch.setattr(scan_mod, "plan", lambda *_: 1)
    assert torch.equal(selective_scan(*args)[1], s)


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_selective_scan_long_memory(gen, monkeypatch, lanes):
    """dt = 1e-3 (its init's floor) and a = -1 and -16 over 6144 steps:
    states that remember ~1000 steps, where a biased exponential would
    drift by ~1e-4 of the rms.  Both modes against their plain versions
    within 1e-5 (the gated one in fp32)."""
    monkeypatch.setattr(scan_mod, "plan", lambda *_: lanes)
    b, t, d, n = 1, 6144, 256, 16
    a = torch.where(torch.arange(n, device="cuda") % 2 == 0, -1.0,
                    -16.0).expand(d, n).contiguous()
    bm, cm, x = _normal(gen, b, t, n), _normal(gen, b, t, n), _normal(
        gen, b, t, d)
    dskip = 1 + 0.3 * _normal(gen, d)
    dt = torch.full((b, t, d), 1e-3, device="cuda")
    y, s = selective_scan(dt, a, bm, cm, x, dskip)
    ey, es = selective_scan_plain(dt, a, bm, cm, x, dskip)
    assert _rms_err(y, ey) <= 1e-5 and _rms_err(s, es) <= 1e-5
    bias = torch.full((d,), math.log(math.expm1(1e-3)), device="cuda")
    g = (torch.zeros_like(x), bias, a, bm, cm, x,
         _normal(gen, b, t, 2 * d)[..., d:], dskip)
    go, gs = selective_scan_gated(*g)
    po, ps = selective_scan_gated_plain(*g)
    assert _rms_err(go, po) <= 1e-5 and _rms_err(gs, ps) <= 1e-5


@pytest.mark.parametrize("gated", [False, True])
def test_selective_scan_state_in_may_be_state_out(gen, gated):
    """The C entry with one buffer as the initial and the final state (a
    decode step's update in place): the same y and state as two
    buffers."""
    b, t, d, n = 2, 19, 384, 16
    if gated:
        raw, bias, a, bm, cm, x, z, dskip, st = _gated_case(
            gen, b, t, d, n, True, torch.bfloat16)
        y, s = selective_scan_gated(raw, bias, a, bm, cm, x, z, dskip, st)
    else:
        raw, a, bm, cm, x, dskip, st = _scan_case(gen, b, t, d, n, True)
        bias = z = None
        y, s = selective_scan(raw, a, bm, cm, x, dskip, st)
    inplace, y2 = st.clone(), torch.empty_like(y)
    lanes = scan_mod.plan(b, d, torch.cuda.get_device_properties(
        0).multi_processor_count)
    err = build.kernel("selective_scan")(
        raw.data_ptr(), None if bias is None else bias.data_ptr(),
        a.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
        None if z is None else z.data_ptr(), dskip.data_ptr(),
        inplace.data_ptr(), y2.data_ptr(), inplace.data_ptr(), None, b, t,
        d, n, lanes, 0 if z is None else z.stride(0),
        0 if z is None else z.stride(1), int(gated), int(gated),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(y2, y) and torch.equal(inplace, s)


def test_selective_scan_gated_repeated_launches_agree(gen):
    args = _gated_case(gen, 1, 2048, 16384, 16, True, torch.bfloat16)
    first = selective_scan_gated(*args)
    for i in range(50):
        again = selective_scan_gated(*args)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


@pytest.mark.parametrize("b,t,d,n,state", [
    (4, 2048, 16384, 16, False),   # jamba's training shape
    (1, 333, 384, 8, True)])
def test_selective_scan_bwd_repeated_launches_agree(gen, b, t, d, n, state):
    args = _scan_case(gen, b, t, d, n, state)
    _, _, ck = selective_scan_checkpoints(*args)
    dy = _normal(gen, b, t, d)
    ds = _normal(gen, b, d, n) if state else None
    first = selective_scan_bwd(*args[:6], ck, dy, ds)
    for i in range(50):
        again = selective_scan_bwd(*args[:6], ck, dy, ds)
        assert all(torch.equal(a, f) for a, f in zip(again, first)), i


#: (B, T, d_inner, with a state) of the scan backward's edges: one chunk
#: short of a full one in one block, a ragged tail over three blocks of
#: one batch row, exactly two chunks
BWD_EDGES = [(1, 5, 128, True), (1, 333, 384, True), (3, 16, 256, False)]


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("b,t,d,state", BWD_EDGES)
def test_selective_scan_bwd_edges(gen, n, b, t, d, state):
    """The backward at d_state 8 (a state a channel a lane) and 16 (two)
    at its edges, against the plain reverse recurrence, with the final
    state's gradient."""
    args = _scan_case(gen, b, t, d, n, state)
    _, _, ck = selective_scan_checkpoints(*args)
    dy, dstate = _normal(gen, b, t, d), _normal(gen, b, d, n) * 0.5
    got = selective_scan_bwd(*args[:6], ck, dy, dstate)
    exp = selective_scan_bwd_plain(*args, dy, dstate)
    for name, g, e in zip(("ddt", "da", "db", "dc", "dx", "dd_skip",
                           "dstate0"), got, exp):
        _grad_gate(g, e, f"{name}, d_state {n}")


@pytest.mark.parametrize("n", [8, 16])
def test_selective_scan_bwd_long_memory(gen, n):
    """The backward over 6144 steps at dt = 1e-3 with a = -1 and -16
    (gradients carried back ~1000 and ~60 steps), from a state and with
    the final state's gradient, against the plain reverse recurrence."""
    b, t, d = 1, 6144, 256
    a = torch.where(torch.arange(n, device="cuda") % 2 == 0, -1.0,
                    -16.0).expand(d, n).contiguous()
    dt = torch.full((b, t, d), 1e-3, device="cuda")
    args = (dt, a, _normal(gen, b, t, n), _normal(gen, b, t, n),
            _normal(gen, b, t, d), 1 + 0.3 * _normal(gen, d),
            _normal(gen, b, d, n))
    _, _, ck = selective_scan_checkpoints(*args)
    dy, dstate = _normal(gen, b, t, d), _normal(gen, b, d, n)
    got = selective_scan_bwd(*args[:6], ck, dy, dstate)
    exp = selective_scan_bwd_plain(*args, dy, dstate)
    for name, g, e in zip(("ddt", "da", "db", "dc", "dx", "dd_skip",
                           "dstate0"), got, exp):
        _grad_gate(g, e, f"{name}, d_state {n}")


@pytest.mark.parametrize("b,t,d,n", [(4, 2048, 16384, 16), (2, 333, 384, 8)])
def test_selective_scan_bwd_memory_is_its_scratch(gen, b, t, d, n):
    """The backward's device memory beyond its inputs and outputs: at
    most its stated scratch (``bwd_scratch_floats``) plus 1 MiB."""
    args = _scan_case(gen, b, t, d, n, False)
    _, _, ck = selective_scan_checkpoints(*args)
    dy = _normal(gen, b, t, d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = selective_scan_bwd(*args[:6], ck, dy)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - before
             - sum(g.numel() * g.element_size() for g in got))
    assert extra <= 4 * scan_mod.bwd_scratch_floats(b, t, d, n) + (1 << 20)


def test_mamba_kernels_refuse_what_they_are_not_built_for(gen):
    """d_state 4, d_inner 200 (no multiple of 128) and bf16 scan inputs
    raise on CUDA tensors, with no launch; a conv width 3 too."""
    before = selective_scan.launches, causal_conv1d.launches
    for n, d in ((4, 256), (16, 200)):
        with pytest.raises(ValueError):
            selective_scan(*_scan_case(gen, 1, 5, d, n, False))
    args = [v.to(torch.bfloat16) for v in _scan_case(gen, 1, 5, 128, 8,
                                                     False)[:6]]
    with pytest.raises(TypeError):
        selective_scan(*args)
    x, w, bias, _ = _conv_case(gen, 1, 5, 64, torch.float32, False)
    with pytest.raises(ValueError):
        causal_conv1d(x, w[:3], bias)
    # the gated mode: fp32 dt_raw beside bf16 x, a z view off 16 bytes,
    # d_state 12
    raw, dtb, a, bm, cm, x, z, dskip, st = _gated_case(
        gen, 1, 5, 128, 8, False, torch.bfloat16)
    with pytest.raises(TypeError):
        selective_scan_gated(raw.float(), dtb, a, bm, cm, x, z, dskip)
    xz = _normal(gen, 1, 5, 2 * 128 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        selective_scan_gated(raw, dtb, a, bm, cm, x, xz[..., 129:257],
                             dskip)
    g12 = _gated_case(gen, 1, 5, 128, 12, False, torch.bfloat16)
    with pytest.raises(ValueError):
        selective_scan_gated(*g12)
    assert before == (selective_scan.launches, causal_conv1d.launches)


def test_mamba_layer_on_the_card_equals_the_cpu(gen):
    """jamba's smoke Mamba layer (fp32) forward and backward through the
    four kernels against the same layer on the CPU (the plain versions
    under autograd): the output, both states and every gradient leaf."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import mamba
    cfg = smoke_config("jamba-1.5-large-398b")
    p = mamba.mamba_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         torch.float32, "cuda")
    p["conv_b"] = 0.1 * _normal(gen, *p["conv_b"].shape)
    p["d_skip"] = 1 + 0.3 * _normal(gen, *p["d_skip"].shape)
    x = _normal(gen, 2, 64, cfg.d_model)
    dy = _normal(gen, 2, 64, cfg.d_model)
    outs = {}
    counts = lambda: (causal_conv1d.launches, selective_scan.launches,  # noqa: E731
                      causal_conv1d_bwd.launches, selective_scan_bwd.launches)
    before = counts()
    for dev in ("cuda", "cpu"):
        leaves = {k: v.detach().to(dev).requires_grad_(True)
                  for k, v in p.items()}
        y, st = mamba.mamba_apply(leaves, cfg, x.to(dev))
        grads = torch.autograd.grad(y, list(leaves.values()), dy.to(dev))
        outs[dev] = [y, st.conv, st.ssm, *grads]
    assert counts() == tuple(c + 1 for c in before)
    for got, exp in zip(outs["cuda"], outs["cpu"]):
        _grad_gate(got.detach().cpu(), exp.detach(), "leaf")


def test_mamba_layer_serving_on_the_card_equals_the_cpu(gen):
    """The same layer with no input needing a gradient, a prefill then a
    decode step from its state: one conv and one gated scan launch each
    (no backward), the outputs and states against the CPU's plain
    chain."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import mamba
    cfg = smoke_config("jamba-1.5-large-398b")
    p = mamba.mamba_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         torch.float32, "cuda")
    p["conv_b"] = 0.1 * _normal(gen, *p["conv_b"].shape)
    p["d_skip"] = 1 + 0.3 * _normal(gen, *p["d_skip"].shape)
    x = _normal(gen, 2, 64, cfg.d_model)
    step = _normal(gen, 2, 1, cfg.d_model)
    outs = {}
    before = (causal_conv1d.launches, selective_scan.launches,
              selective_scan_bwd.launches)
    for dev in ("cuda", "cpu"):
        leaves = {k: v.to(dev) for k, v in p.items()}
        y, st = mamba.mamba_apply(leaves, cfg, x.to(dev))
        y1, st1 = mamba.mamba_apply(leaves, cfg, step.to(dev), st)
        outs[dev] = [y, st.conv, st.ssm, y1, st1.conv, st1.ssm]
    assert (causal_conv1d.launches, selective_scan.launches,
            selective_scan_bwd.launches) == (before[0] + 2, before[1] + 2,
                                             before[2])
    for got, exp in zip(outs["cuda"], outs["cpu"]):
        _grad_gate(got.cpu(), exp, "serving")


# ------------------- flash with per-row offsets (PR 30) -------------------

#: (b, hq, hkv, s, lmax, D or (D, Dv), offsets): chip_smoke.py's kernels
#: phase's shapes (gemma-2b's, deepseek-v2-lite's and jamba's continued
#: prefills of 4096 tokens over a cache of 6176, rows at 0, 1024, 1793 -
#: off every tile boundary - and 2048; a ragged one), then the other
#: head-dim instances, a cache far longer than kv_len with lengths ending
#: mid-tile, and a length past the cache (the clamp case's rows)
OFFSET_CASES = [
    (4, 8, 1, 4096, 6176, 256, (0, 1024, 1793, 2048)),
    (4, 16, 16, 4096, 6176, MLA, (0, 1024, 1793, 2048)),
    (4, 64, 8, 4096, 6176, 128, (0, 1024, 1793, 2048)),
    (2, 4, 2, 333, 1000, 64, (0, 667)),
    (2, 4, 2, 100, 4000, 32, (5, 130)),
    (3, 8, 1, 77, 300, 256, (0, 250, 299)),
]


def _offset_inputs(gen, b, hq, hkv, s, lmax, dim, dtype):
    dk, dv = dim if isinstance(dim, tuple) else (dim, dim)
    return (_normal(gen, b, hq, s, dk, dtype=dtype),
            _normal(gen, b, hkv, lmax, dk, dtype=dtype),
            _normal(gen, b, hkv, lmax, dv, dtype=dtype))


def _plain_offsets(q, k, v, q_offset, kv_len):
    """``attention_plain`` with offsets a (batch row, KV head) at a time:
    the whole call's fp32 logits would not fit the card at jamba's
    shape."""
    b, hq = q.shape[:2]
    hkv = k.shape[1]
    g = hq // hkv
    out = q.new_empty(q.shape[:3] + (v.shape[3],))
    for i in range(b):
        for h in range(hkv):
            out[i:i + 1, h * g:(h + 1) * g] = attention_plain(
                q[i:i + 1, h * g:(h + 1) * g], k[i:i + 1, h:h + 1],
                v[i:i + 1, h:h + 1], causal=True, q_offset=q_offset[i:i + 1],
                kv_len=kv_len[i:i + 1])
    return out


def _rows(offsets):
    return torch.tensor(offsets, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("b,hq,hkv,s,lmax,dim,offsets", OFFSET_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_offsets_equal_plain(gen, b, hq, hkv, s, lmax, dim,
                                             offsets, dtype):
    """One launch at per-row offsets, kv_len = offset + s, over a cache of
    random rows past kv_len too (masked, never seen): fp32 within 1e-5,
    bf16 within 1e-2 and the row gate."""
    q, k, v = _offset_inputs(gen, b, hq, hkv, s, lmax, dim, dtype)
    q_offset = _rows(offsets)
    kv_len = q_offset + s
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                          kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    exp = _plain_offsets(q, k, v, q_offset, kv_len)
    _close(got, exp, dtype, 1e-2)
    if dtype == torch.bfloat16:
        assert _bf16_row_err(got, exp) <= 1.0


@pytest.mark.parametrize("dim", [32, 64, 128, 256, MLA])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_offset_zero_rows_are_todays_call(gen, dim, dtype):
    """A row at offset 0 with kv_len = s over a longer cache sees the
    same key tiles in the same order as today's causal call over the
    first s keys: bit for bit equal (its masked keys enter as P = 0)."""
    s, lmax = 333, 1000
    q, k, v = _offset_inputs(gen, 2, 4, 2, s, lmax, dim, dtype)
    q_offset = torch.tensor([0, 400], dtype=torch.int32, device="cuda")
    got = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                          kv_len=q_offset + s)
    today = flash_attention(q[:1].contiguous(),
                            k[:1, :, :s].contiguous(),
                            v[:1, :, :s].contiguous(), causal=True)
    assert torch.equal(got[:1], today)


def test_flash_attention_offsets_repeated_launches_agree(gen):
    """gemma-2b's continued prefill in bf16, 50 more launches: each output
    equal to the first bit for bit (the ring's stages counted from the
    rows' own offsets by producer and consumers alike)."""
    b, hq, hkv, s, lmax, dim, offsets = OFFSET_CASES[0]
    q, k, v = _offset_inputs(gen, b, hq, hkv, s, lmax, dim, torch.bfloat16)
    q_offset = _rows(offsets)
    kv_len = q_offset + s
    first = flash_attention(q, k, v, q_offset=q_offset, kv_len=kv_len)
    for i in range(50):
        assert torch.equal(flash_attention(q, k, v, q_offset=q_offset,
                                           kv_len=kv_len), first), i


def test_flash_attention_offsets_refuse_what_the_kernel_does_not_take(gen):
    """Under grad with offsets: ``NotImplementedError`` (no backward
    kernel takes them); a malformed offset or length tensor, or Lq > Lk
    with offsets: ``ValueError``; nothing launched."""
    q, k, v = _offset_inputs(gen, 2, 4, 2, 64, 128, 64, torch.bfloat16)
    off = torch.tensor([0, 7], dtype=torch.int32, device="cuda")
    launches = flash_attention.launches
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        flash_attention(q.clone().requires_grad_(True), k, v, q_offset=off,
                        kv_len=off + 64)
    for bad in (off.long(), off[:1], torch.tensor([0, 1, 7, 8], device="cuda",
                                                  dtype=torch.int32)[::2]):
        with pytest.raises(ValueError):
            flash_attention(q, k, v, q_offset=bad)
        with pytest.raises(ValueError):
            flash_attention(q, k, v, kv_len=bad)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, q_offset=off.cpu())
    with pytest.raises(ValueError, match="Lq <= Lk"):
        flash_attention(q, k[:, :, :32].contiguous(),
                        v[:, :, :32].contiguous(), causal=False,
                        q_offset=off)
    assert flash_attention.launches == launches
