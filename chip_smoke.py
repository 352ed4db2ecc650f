#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. build   - compiles the six CUDA kernels from
             ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a into
             ``build/repro_torch_kernels/``, one nvcc per source, all at
             once; prints each entry's registers, shared memory and
             spills (none allowed in the entries of ``NO_SPILL``, the WKV
             scan and both ticks, or in the bf16 wgmma flash kernel at
             any head dim) and, where ``cuobjdump`` is
             installed, the tensor-core (HGMMA) instructions of its
             machine code (at least one).
2. kernels - holds each kernel against its plain PyTorch version on the
             card at a mid-size shape and at every shape the main paths
             give it: the coherence ticks exactly (int32); RMSNorm within
             one bf16 ulp (also on a view offset by one element, the
             kernel's element-by-element path, and at a qk-norm width);
             flash attention and flash decode within 1e-2 max-abs in bf16
             and 1e-5 in fp32 on unit-scale inputs, and in bf16 also
             element by element within one bf16 ulp of the plain value
             plus 2**-10 of its row's rms (flash decode at the batched
             request's shape on every kv_len its 32 steps give it, P + 1
             .. P + 32); bf16 flash attention, flash decode, the WKV
             scan (fp32 and bf16), the MESI tick (every shape and
             strategy) and the chunk tick (both shapes) launched
             ``REPEATS`` more times at each shape after every timing,
             each output equal to the first bit for bit.  The tick rows
             give ``staged_sims``, the simulations a block of the
             kernel's staged path runs (0: its direct path).
             The MESI rows add ``sector_bound_ms`` (the 32-byte sectors
             the tick must touch) beside the word bound, the WKV rows
             ``issue_floor_ms`` (four fp32 instructions per state element
             per step over the card's fp32 lanes at its highest SM
             clock), and four ``host_split_us`` lines split the host
             time of a ``mesi_tick_``, an ``rwkv6_scan`` and a
             ``chunk_tick_`` call and of a kernel-route ``decide`` of the
             service's content broker (prefix batch, MESI tick launch,
             chunk tick launch, read-back, bookkeeping).  The ticks are
             also held at the service's shapes: (33, 32, 6) and
             (49, 48, 6) for the MESI tick, (1, 32, 6, 64) for the chunk
             tick.  Times the
             wrapper call (CUDA events), the kernel alone, the wrapper's
             host time, the plain version and, for the model kernels, the
             one PyTorch call that computes the same function (a
             yardstick the port never calls), beside the bound.  The
             RWKV6 WKV scan at the rwkv serving path's shapes (the batched
             and the agents' 6144-step prefills, a decode step from a
             random state) and a ragged bf16 mid shape: the final state
             bit for bit, y in fp32 within 1e-5 of the rms of its head's
             output and in bf16 within one bf16 ulp plus 2**-10 of its
             row's rms; no PyTorch call computes the recurrence, so it has
             no library time.
3. scenarios - first the committed goldens on the threefry stream in
             legacy mode: ``tests/golden/scenarios.json`` exactly, then the
             zoo and content goldens with a count of the runs that differ
             (by family).  Then the paper's scenarios A-D (n=4, m=3,
             |d|=4096, S=40) with 4096 runs each: savings must clear the
             Token Coherence Theorem's bound and sit within 2.5 pp of the
             published table; the kernel and scan routes must agree on
             every statistic of the whole grid.
4. fleet   - the six-family workload zoo at n=16 agents, m=16 artifacts,
             4096 runs per family with 64-token chunks (24,576 episodes
             per variant): delta bytes never exceed whole-artifact bytes,
             and each kernel launches once per step; then eager and
             access_count at 1024 runs per family without content.
5. service - the live coherence service on the card: the JAX package's
             service bench grid (32 clients, 6 artifacts of 4096 tokens,
             40 lockstep rounds, lazy) for each of the seven families
             (``uniform`` = zipf with skew 0 at V = 0.10) through brokers
             on both decision routes, with and without 64-token chunks,
             plus eager and access_count (k = 3) on ``bursty`` (kernel
             route) and K = 3 staleness on ``uniform`` (scan route).
             Every broker's trace passes the port's oracle
             (``verify_broker``, its kernel legs on the card; the K = 3
             broker, outside the oracle's scope, its live invariant
             checks) and the metrics conformance replay; the two routes
             decide alike step for step (with content, the chunks each
             fill shipped too); the kernel route launches exactly one
             MESI tick (with content one chunk tick) per micro-batch;
             the uniform kernel-route broker run on the CPU decides
             exactly as on the card.  Prints each broker's throughput,
             capacity, request and decide latency, micro-batches,
             savings against broadcast and warm-up seconds, then a
             profile of the uniform kernel-route brokers (the device's
             busy share, the host's time by function).
6. serve   - coherent serving on gemma-2b at its registered width (18
             layers, d 2048, MQA, head dim 256, vocab 256000, bf16) with
             random weights from ``SEED``: 4 agents, 3 artifacts of 2048
             tokens, 40 steps at V = 0.10, lazy; every agent's context
             prefilled (cache 8192), then one batched request (the
             contexts cut to their common length P, prefilled at B = 4
             into a cache of P + 32, then 32 greedy decode steps).  Checks
             finite logits, the launch counts (37 rmsnorm per forward, 18
             flash_attention per prefill, 18 decode_attention per step)
             and the same request on the plain versions: relative L2 error
             of the prefill's last-position logits <= 2e-2 and of every
             decode step's <= 2.5e-2; then the prompt through the layers
             one at a time on both routes, each layer's own share of
             their distance <= 1e-2.  Profiles one batched prefill
             (top device operations, flash attention's share) and eight
             decode steps.
7. serve_rwkv - the same serving workload on rwkv6-1.6b at its
             registered width (24 layers, d 2048, 32 heads of 64,
             channel-mix 7168, vocab 65536, bf16) with random weights from
             ``SEED``: finite logits, exactly 73 rmsnorm and 24 rwkv6_scan
             launches per forward and no attention launch; the plain route
             within relative L2 4.5e-2 (prefill) and 5e-2 (every decode
             step), set from the per-layer readings in PERF.md, and each
             layer's own share <= 1e-2.
8. the ``kernels`` line, the card's name and power limit, and the final
   ``{"ok": true, ...}`` line.

Phases 3-4 (the sweep engine), 5 (the service), 6 and 7 (serving) are
the main paths; each path's kernels' launch counts are set to 0 just
before it and read just after.  Any failed check raises, and the script
then exits non-zero.  Without a CUDA device, or without the
repository's ``src/`` beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SEED = 20260305

#: paper Table 1 savings (lazy vs broadcast, SS8.2)
PUBLISHED = {"A": 0.950, "B": 0.923, "C": 0.883, "D": 0.842}
PUBLISHED_TOLERANCE = 0.025

#: device-memory rate by H100 variant, bytes/s, from NVIDIA's data sheets.
H100_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
#: dense bf16 tensor-core rate by H100 variant, flop/s (data sheets)
H100_BF16_FLOPS = {"PCIe": 756e12, "NVL": 835e12, "SXM": 989e12}
#: fp32 rate of the CUDA cores (outside the tensor cores) by H100
#: variant, flop/s (data sheets)
H100_FP32_FLOPS = {"PCIe": 51e12, "NVL": 60e12, "SXM": 67e12}

#: mid-size, then every shape the main paths give the kernel: the four
#: scenarios' batch, the eager/access_count fleets, the service's
#: decisions (B = n + 1 prefix simulations: n = 32 clients, the staged
#: path's top, and n = 48, the direct path; for the chunk tick one
#: simulation), the content fleet (last: the ``kernels`` line reports
#: this one)
MESI_SHAPES = ((8192, 16, 16), (16384, 4, 3), (6144, 16, 16),
               (33, 32, 6), (49, 48, 6), (24576, 16, 16))
CHUNK_SHAPES = ((4096, 16, 16, 64), (1, 32, 6, 64), (24576, 16, 16, 64))
FLEET_RUNS = 4096
#: runs per family of the eager / access_count fleets, per scenario of
#: the A-D grid
STRATEGY_FLEET_RUNS = 1024
SCENARIO_RUNS = 4096
#: GPU clock cycles a spin kernel holds the stream for (about 5 ms at
#: 1980 MHz): it must outlast the wrapper's host work, and on a busy host
#: ``mesi_tick``'s wrapper can take more than 1 ms
SPIN_CYCLES = 10_000_000
#: launches of bf16 flash attention, flash decode, the WKV scan and the
#: MESI tick at each checked shape that must equal the first bit for bit
#: (flash's K/V ring is shared by two warpgroups, so a stage overwritten
#: too early shows in some launches and not others; decode merges its
#: splits behind tickets that must return to 0 after every launch, in
#: split order whichever block finishes last; the scan's stage ring and
#: the tick's staged slabs are reused the same way)
REPEATS = 50
#: kernels none of whose entries may spill registers (the build phase)
NO_SPILL = ("rwkv6_scan", "mesi_tick", "chunk_tick")
#: fp32 lanes of an SM on Hopper (the issue floor of the WKV scan)
FP32_LANES_PER_SM = 128
#: host-time samples of each piece of a wrapper call (``host_split``)
HOST_SPLIT_CALLS = 50
#: a qk-norm width (the per-head norm of q and k at head dim 128)
QK_NORM_WIDTH = 128
REPLACES = {
    "mesi_tick": ("src/repro_torch/kernels/csrc/mesi_tick.cu",
                  "src/repro/kernels/mesi_transition.py:151"),
    "chunk_tick": ("src/repro_torch/kernels/csrc/chunk_tick.cu",
                   "src/repro/kernels/chunk_diff.py:131"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:29"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:71"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:63"),
}
#: the service cell of phase 5: the JAX package's service bench grid
#: (``benchmarks/service_bench.py``): 32 clients, 6 artifacts of 4096
#: tokens, 40 lockstep rounds, lazy; the content plane's brokers cut the
#: artifacts into 64-token chunks
SERVICE = dict(clients=32, artifacts=6, artifact_tokens=4096, rounds=40,
               strategy="lazy", chunk_tokens=64)
#: the service's workload families and their seeds (the bench's)
SERVICE_FAMILIES = ("uniform", "bursty", "zipf", "hierarchical", "rag",
                    "pipeline", "ping_pong")
SERVICE_SEEDS = {f: 20260701 + i for i, f in enumerate(SERVICE_FAMILIES)}
#: the serving workload of phase 6
SERVE = dict(arch="gemma-2b", agents=4, artifacts=3, artifact_tokens=2048,
             steps=40, volatility=0.10, strategy="lazy", max_len=8192,
             decode_steps=32)
#: the serving workload of phase 7: the same on rwkv6-1.6b
SERVE_RWKV = dict(SERVE, arch="rwkv6-1.6b")
#: tolerances of the model kernels against their plain versions (max-abs)
ATTN_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
#: bf16 attention is also held element by element to one bf16 ulp of the
#: plain value plus this share of the rms of its row: both round nearly the
#: same fp32 result, so they differ in the last bit at most, while a key
#: block lost or masked wrongly moves a row by about a tenth of its rms
#: (unit-normal inputs at L = 6144 give rows of rms ~0.02, so the max-abs
#: limit alone would not see it)
ROW_RMS_FLOOR = 2.0 ** -10
#: fp32 WKV outputs are held to this share of the rms of their head's
#: output over the sequence (not of their row's: early rows are sums that
#: cancel, and there even the plain version lies ~1e-4 of the row's rms
#: from the same sum in fp64)
WKV_FP32_TOL = 1e-5
#: relative L2 error allowed between the kernel and plain routes' logits,
#: by arch: (the prefill's last position, every decode step's), set from
#: the H100 readings recorded in PERF.md: gemma-2b 0.0167 and at most
#: 0.0191; rwkv6-1.6b 0.0378 and at most 0.0399, where the per-layer
#: readings show no layer parting the routes (each adds at most 0.0037)
LOGITS_REL_L2 = {"gemma-2b": (2e-2, 2.5e-2), "rwkv6-1.6b": (4.5e-2, 5e-2)}
#: relative L2 error allowed for one layer's own share of the routes'
#: distance (``layer_divergence``'s ``local``; readings at most 0.0015 on
#: gemma-2b and 0.0037 on rwkv6-1.6b)
LAYER_REL_L2 = 1e-2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def _variant_rate(name: str, table: dict, what: str) -> float:
    if "H100" not in name:
        raise RuntimeError(f"no {what} on record for {name!r}")
    for variant, rate in table.items():
        if variant in name:
            return rate
    return table["SXM"]   # "H100 80GB HBM3" is the SXM part


def memory_rate(name: str) -> float:
    return _variant_rate(name, H100_BYTES_PER_S, "memory rate")


def bf16_rate(name: str) -> float:
    return _variant_rate(name, H100_BF16_FLOPS, "bf16 rate")


def fp32_rate(name: str) -> float:
    return _variant_rate(name, H100_FP32_FLOPS, "fp32 rate")


def median_ms(fn, make_args, reps: int) -> float:
    """Median device time of ``fn(*make_args())`` over ``reps`` calls,
    each on freshly made arguments (made outside the timed window), by
    CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        args = make_args()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, make_args, reps: int) -> tuple:
    """Median device time of ``fn(*make_args())`` alone over ``reps``
    calls, and the host time of one call (the wrapper's work until its
    launches are queued): a spin kernel queued first holds the stream
    while the host runs the wrapper, so the CUDA events bracket the
    kernel's device work and none of the host's.  The host time is the
    mean over ``reps`` calls queued back to back behind one spin, as a
    decode step queues them.  Checks that each spin outlasted the host's
    work."""
    import torch
    times = []
    for _ in range(reps):
        args = make_args()
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        start.record()
        fn(*args)
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        check(held.elapsed_time(start) > queued_ms,
              "the spin kernel outlasted the wrapper's host work")
        times.append(start.elapsed_time(end))
    calls = [make_args() for _ in range(reps)]
    held, released = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    held.record()
    torch.cuda._sleep(SPIN_CYCLES * reps)
    released.record()
    t0 = time.perf_counter()
    for args in calls:
        fn(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    released.synchronize()
    check(held.elapsed_time(released) > host_ms,
          "the spin kernel outlasted the wrappers' host work")
    torch.cuda.synchronize()
    return statistics.median(times), host_ms / reps


def check_repeats(card: str, cases) -> None:
    """Each ``(kernel, label, call, first)`` case launched ``REPEATS``
    times more; every output (a tensor or a sequence of them) must equal
    the first bit for bit."""
    import torch

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for kernel, label, call, first in cases:
        equal = sum(same(call(), first) for _ in range(REPEATS))
        check(equal == REPEATS, f"{kernel} ({label}): {equal} of {REPEATS} "
              f"repeated launches equal the first")
        emit({"phase": "kernels", "kernel": kernel, "case": label,
              "repeats": REPEATS, "repeats_equal": equal, "card": card})


def changed_words(before, after) -> int:
    return sum(int((b != a).sum()) for b, a in zip(before, after))


def mesi_bound_bytes(inputs, outputs) -> tuple:
    """Least bytes one MESI tick moves on these inputs, as words and as
    the 32-byte sectors the card moves: the action vectors read in full;
    the state words the decisions read (the addressed cell of every
    acting agent, the whole column of every written artifact, the
    version of every addressed artifact, the read counters of acting
    agents where the tick reads them); miss and counters written in
    full; every state word whose value changed written once.  Returns
    (4 bytes a word, 32 bytes a sector holding any such word, read and
    written sectors counted apart)."""
    import torch
    state, version, sync, reads, acts, arts, writes = inputs
    B, n, m = state.shape
    idx = arts.long()
    act = acts != 0
    cell = torch.zeros((B, n, m), dtype=torch.bool, device=state.device)
    cell.scatter_(2, idx[..., None], act[..., None])
    written = torch.zeros((B, m), dtype=torch.int32, device=state.device)
    written.scatter_add_(1, idx, (act & (writes != 0)).to(torch.int32))
    addressed = torch.zeros((B, m), dtype=torch.int32, device=state.device)
    addressed.scatter_add_(1, idx, act.to(torch.int32))
    state_read = cell | (written > 0)[:, None, :]
    changed = [b != a for b, a in zip(inputs[:4], outputs[:4])]
    words = (3 * B * n + int(state_read.sum()) + int((addressed > 0).sum())
             + int(cell.sum()) + B * n + B * 8 + sum(int(c.sum())
                                                    for c in changed))

    def sectors(mask):    # 8 words a sector; every buffer starts on one
        flat = mask.reshape(-1)
        pad = (-flat.numel()) % 8
        flat = torch.cat([flat, flat.new_zeros(pad)])
        return int(flat.view(-1, 8).any(dim=1).sum())

    full = 3 * -(-B * n // 8) + -(-B * n // 8) + -(-B * 8 // 8)
    touched = (full + sectors(state_read) + sectors(addressed > 0)
               + sectors(cell) + sum(sectors(c) for c in changed))
    return 4 * words, 32 * touched


def chunk_bound_bytes(inputs, outputs) -> int:
    """Least bytes one chunk tick moves on these inputs: miss, write
    flags and artifact choices read in full; the authority chunk row of
    every artifact an agent fills or writes, the reader row of every
    fill and the span of every write read once; fetched and counters
    written in full; every chunk word whose value changed written
    once."""
    import torch
    cv, cs, dirty, miss, wact, arts, wmask = inputs
    B, n, m, C = cs.shape
    idx = arts.long()
    busy = ((miss != 0) | (wact != 0)).to(torch.int32)
    rows = torch.zeros((B, m), dtype=torch.int32, device=cs.device)
    rows.scatter_add_(1, idx, busy)
    words = (3 * B * n + C * (int((rows > 0).sum())
                              + int((miss != 0).sum())
                              + int((wact != 0).sum()))
             + B * n * C + B * 4
             + changed_words(inputs[:3], outputs[:3]))
    return 4 * words


def ptxas_entries(log: str) -> dict:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log (``name<D>`` for a
    template on the head dim): registers, static shared memory, stack
    frame and spill bytes."""
    entries, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"\d(flash_[a-z0-9]+)ILi(\d+)E", m.group(1))
            name = f"{t.group(1)}<{t.group(2)}>" if t else m.group(1)
            entries[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            entries[name].update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            entries[name].update(registers=int(m.group(1)),
                                 static_smem=int(smem.group(1)) if smem
                                 else 0)
    return entries


def phase_build(card: str) -> None:
    """Builds every kernel (each one anew, so its compiler output is at
    hand); prints each entry's registers, shared memory and spills, which
    must be none in the entries of the kernels of ``NO_SPILL`` and in the
    bf16 flash kernel at every head dim, and, where ``cuobjdump`` is
    installed, the count of tensor-core (``HGMMA``) instructions in
    flash's machine code, which must not be 0."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    for name in build.KERNELS:
        build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    logs = build.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    check(all(build.library_path(name).exists() for name in build.KERNELS),
          "every kernel library is built")
    usage = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()
             if name not in ("flash_attention",) + NO_SPILL}
    emit({"phase": "build", "seconds": seconds, "arch": "sm_90a",
          "kernels": len(build.KERNELS), "compiled": sorted(logs),
          "ptxas": usage, "card": card})

    for name in NO_SPILL:
        rows = ptxas_entries(logs[name])
        check(bool(rows) and all(
            row.get("spill_stores") == 0 == row.get("spill_loads")
            and row.get("stack") == 0 for row in rows.values()),
            f"{name} compiled without register spills ({rows})")
        emit({"phase": "build", "kernel": name, "entries": rows,
              "card": card})

    lib_path = build.library_path("flash_attention")
    entries = ptxas_entries(logs["flash_attention"])
    for d in HEAD_DIMS:
        row = entries.get(f"flash_wgmma<{d}>", {})
        check(row.get("spill_stores") == 0 == row.get("spill_loads")
              and row.get("stack") == 0,
              f"flash_wgmma<{d}> compiled without register spills ({row})")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    hgmma = None
    if pathlib.Path(tool).exists():
        sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                              capture_output=True, text=True).stdout
        hgmma = dict(collections.Counter(re.findall(r"HGMMA\.\w+\.\w+\.\w+",
                                                    sass)))
        check(sum(hgmma.values()) > 0,
              "flash_attention's machine code holds HGMMA instructions")
    emit({"phase": "build", "kernel": "flash_attention", "entries": entries,
          "hgmma": hgmma, "card": card})


def random_mesi_inputs(gen, B: int, n: int, m: int):
    """Random valid directories (every entry I or S, synced to the
    current version where valid) and random actions."""
    import torch
    dev, i32 = gen.device, torch.int32

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=i32)

    state = ints(0, 2, B, n, m)
    version = ints(1, 6, B, m)
    sync = torch.where(state > 0, version[:, None, :], 0).to(i32)
    reads = ints(0, 12, B, n, m)
    return (state, version, sync, reads, ints(0, 2, B, n), ints(0, m, B, n),
            ints(0, 2, B, n))


def random_chunk_inputs(gen, B: int, n: int, m: int, C: int):
    """One chunk tick's inputs in 64-token chunks: ``miss`` from a MESI
    tick on random directories, chunk vectors lagging the authority by 0
    or 1, write spans drawn as the engine draws them (locality 0.25);
    returns ``(inputs, opts)``."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.acs import draw_write_chunks
    from repro_torch.kernels import mesi_transition as mt
    tokens, chunk = C * 64, 64
    acts, arts, writes = random_mesi_inputs(gen, B, n, m)[4:]
    mesi_in = random_mesi_inputs(gen, B, n, m)[:4] + (acts, arts, writes)
    miss = mt.mesi_tick(*mesi_in, artifact_tokens=tokens)[5]
    cv = torch.randint(1, 5, (B, m, C), generator=gen, device="cuda",
                       dtype=torch.int32)
    lag = torch.randint(0, 2, (B, n, m, C), generator=gen, device="cuda",
                        dtype=torch.int32)
    cs = torch.clamp(cv[:, None] - lag, min=0)
    dirty = (cv > 1).to(torch.int32)
    keys = prng.split(prng.prng_key(SEED, "cuda"), B)
    wmask = draw_write_chunks(keys, n, C, 0.25).to(torch.int32)
    inputs = (cv, cs, dirty, miss, (acts * writes).contiguous(), arts, wmask)
    return inputs, dict(artifact_tokens=tokens, chunk_tokens=chunk,
                        signal_tokens=12)


def phase_kernels(card: str, rate: float) -> dict:
    """Kernel against plain version on the card; returns, per kernel,
    the measurements at the fleet shape (the last shape listed)."""
    import torch
    from repro_torch.core import invariants
    from repro_torch.kernels import chunk_diff, mesi_transition as mt

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    repeat_cases = []
    for B, n, m in MESI_SHAPES:
        for label, eager, access_k in (("lazy", False, 0),
                                       ("eager", True, 0),
                                       ("access_count", False, 8)):
            inputs = random_mesi_inputs(gen, B, n, m)
            opts = dict(artifact_tokens=4096, eager=eager,
                        access_k=access_k, signal_tokens=12)
            out = mt.mesi_tick(*inputs, **opts)
            torch.cuda.synchronize()
            plain = [t.clone() for t in inputs[:4]]
            plain += list(mt.mesi_tick_plain_(*plain, *inputs[4:], **opts))
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(out, plain))
            check(all(torch.equal(a, b) for a, b in zip(out, plain)),
                  f"mesi_tick kernel == plain ({label}, B={B})")
            st = out[0].cpu().numpy()
            check(invariants.single_writer(
                st.transpose(1, 0, 2).reshape(n, B * m)),
                "SWMR after the kernel tick")
            check(invariants.monotonic_version(inputs[1].cpu().numpy(),
                                               out[1].cpu().numpy()),
                  "monotonic versions after the kernel tick")

            def fresh():
                return [t.clone() for t in inputs[:4]] + list(inputs[4:])

            ms = median_ms(lambda *a: mt.mesi_tick_(*a, **opts), fresh, 10)
            dev_ms, host_ms = device_ms(
                lambda *a: mt.mesi_tick_(*a, **opts), fresh, 10)
            plain_ms = median_ms(lambda *a: mt.mesi_tick_plain_(*a, **opts),
                                 fresh, 3)
            word_bytes, sector_bytes = mesi_bound_bytes(inputs, out)
            row = {"phase": "kernels", "kernel": "mesi_tick",
                   "strategy": label, "shape": [B, n, m],
                   "equal": True, "max_abs_err": err, "ms": ms,
                   "device_ms": dev_ms, "host_ms": host_ms,
                   "plain_ms": plain_ms,
                   "bound_ms": word_bytes / rate * 1e3,
                   "sector_bound_ms": sector_bytes / rate * 1e3,
                   "staged_sims": mt.plan(n, m), "card": card}
            emit(row)
            if label == "lazy":
                results["mesi_tick"] = row

            def again(inputs=inputs, opts=opts):
                state = [t.clone() for t in inputs[:4]]
                return state + list(mt.mesi_tick_(*state, *inputs[4:],
                                                  **opts))
            repeat_cases.append(("mesi_tick", f"{label}, B={B}", again, out))
    # each shape and strategy launched again after every timing
    check_repeats(card, repeat_cases)

    repeat_cases = []
    for B, n, m, C in CHUNK_SHAPES:
        inputs, opts = random_chunk_inputs(gen, B, n, m, C)
        miss = inputs[3]
        out = chunk_diff.chunk_tick(*inputs, **opts)
        torch.cuda.synchronize()
        plain = [t.clone() for t in inputs[:3]]
        plain += list(chunk_diff.chunk_tick_plain_(*plain, *inputs[3:],
                                                   **opts))
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(out, plain))
        check(all(torch.equal(a, b) for a, b in zip(out, plain)),
              f"chunk_tick kernel == plain (B={B})")
        check(int(miss.sum()) > 0 and int(out[3].sum()) > 0,
              "the chunk tick fetched chunks")

        def fresh():
            return [t.clone() for t in inputs[:3]] + list(inputs[3:])

        ms = median_ms(lambda *a: chunk_diff.chunk_tick_(*a, **opts),
                       fresh, 10)
        dev_ms, host_ms = device_ms(
            lambda *a: chunk_diff.chunk_tick_(*a, **opts), fresh, 10)
        plain_ms = median_ms(lambda *a: chunk_diff.chunk_tick_plain_(
            *a, **opts), fresh, 3)
        bound_ms = chunk_bound_bytes(inputs, out) / rate * 1e3
        row = {"phase": "kernels", "kernel": "chunk_tick",
               "shape": [B, n, m, C], "equal": True, "max_abs_err": err,
               "ms": ms, "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "staged_sims": chunk_diff.plan(n, m, C), "card": card}
        emit(row)
        results["chunk_tick"] = row

        def again(inputs=inputs, opts=opts):
            state = [t.clone() for t in inputs[:3]]
            return state + list(chunk_diff.chunk_tick_(*state, *inputs[3:],
                                                       **opts))
        repeat_cases.append(("chunk_tick", f"B={B}, C={C}", again, out))
    # each shape launched again after every timing
    check_repeats(card, repeat_cases)
    return results


def serving_system(serve=SERVE):
    """A serving workload (phase 5's by default), driven through its
    coherence decisions (no model yet): the system and its stats."""
    from repro_torch.configs import ARCHS, get, n_active_params
    from repro_torch.launch.serve import build_artifacts
    from repro_torch.runtime.coherent_serving import (CoherentServingSystem,
                                                      run_workload)
    system = CoherentServingSystem(
        get(serve["arch"]), serve["agents"],
        build_artifacts(serve["artifacts"], serve["artifact_tokens"]),
        strategy=serve["strategy"],
        n_active_params=n_active_params(ARCHS[serve["arch"]]))
    stats = run_workload(system, serve["steps"], serve["volatility"])
    return system, stats


def bf16_ulps(got, exp) -> float:
    """Largest difference of ``got`` from ``exp`` in units of the bf16
    ulp of ``exp`` (x = m * 2**e, m in [0.5, 1), has ulp 2**(e - 8))."""
    import torch
    exp32 = exp.float()
    ulp = torch.ldexp(torch.ones_like(exp32), torch.frexp(exp32).exponent
                      - 8)
    return float(((got.float() - exp32).abs() / ulp).max())


def bf16_row_err(got, exp) -> float:
    """Largest ``|got - exp|`` over its allowance: one bf16 ulp of ``exp``
    plus ``ROW_RMS_FLOOR`` times the rms of ``exp``'s row (last axis).
    At most 1 when the two round nearly equal fp32 results."""
    import torch
    exp32 = exp.float()
    ulp = torch.where(exp32 == 0, 0.0, torch.ldexp(
        torch.ones_like(exp32), torch.frexp(exp32).exponent - 8))
    rms = exp32.square().mean(dim=-1, keepdim=True).sqrt()
    return float(((got.float() - exp32).abs()
                  / (ulp + ROW_RMS_FLOOR * rms)).max())


def check_attention(got, exp, dtype, what: str) -> tuple:
    """Holds an attention kernel's output to its plain version: max-abs
    within ``ATTN_TOL`` and, in bf16, :func:`bf16_row_err` <= 1.
    Returns (max-abs error, row error or None)."""
    err = float((got.float() - exp.float()).abs().max())
    tol = ATTN_TOL[str(dtype).split(".")[-1]]
    check(err <= tol, f"{what} within {tol} max-abs ({err})")
    row_err = None
    if str(dtype).endswith("bfloat16"):
        row_err = bf16_row_err(got, exp)
        check(row_err <= 1.0, f"{what} within one bf16 ulp plus "
              f"{ROW_RMS_FLOOR} of the row rms ({row_err})")
    return err, row_err


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """Query-key pairs a causal (rows aligned to the last lq keys) or
    full attention computes for one (batch, head)."""
    if not causal:
        return lq * lk
    off = lk - lq
    return sum(min(lk, r + off + 1) for r in range(lq))


def phase_model_kernels(card: str, rate: float, flops: float,
                        fp32_flops: float, contexts: list) -> dict:
    """The four model kernels against their plain versions at the
    serving paths' shapes (gemma-2b and rwkv6-1.6b: the agents'
    prefills, the batched prefill and decode) and at a mid shape;
    returns, per kernel, the row of the batched request's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import (attention_plain,
                                         decode_attention_plain,
                                         rmsnorm_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm

    cfg = get(SERVE["arch"])
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.kv_head_dim())
    P = min(contexts)
    L1 = min(max(contexts), SERVE["max_len"])
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def size(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    results = {}
    # --- rmsnorm: the batched prefill's rows, one agent's, decode's, a
    # view offset by one element (the kernel's element-by-element path),
    # a qk-norm width (a row per token and head), mid fp32
    for label, rows, width, dtype, offset in (
            ("batched prefill", SERVE["agents"] * P, d, bf16, 0),
            ("agent prefill", L1, d, bf16, 0),
            ("decode", SERVE["agents"], d, bf16, 0),
            ("scalar path", 4096, d, bf16, 1),
            ("qk-norm", SERVE["agents"] * P * hq, QK_NORM_WIDTH, bf16, 0),
            ("mid fp32", 4096, d, torch.float32, 0)):
        x = normal(rows * width + offset, dtype=dtype)[offset:].view(rows,
                                                                    width)
        w = normal(width, dtype=dtype)
        out = rmsnorm(x, w)
        torch.cuda.synchronize()
        exp = rmsnorm_plain(x, w)
        err = float((out.float() - exp.float()).abs().max())
        if dtype == bf16:
            ulps = bf16_ulps(out, exp)
            check(ulps <= 1.0, f"rmsnorm within one bf16 ulp ({label})")
        else:
            ulps = None
            check(err <= 1e-5 * max(1.0, float(exp.abs().max())),
                  f"rmsnorm fp32 within 1e-5 ({label})")
        args = lambda: (x, w)   # noqa: E731
        dev_ms, host_ms = device_ms(rmsnorm, args, 10)
        row = {"phase": "kernels", "kernel": "rmsnorm", "case": label,
               "shape": [rows, width], "offset": offset,
               "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err, "max_bf16_ulps": ulps,
               "ms": median_ms(rmsnorm, args, 10),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(rmsnorm_plain, args, 3),
               "library_ms": median_ms(
                   lambda a, b: F.rms_norm(a, (width,), b, 1e-6), args, 10),
               "bound_ms": size(x, w, out) / rate * 1e3,
               "bound_by": "bytes", "card": card}
        emit(row)
        if label == "batched prefill":
            results["rmsnorm"] = row

    # --- flash attention: the batched prefill, one agent's, a mid shape
    repeat_cases = []
    for label, b, h, g, lq, dim, dtype in (
            ("batched prefill", SERVE["agents"], hq, hkv, P, hd, bf16),
            ("agent prefill", 1, hq, hkv, L1, hd, bf16),
            ("mid bf16", 2, 16, 8, 2048, 128, bf16),
            ("mid fp32", 1, 8, 2, 1000, 64, torch.float32)):
        q = normal(b, h, lq, dim, dtype=dtype)
        k, v = (normal(b, g, lq, dim, dtype=dtype) for _ in range(2))
        out = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, row_err = check_attention(out, attention_plain(q, k, v), dtype,
                                       f"flash_attention ({label})")
        args = lambda: (q, k, v)   # noqa: E731
        work = 4 * b * h * dim * attention_pairs(lq, lq, True)
        bound = max(size(q, k, v, out) / rate, work / flops) * 1e3
        dev_ms, host_ms = device_ms(flash_attention, args, 5)
        row = {"phase": "kernels", "kernel": "flash_attention",
               "case": label, "shape": [b, h, g, lq, dim],
               "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
               "max_row_err": row_err,
               "ms": median_ms(flash_attention, args, 5),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(attention_plain, args, 3),
               "library_ms": median_ms(
                   lambda a, b_, c: F.scaled_dot_product_attention(
                       a, b_, c, is_causal=True, enable_gqa=True), args, 5),
               "bound_ms": bound, "bound_by": "operations", "card": card}
        row["tflops"] = work / (row["device_ms"] * 1e-3) / 1e12
        emit(row)
        if dtype == bf16:
            repeat_cases.append(("flash_attention", label,
                                 functools.partial(flash_attention, q, k, v,
                                                   causal=True), out))
        if label == "batched prefill":
            results["flash_attention"] = row

    # --- decode: the batched request's steps (kv_len P + 1 .. P + 32 over
    # a cache of P + 32, as the path gives them), a ragged mid shape
    steps = SERVE["decode_steps"]
    for label, b, h, g, L, dim, dtype, ragged in (
            ("batched decode", SERVE["agents"], hq, hkv, P + steps, hd, bf16,
             False),
            ("mid bf16", 8, 16, 8, 2048, 128, bf16, True),
            ("mid fp32", 4, 8, 2, 777, 64, torch.float32, True)):
        q = normal(b, h, dim, dtype=dtype)
        kc, vc = (normal(b, g, L, dim, dtype=dtype) for _ in range(2))
        cases = ([torch.randint(1, L + 1, (b,), generator=gen, device="cuda",
                                dtype=torch.int32)] if ragged else
                 [torch.full((b,), P + t, dtype=torch.int32, device="cuda")
                  for t in range(1, steps + 1)])
        err, row_err = 0.0, None
        for lens in cases:
            out = decode_attention(q, kc, vc, lens)
            torch.cuda.synchronize()
            e, r = check_attention(
                out, decode_attention_plain(q, kc, vc, lens), dtype,
                f"decode_attention ({label}, kv_len {lens.tolist()})")
            err = max(err, e)
            row_err = r if row_err is None else max(row_err, r)
        args = lambda: (q, kc, vc, lens)   # noqa: E731
        mask = (torch.arange(L, device="cuda")[None, None, None, :]
                < lens[:, None, None, None])
        valid = int(lens.sum())
        moved = (2 * valid * g * dim * kc.element_size() + size(q, out)
                 + lens.numel() * 4)
        dev_ms, host_ms = device_ms(decode_attention, args, 10)
        row = {"phase": "kernels", "kernel": "decode_attention",
               "case": label, "shape": [b, h, g, L, dim],
               "dtype": str(dtype).split(".")[-1], "kv_lens_checked":
               len(cases), "max_abs_err": err, "max_row_err": row_err,
               "ms": median_ms(decode_attention, args, 10),
               "device_ms": dev_ms, "host_ms": host_ms,
               "plain_ms": median_ms(decode_attention_plain, args, 3),
               "library_ms": median_ms(
                   lambda a, b_, c, n: F.scaled_dot_product_attention(
                       a[:, :, None], b_, c, attn_mask=mask,
                       enable_gqa=True), args, 10),
               "bound_ms": max(moved / rate, 4 * h * dim * valid / flops)
               * 1e3, "bound_by": "bytes", "card": card}
        emit(row)
        if dtype == bf16:
            repeat_cases.append(("decode_attention", label, functools.partial(
                decode_attention, q, kc, vc, lens), out))
        if label == "batched decode":
            results["decode_attention"] = row
    results["rwkv6_scan"], wkv_repeats = check_rwkv6_scan(
        card, rate, fp32_flops, gen, P, L1)
    host_split(card)

    # bf16 flash attention, flash decode and the WKV scan launched again
    # at each shape, after every timing (a burst of launches slows the
    # kernel timed right after it), each output equal to the first of the
    # same inputs
    check_repeats(card, repeat_cases + wkv_repeats)
    return results


def host_us(fn) -> float:
    """Mean host time of ``fn()`` over ``HOST_SPLIT_CALLS`` calls back to
    back behind one spin kernel, in microseconds."""
    import torch
    torch.cuda.synchronize()
    held, released = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
    held.record()
    torch.cuda._sleep(SPIN_CYCLES * 4)
    released.record()
    t0 = time.perf_counter()
    for _ in range(HOST_SPLIT_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_SPLIT_CALLS * 1e6
    released.synchronize()
    check(held.elapsed_time(released) * 1e3 > us * HOST_SPLIT_CALLS,
          "the spin kernel outlasted the host work")
    torch.cuda.synchronize()
    return us


def chunk_host_split(card: str) -> None:
    """How the host time of a ``chunk_tick_`` call at the content fleet's
    shape splits: the whole call, then the routing rule, the checks, the
    two output allocations and ``backend.launch`` with the pointers
    ready, each on its own (``host_us``).  It reads only names the
    package has had since the kernel was first ported, so it times an
    earlier tree's wrapper as well when that tree's ``src`` comes first
    on ``sys.path``."""
    import torch
    from repro_torch.kernels import backend, chunk_diff
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, n, m, C = CHUNK_SHAPES[-1]
    args, opts = random_chunk_inputs(gen, B, n, m, C)

    def outputs():
        return (torch.empty((B, n, C), dtype=torch.int32, device="cuda"),
                torch.empty((B, chunk_diff.N_CHUNK_COUNTERS),
                            dtype=torch.int32, device="cuda"))

    ptrs = [t.data_ptr() for t in args + outputs()]
    chunk_diff.chunk_tick_(*args, **opts)   # the library built and loaded
    emit({"phase": "kernels", "kernel": "chunk_tick", "host_split_us": {
        "call": host_us(lambda: chunk_diff.chunk_tick_(*args, **opts)),
        "route": host_us(lambda: backend.use_kernel(*args)),
        "checks": host_us(lambda: chunk_diff._check(*args)),
        "outputs": host_us(outputs),
        "launch": host_us(lambda: backend.launch(
            "chunk_tick", 0, *ptrs, B, n, m, C, opts["chunk_tokens"],
            opts["artifact_tokens"], opts["signal_tokens"], 4))},
        "shape": [B, n, m, C], "card": card})


def decide_host_split(card: str) -> None:
    """How a kernel-route ``decide`` call of the service's content broker
    (``SERVICE``: 32 clients, 6 artifacts, 64-token chunks) splits, in
    microseconds: the whole call, then each piece on its own: building
    the prefix batch with the content plane's inputs and moving it to
    the card in one copy (``decision_inputs``),
    the MESI tick's launch with its gathers (``decision_tick``), the
    chunk tick's launch, the one read-back (the batch's buffers copied
    to the host) and the host bookkeeping (the call less the four).  The
    two launches are timed behind a spin kernel (``host_us``); the call,
    the prefix batch and the read-back (which waits for the card) as the
    mean wall time of ``HOST_SPLIT_CALLS`` calls on an idle stream."""
    import numpy as np
    import torch
    from repro_torch.core import acs
    from repro_torch.kernels import chunk_diff, mesi_transition as mt
    from repro_torch.service import BatchDecider

    def wall_us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_SPLIT_CALLS):
            fn()
        return (time.perf_counter() - t0) / HOST_SPLIT_CALLS * 1e6

    n, m = SERVICE["clients"], SERVICE["artifacts"]
    cfg = acs.ACSConfig(n_agents=n, n_artifacts=m,
                        artifact_tokens=SERVICE["artifact_tokens"],
                        n_steps=1, chunk_tokens=SERVICE["chunk_tokens"])
    C = acs.content_chunks(cfg)
    rng = np.random.default_rng(SEED)
    acts = rng.random(n) < 0.75
    arts = rng.integers(0, m, n).astype(np.int32)
    writes = rng.random(n) < 0.10
    wchunks = rng.random((n, C)) < 0.25
    decider = BatchDecider(cfg, "kernel", device="cuda")
    decider.decide(acts, arts, writes, write_chunks=wchunks)
    a = decider.arrays
    opts = dict(artifact_tokens=cfg.artifact_tokens, eager=False,
                access_k=0, signal_tokens=12)
    # the pieces as the decider runs them (``BatchDecider._decide_kernel``)
    tail = np.concatenate([(acts & writes).astype(np.int32),
                           wchunks.astype(np.int32).reshape(-1)])
    prefix = mt.decision_inputs(acts, arts, writes, m, "cuda", tail=tail)
    st, ver, sy, rd, cnt, miss, served = mt.decision_tick(
        a.state, a.version, a.last_sync, a.reads_since_fetch, prefix,
        **opts)
    B, head = n + 1, 3 * (n + 1) * n + 2 * n
    chunk_args = (a.chunk_version.clone(), a.chunk_sync.clone(),
                  a.chunk_dirty.clone(), miss[None],
                  prefix[head:head + n][None], prefix[B * n:B * n + n][None],
                  prefix[head + n:].view(1, n, C))
    copts = dict(artifact_tokens=cfg.artifact_tokens,
                 chunk_tokens=cfg.chunk_tokens, signal_tokens=12)
    fetched, ccnt = chunk_diff.chunk_tick_(*chunk_args, **copts)
    parts = [st, ver, miss, served, cnt[:6], ccnt[0, :3], fetched]
    split = {
        "call": wall_us(lambda: decider.decide(acts, arts, writes,
                                               write_chunks=wchunks)),
        "prefix_batch": wall_us(lambda: mt.decision_inputs(
            acts, arts, writes, m, "cuda", tail=tail)),
        "mesi_tick_launch": host_us(lambda: mt.decision_tick(
            a.state, a.version, a.last_sync, a.reads_since_fetch, prefix,
            **opts)),
        "chunk_tick_launch": host_us(lambda: chunk_diff.chunk_tick_(
            *chunk_args, **copts)),
        "read_back": wall_us(lambda: decider._read_back(parts))}
    split["bookkeeping"] = split["call"] - sum(
        split[k] for k in ("prefix_batch", "mesi_tick_launch",
                           "chunk_tick_launch", "read_back"))
    emit({"phase": "kernels", "kernel": "service_decide",
          "host_split_us": split, "route": "kernel",
          "shape": {"clients": n, "artifacts": m, "chunks": C,
                    "requests": int(acts.sum())}, "card": card})


def host_split(card: str) -> None:
    """How the host time of a call splits, for ``mesi_tick_`` at the
    content fleet's shape (lazy), ``rwkv6_scan`` at rwkv6-1.6b's decode
    step (24 calls a step) and ``chunk_tick_`` (``chunk_host_split``):
    the whole call, then each piece of it on its own: the routing rule,
    the checks, the output allocations, the bonus conversion the wrapper
    skips for an fp32 bonus, and ``backend.launch`` with the pointers
    ready.  Each is the mean of ``HOST_SPLIT_CALLS`` calls back to back
    behind one spin kernel (``host_us``), in microseconds."""
    import torch
    import importlib
    from repro_torch.configs import get
    from repro_torch.kernels import backend, mesi_transition as mt
    wkv = importlib.import_module("repro_torch.kernels.rwkv6_scan")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, n, m = MESI_SHAPES[-1]
    args = random_mesi_inputs(gen, B, n, m)
    opts = dict(artifact_tokens=4096, eager=False, access_k=0,
                signal_tokens=12)
    ptrs = [t.data_ptr() for t in args + mt._outputs(B, n, "cuda")]
    emit({"phase": "kernels", "kernel": "mesi_tick", "host_split_us": {
        "call": host_us(lambda: mt.mesi_tick_(*args, **opts)),
        "route": host_us(lambda: backend.use_kernel(*args)),
        "checks": host_us(lambda: mt._check(*args)),
        "outputs": host_us(lambda: mt._outputs(B, n, "cuda")),
        "launch": host_us(lambda: backend.launch(
            "mesi_tick", 0, *ptrs, B, n, m, 4096, 0, 0, 12))},
        "shape": [B, n, m], "card": card})

    cfg = get(SERVE_RWKV["arch"])
    h, dh = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    b = SERVE_RWKV["agents"]
    r, k, v, w = (torch.rand((b, 1, h, dh), generator=gen, device="cuda")
                  for _ in range(4))
    bonus = torch.randn((h, dh), generator=gen, device="cuda")
    s0 = torch.randn((b, h, dh, dh), generator=gen, device="cuda")
    y, state = wkv._outputs(r)
    wptrs = [x.data_ptr() for x in (r, k, v, w, bonus, s0, y, state)]
    emit({"phase": "kernels", "kernel": "rwkv6_scan", "host_split_us": {
        "call": host_us(lambda: wkv.rwkv6_scan(r, k, v, w, bonus, s0)),
        "route": host_us(lambda: backend.use_kernel(r, k, v, w, bonus,
                                                     s0)),
        "checks": host_us(lambda: wkv._check(r, k, v, w, bonus, s0)),
        "bonus_conversion": host_us(
            lambda: bonus.to(torch.float32).contiguous()),
        "outputs": host_us(lambda: wkv._outputs(r)),
        "launch": host_us(lambda: backend.launch(
            "rwkv6_scan", 0, *wptrs, b, 1, h, dh, 0))},
        "shape": [b, 1, h, dh], "card": card})
    chunk_host_split(card)
    decide_host_split(card)


def check_rwkv6_scan(card: str, rate: float, fp32_flops: float, gen,
                     P: int, L1: int) -> tuple:
    """The WKV kernel against its plain version at the rwkv serving
    path's shapes (rwkv6-1.6b: the batched prefill of P steps, one
    agent's prefill of L1, a decode step from a random state) and a
    ragged bf16 mid shape; returns the batched prefill's row and the
    shapes' cases for ``check_repeats``.  Each row's ``issue_floor_ms``
    is the time of four fp32 instructions per state element per step
    (the state update's rounded multiply, multiply and add, and y's FMA)
    over the card's fp32 lanes at its highest SM clock."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.ref import rwkv6_scan_plain
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    cfg = get(SERVE_RWKV["arch"])
    h, dh = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    n = SERVE_RWKV["agents"]
    f32 = torch.float32
    lanes = (torch.cuda.get_device_properties(0).multi_processor_count
             * FP32_LANES_PER_SM)
    clock_hz = max_sm_clock_hz()
    result, repeats = None, []
    for label, b, t, heads, dtype, state in (
            ("batched prefill", n, P, h, f32, False),
            ("agent prefill", 1, L1, h, f32, False),
            ("decode", n, 1, h, f32, True),
            ("mid bf16", 2, 1000, 8, torch.bfloat16, False)):
        r, k, v = (torch.randn((b, t, heads, dh), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        # the model's decay range: exp(-exp(U(-8, -5)))
        w = torch.exp(-torch.exp(torch.rand(
            (b, t, heads, dh), generator=gen, device="cuda") * 3 - 8)
        ).to(dtype)
        bonus = torch.randn((heads, dh), generator=gen, device="cuda") * 0.1
        s0 = (torch.randn((b, heads, dh, dh), generator=gen, device="cuda")
              if state else None)
        args = (r, k, v, w, bonus, s0)
        y, s = rwkv6_scan(*args)
        torch.cuda.synchronize()
        ey, es = rwkv6_scan_plain(*args)
        check(torch.equal(s, es),
              f"rwkv6_scan final state == plain bit for bit ({label})")
        err = float((y.float() - ey.float()).abs().max())
        row_rms = ey.float().square().mean(dim=-1, keepdim=True).sqrt()
        row_rel = float(((y.float() - ey.float()).abs() / row_rms).max())
        if dtype == f32:
            head_rms = ey.square().mean(dim=(1, 3), keepdim=True).sqrt()
            wkv_err = float(((y - ey).abs() / (WKV_FP32_TOL * head_rms))
                            .max())
            check(wkv_err <= 1.0, f"rwkv6_scan y within {WKV_FP32_TOL} of "
                  f"its head's rms ({label}: {wkv_err})")
        else:
            wkv_err = bf16_row_err(y, ey)
            check(wkv_err <= 1.0, f"rwkv6_scan y within one bf16 ulp plus "
                  f"{ROW_RMS_FLOOR} of the row rms ({label}: {wkv_err})")
        moved = (sum(x.numel() * x.element_size()
                     for x in args + (y, s) if x is not None))
        work = 5 * b * t * heads * dh * dh
        bytes_ms, ops_ms = moved / rate * 1e3, work / fp32_flops * 1e3
        make = lambda: args   # noqa: E731
        dev_ms, host_ms = device_ms(rwkv6_scan, make, 5)
        row = {"phase": "kernels", "kernel": "rwkv6_scan", "case": label,
               "shape": [b, t, heads, dh], "dtype": str(dtype).split(".")[-1],
               "initial_state": state, "state_equal": True,
               "max_abs_err": err, "max_wkv_err": wkv_err,
               "max_err_over_row_rms": row_rel,
               "ms": median_ms(rwkv6_scan, make, 5),
               "device_ms": dev_ms, "host_ms": host_ms,
               # one call of the plain loop is itself thousands of steps
               "plain_ms": median_ms(rwkv6_scan_plain, make, 1),
               "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
               "issue_floor_ms": 4 * b * t * heads * dh * dh
               / (lanes * clock_hz) * 1e3,
               "card": card}
        emit(row)
        repeats.append(("rwkv6_scan", label,
                        functools.partial(rwkv6_scan, *args), (y, s)))
        if label == "batched prefill":
            result = row
    return result, repeats


def phase_goldens(card: str) -> None:
    """The committed golden ledgers on the card, on the port's own
    threefry draws in legacy mode: the scenarios exactly; the zoo and
    content cells with the runs that differ counted by family (the
    Gumbel sampler's ``log`` may round apart from XLA's on the card)."""
    import torch
    from repro_torch.core import acs, prng
    from repro_torch.sim import (SCENARIOS, compare_grid, make, run_workload,
                                 zoo)

    golden_dir = REPO / "tests" / "golden"

    def golden(name):
        return json.loads((golden_dir / f"{name}.json").read_text())

    def roundtrip(payload):
        return json.loads(json.dumps(payload, sort_keys=True, default=float))

    t0 = time.perf_counter()
    cmps = compare_grid(list(SCENARIOS.values()), partitionable=False)
    payload = {key: {
        "scenario": c.scenario, "volatility": c.volatility,
        "broadcast_total_mean": c.broadcast.total_tokens_mean,
        "coherent_total_mean": c.coherent.total_tokens_mean,
        "savings_mean": c.savings_mean, "savings_std": c.savings_std,
        "crr": c.crr, "cache_hit_rate_mean": c.chr_mean}
        for key, c in zip(SCENARIOS, cmps)}
    check(roundtrip(payload) == golden("scenarios"),
          "tests/golden/scenarios.json reproduced exactly (legacy mode)")

    zoo_golden = golden("workloads")
    grid = zoo_golden["_grid"]
    differ = {}
    for w in zoo(**grid):
        bc = run_workload(w.with_strategy(acs.BROADCAST),
                          partitionable=False)
        co = run_workload(w, partitionable=False)
        want = zoo_golden[w.family]
        differ[w.family] = sum(
            int(a != b) for a, b in zip(
                [int(x) for x in co.per_run_total_tokens]
                + [int(x) for x in bc.per_run_total_tokens],
                want["coherent_per_run"] + want["broadcast_per_run"]))
    content_golden = golden("content")
    small = dict(n_agents=4, n_artifacts=3, n_runs=2, artifact_tokens=96,
                 n_steps=8)
    for family in ("bursty", "ping_pong"):
        for ct in (16, 40):
            w = make(family, **small, chunk_tokens=ct)
            keys = acs.run_keys(prng.prng_key(w.seed, "cuda"), [0])
            met = acs.run_episode(w.acs, keys, rates=w.rates(),
                                  locality=w.write_locality,
                                  partitionable=False)
            got = {"delta_bytes": int(met.delta_bytes[0]),
                   "full_bytes": int(met.full_bytes[0]),
                   "n_chunks_fetched": int(met.n_chunks_fetched[0]),
                   "n_fills": int(met.n_fetches[0])}
            cell = f"{family}/ct{ct}"
            differ[f"content {cell}"] = int(got != content_golden[cell])
    torch.cuda.synchronize()
    emit({"phase": "scenarios", "goldens": "legacy threefry",
          "scenarios_exact": True, "runs_differing": differ,
          "runs_differing_total": sum(differ.values()),
          "seconds": time.perf_counter() - t0, "card": card})


def phase_scenarios(card: str) -> None:
    import torch
    from repro_torch.core import acs, theorem
    from repro_torch.kernels import mesi_transition as mt
    from repro_torch.sim import SCENARIOS, compare_grid

    phase_goldens(card)

    scns = [dataclasses.replace(SCENARIOS[k], n_runs=SCENARIO_RUNS)
            for k in "ABCD"]
    launches = mt.mesi_tick_.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = compare_grid(scns)
    seconds = time.perf_counter() - t0
    check(mt.mesi_tick_.launches - launches == scns[0].acs.n_steps,
          "one MESI kernel launch per step for the four scenarios")
    for key, scn, c in zip("ABCD", scns, results):
        bound = theorem.savings_lower_bound_uniform(
            scn.acs.n_agents, scn.acs.n_steps, scn.acs.volatility)
        check(c.savings_mean >= bound, f"{key}: savings >= theorem bound")
        check(abs(c.savings_mean - PUBLISHED[key]) <= PUBLISHED_TOLERANCE,
              f"{key}: savings within 2.5 pp of the paper")
        emit({"phase": "scenarios", "scenario": c.scenario,
              "n_runs": scn.n_runs, "savings_mean": c.savings_mean,
              "savings_std": c.savings_std, "theorem_bound": bound,
              "published": PUBLISHED[key], "chr_mean": c.chr_mean})
    emit({"phase": "scenarios", "episodes": 2 * 4 * SCENARIO_RUNS,
          "seconds": seconds,
          "episodes_per_s": 2 * 4 * SCENARIO_RUNS / seconds,
          "card": card})

    # The kernel and scan routes draw the same stream, so on the whole
    # grid every statistic agrees exactly but the staleness diagnostics,
    # which the kernel route does not track.
    untracked = dict(max_staleness_max=-1, max_version_lag_max=-1,
                     max_consumed_staleness_max=-1)
    for key, kern, scan in zip("ABCD", results,
                               compare_grid(scns, tick_backend="scan")):
        check(dataclasses.replace(kern.coherent, **untracked)
              == dataclasses.replace(scan.coherent, **untracked)
              and (kern.savings_mean, kern.savings_std, kern.chr_std)
              == (scan.savings_mean, scan.savings_std, scan.chr_std),
              f"{key}: kernel route == scan route on the card")
    emit({"phase": "scenarios", "routes_equal": True,
          "episodes": 4 * SCENARIO_RUNS,
          "strategy": acs.STRATEGY_NAMES[scns[0].acs.strategy]})


def phase_fleet(card: str) -> float:
    """The zoo fleet runs; returns the content-plane run's seconds."""
    import torch
    from repro_torch.core import acs
    from repro_torch.kernels import chunk_diff, mesi_transition as mt
    from repro_torch.sim import compare_workloads, zoo

    workloads = zoo(n_agents=16, n_artifacts=16, n_runs=FLEET_RUNS,
                    chunk_tokens=64)
    episodes = len(workloads) * FLEET_RUNS
    steps = workloads[0].acs.n_steps
    before = (mt.mesi_tick_.launches, chunk_diff.chunk_tick_.launches)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = compare_workloads(workloads)
    seconds = time.perf_counter() - t0
    check((mt.mesi_tick_.launches - before[0],
           chunk_diff.chunk_tick_.launches - before[1]) == (steps, steps),
          "one launch of each kernel per step for the whole zoo")
    for c in results:
        check(c.coherent.delta_bytes_mean <= c.coherent.full_bytes_mean,
              f"{c.scenario}: delta bytes <= whole-artifact bytes")
        emit({"phase": "fleet", "family": c.scenario,
              "savings_mean": c.savings_mean,
              "delta_bytes_mean": c.coherent.delta_bytes_mean,
              "full_bytes_mean": c.coherent.full_bytes_mean,
              "chr_mean": c.chr_mean})
    fleet_seconds = seconds
    emit({"phase": "fleet", "strategy": "lazy", "chunk_tokens": 64,
          "episodes_per_variant": episodes, "seconds": seconds,
          "episodes_per_s": 2 * episodes / seconds,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": card})

    for code in (acs.EAGER, acs.ACCESS_COUNT):
        ws = [w.with_strategy(code)
              for w in zoo(n_agents=16, n_artifacts=16,
                           n_runs=STRATEGY_FLEET_RUNS)]
        before = (mt.mesi_tick_.launches, chunk_diff.chunk_tick_.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = compare_workloads(ws)
        seconds = time.perf_counter() - t0
        check((mt.mesi_tick_.launches - before[0],
               chunk_diff.chunk_tick_.launches - before[1]) == (steps, 0),
              f"{acs.STRATEGY_NAMES[code]}: one MESI launch per step")
        check(all(0.0 < c.chr_mean <= 1.0 and c.crr > 0.0 for c in res),
              f"{acs.STRATEGY_NAMES[code]}: finite ledgers")
        emit({"phase": "fleet", "strategy": acs.STRATEGY_NAMES[code],
              "episodes_per_variant": len(ws) * STRATEGY_FLEET_RUNS,
              "seconds": seconds,
              "episodes_per_s": 2 * len(ws) * STRATEGY_FLEET_RUNS / seconds,
              "savings_mean": {c.scenario: c.savings_mean for c in res},
              "card": card})
    return fleet_seconds


def service_workload(family: str):
    """One family of the service cell, built as the JAX package's service
    launcher builds it (``uniform`` is ``zipf`` with skew 0 at V = 0.10,
    the paper's homogeneous scenario)."""
    from repro_torch.sim import workloads
    kw = dict(n_agents=SERVICE["clients"], n_artifacts=SERVICE["artifacts"],
              artifact_tokens=SERVICE["artifact_tokens"],
              n_steps=SERVICE["rounds"], seed=SERVICE_SEEDS[family])
    if family == "uniform":
        return dataclasses.replace(
            workloads.zipf(skew=0.0, volatility=0.10, **kw),
            name="uniform V=0.10", family="uniform")
    return workloads.make(family, **kw)


def run_service(family: str, backend: str, chunk_tokens: int = 0,
                device: str = "cuda", **core) -> dict:
    """One broker of the service cell (telemetry and trace capture on)
    driven through its family's lockstep load on ``device``; returns the
    broker, the ``LoadReport``, the tick launches during the load, every
    batch's ``BatchDecision`` and the seconds of the decider's warm-up
    event."""
    import asyncio
    from repro_torch.kernels import chunk_diff, mesi_transition as mt
    from repro_torch.obs import runtime
    from repro_torch.service import (CoherenceBroker, CoherenceConfig,
                                     drive_workload)
    names = tuple(f"artifact-{d}" for d in range(SERVICE["artifacts"]))
    core.setdefault("strategy", SERVICE["strategy"])
    cfg = CoherenceConfig.make(
        SERVICE["clients"], names, artifact_tokens=SERVICE["artifact_tokens"],
        chunk_tokens=chunk_tokens, backend=backend, telemetry=True,
        capture_trace=True, **core).broker_view()

    async def main() -> dict:
        async with CoherenceBroker(cfg, device=device) as broker:
            decisions = []
            decide = broker.decider.decide

            def recorded(*args, **kw):
                decisions.append(decide(*args, **kw))
                return decisions[-1]
            broker.decider.decide = recorded
            events = len(runtime.compile_events())
            before = (mt.mesi_tick_.launches, chunk_diff.chunk_tick_.launches)
            load = await drive_workload(broker, service_workload(family),
                                        SERVICE["rounds"],
                                        seed=SERVICE_SEEDS[family],
                                        lockstep=True)
            launches = (mt.mesi_tick_.launches - before[0],
                        chunk_diff.chunk_tick_.launches - before[1])
        warm = [e["dur_s"] for e in runtime.compile_events()[events:]
                if e["kind"] == "warmup"]
        return dict(broker=broker, load=load, launches=launches,
                    decisions=decisions, warmup_s=warm[0])
    return asyncio.run(main())


def same_service(a: dict, b: dict, what: str) -> None:
    """Two brokers' runs decided alike: traces step for step (agents,
    artifacts, writes, miss, served versions, measured write chunks),
    every batch's decision (with content the chunks each fill shipped),
    ledgers, wire ledgers, directory, versions and last_sync, and with
    content the chunk arrays."""
    import numpy as np
    ba, bb = a["broker"], b["broker"]
    check(ba.trace.n_steps == bb.trace.n_steps > 0
          and all((s.agents, s.arts, s.writes, s.miss, s.version, s.chunks)
                  == (r.agents, r.arts, r.writes, r.miss, r.version,
                      r.chunks)
                  for s, r in zip(ba.trace.steps, bb.trace.steps)),
          f"{what}: traces equal step for step")
    check(len(a["decisions"]) == len(b["decisions"]) and all(
        np.array_equal(x.miss, y.miss) and np.array_equal(x.version,
                                                          y.version)
        and x.ledger_delta == y.ledger_delta
        and x.wire_delta == y.wire_delta
        and (x.fetched_chunks is None) == (y.fetched_chunks is None)
        and (x.fetched_chunks is None
             or np.array_equal(x.fetched_chunks, y.fetched_chunks))
        for x, y in zip(a["decisions"], b["decisions"])),
        f"{what}: decisions equal batch by batch")
    leaves = ["last_sync"] + (["chunk_version", "chunk_sync", "chunk_dirty"]
                              if ba.chunks is not None else [])
    check(dataclasses.astuple(ba.ledger) == dataclasses.astuple(bb.ledger)
          and ba.wire == bb.wire
          and np.array_equal(ba.directory_state, bb.directory_state)
          and np.array_equal(ba.versions, bb.versions)
          and all(np.array_equal(getattr(ba.decider.arrays, x).cpu().numpy(),
                                 getattr(bb.decider.arrays, x).cpu().numpy())
                  for x in leaves),
          f"{what}: ledgers, wire, directory, versions, arrays equal")


#: host functions whose cumulative time ``service_profile`` reports
SERVICE_HOST_SPANS = ("_decide_and_resolve", "decide", "_decide_kernel",
                      "_measure_write_masks", "record_batch", "append_step",
                      "_patch_mirror", "sample_round")


def service_profile(card: str) -> None:
    """Where the time of the uniform family's kernel-route brokers goes,
    without and with 64-token chunks: the device's busy share of one run
    under the torch profiler, then, in another run under ``cProfile``,
    the host's time by function (own time, largest first, and the
    cumulative time of ``SERVICE_HOST_SPANS``)."""
    import cProfile
    import pstats
    for chunk in (0, SERVICE["chunk_tokens"]):
        wall, busy, top = device_profile(
            lambda: run_service("uniform", "kernel", chunk))
        prof = cProfile.Profile()
        prof.enable()
        t0 = time.perf_counter()
        run_service("uniform", "kernel", chunk)
        host_wall = time.perf_counter() - t0
        prof.disable()
        stats = pstats.Stats(prof).stats
        own = sorted(((tt, f"{pathlib.Path(f).name}:{line}({name})", nc)
                      for (f, line, name), (_, nc, tt, _, _)
                      in stats.items()), reverse=True)
        spans = {}
        for (f, line, name), (_, _, _, ct, _) in stats.items():
            if name in SERVICE_HOST_SPANS and "repro_torch" in f:
                spans[name] = spans.get(name, 0.0) + ct
        emit({"phase": "service", "what": "profile", "family": "uniform",
              "route": "kernel", "chunk_tokens": chunk, "wall_s": wall,
              "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
              "top_device": top[:6], "host_wall_s": host_wall,
              "host_own_s": [{"function": k, "seconds": s, "calls": c}
                             for s, k, c in own[:10]],
              "host_cumulative_s": spans, "card": card})


def phase_service(card: str) -> None:
    """The live coherence service on the card: each family of
    ``SERVICE_FAMILIES`` through brokers on both decision routes, with
    and without 64-token chunks, then eager and access_count (k = 3) on
    ``bursty`` (kernel route) and K = 3 staleness on ``uniform`` (scan
    route).  Every broker's trace is verified by the port's oracle (its
    kernel legs on the card; K-staleness is outside the oracle's scope,
    so that broker is held to its live invariant checks) and its metrics
    by the conformance replay; the routes must agree step for step; the
    kernel route must launch one MESI tick (and with content one chunk
    tick) per micro-batch and the scan route none; the uniform family's
    kernel-route broker on the CPU must decide exactly as on the card."""
    import numpy as np
    import torch
    from repro_torch.obs import check_metrics_conformance
    from repro_torch.service import verify_broker

    def verified(run: dict, label: str, family: str) -> None:
        broker = run["broker"]
        kernel = broker.decider.backend == "kernel"
        content = broker.chunks is not None
        batches = broker.n_batches
        check(run["launches"] == ((batches, batches if content else 0)
                                  if kernel else (0, 0)),
              f"{label}: {run['launches']} tick launches for {batches} "
              f"micro-batches")
        if broker.config.max_stale_steps:
            consumed = int(broker.decider.metrics.max_consumed_staleness)
            check(consumed <= broker.config.max_stale_steps,
                  f"{label}: served staleness {consumed} within K")
            legs = ("live_invariants",)
        else:
            legs = verify_broker(broker, name=label).implementations
        conformance = check_metrics_conformance(broker, name=label)
        load = run["load"]
        decide = np.array([s.decide_s for s in broker.trace.steps]) * 1e3
        emit({"phase": "service", "broker": label, "family": family,
              "route": broker.decider.backend,
              "strategy": broker.config.strategy,
              "chunk_tokens": broker.config.chunk_tokens,
              "max_stale_steps": broker.config.max_stale_steps,
              "actions": load.n_actions, "micro_batches": batches,
              "mean_batch": load.n_actions / batches,
              "throughput_dps": load.throughput_dps,
              "capacity_dps": load.capacity_dps,
              "request_p50_ms": load.latency_ms(50),
              "request_p99_ms": load.latency_ms(99),
              "decide_p50_ms": float(np.percentile(decide, 50)),
              "decide_p99_ms": float(np.percentile(decide, 99)),
              "savings_vs_broadcast": load.savings_vs_broadcast,
              "wire": dict(broker.wire) if content else None,
              "warmup_s": run["warmup_s"], "launches": run["launches"],
              "oracle": list(legs),
              "conformance_cells": conformance["label_cells_compared"],
              "card": card})

    t0 = time.perf_counter()
    brokers = 0
    cards = {}
    for family in SERVICE_FAMILIES:
        for chunk in (0, SERVICE["chunk_tokens"]):
            runs = {backend: run_service(family, backend, chunk)
                    for backend in ("kernel", "scan")}
            for backend, run in runs.items():
                check(run["broker"].decider.backend == backend,
                      f"{family}: route {backend}")
                verified(run, f"{family}:{backend}:chunks={chunk}", family)
            same_service(runs["kernel"], runs["scan"],
                         f"{family} (chunks={chunk}): kernel == scan")
            brokers += 2
            cards[(family, chunk)] = runs["kernel"]
    for label, family, backend, core in (
            ("bursty:kernel:eager", "bursty", "kernel",
             dict(strategy="eager")),
            ("bursty:kernel:access_count", "bursty", "kernel",
             dict(strategy="access_count", access_k=3)),
            ("uniform:scan:K=3", "uniform", "scan",
             dict(max_stale_steps=3))):
        verified(run_service(family, backend, **core), label, family)
        brokers += 1
    seconds = time.perf_counter() - t0
    card_run = cards[("uniform", 0)]
    cpu_run = run_service("uniform", "kernel", device="cpu")
    same_service(card_run, cpu_run, "uniform kernel route: card == CPU")
    check(card_run["load"].savings_vs_broadcast
          == cpu_run["load"].savings_vs_broadcast,
          "uniform: savings_vs_broadcast on the card == on the CPU")
    service_profile(card)
    emit({"phase": "service", "brokers": brokers, "seconds": seconds,
          "routes_equal": True, "card_equals_cpu": True,
          "uniform_savings_vs_broadcast":
              card_run["load"].savings_vs_broadcast,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": card})


def device_profile(fn):
    """Run ``fn()`` under the torch profiler; returns the wall seconds,
    the device's busy seconds (the union of the kernels' spans) and
    every ``{name, device_ms, calls}`` row by device time, largest
    first (names cut to 60 characters)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # Device kernels and copies only: the profiler mirrors each CPU
    # operator onto the device timeline as a user annotation spanning
    # its kernels, and counting those too would count that time twice.
    def on_device(ev):
        return (ev.device_type == DeviceType.CUDA
                and not ev.is_user_annotation)

    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if on_device(ev))
    check(bool(spans), "the profiler saw device kernels")
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:          # the union of the kernels' spans
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if on_device(ev) and ev.self_device_time_total > 0),
                  reverse=True)
    return wall, busy_us / 1e6, [
        {"name": k[:60], "device_ms": us / 1e3, "calls": c}
        for us, k, c in rows]


def phase_profile(card: str, fleet_seconds: float) -> None:
    """Where the time goes in the content-plane fleet run: device time
    by kernel name over one repeat of it, and the device's busy share
    of the wall time, both of the profiled repeat and of the unprofiled
    run that took ``fleet_seconds``."""
    from repro_torch.sim import compare_workloads, zoo

    workloads = zoo(n_agents=16, n_artifacts=16, n_runs=FLEET_RUNS,
                    chunk_tokens=64)
    wall, busy, top = device_profile(lambda: compare_workloads(workloads))
    emit({"phase": "profile", "what": "fleet", "wall_s": wall,
          "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
          "unprofiled_wall_s": fleet_seconds,
          "unprofiled_device_idle_share": 1.0 - busy / fleet_seconds,
          "top": top[:10], "card": card})


def serve_profile(card: str, system, params, steps: int = 8) -> None:
    """Where the time goes in the batched request: its prefill, then
    ``steps`` greedy decode steps, each under the profiler.  The prefill's
    line carries flash attention's share of the device's busy time."""
    import torch
    from repro_torch import models

    cfg, n = system.cfg, len(system.agents)
    contexts = [system.context_tokens(i) for i in range(n)]
    p = min(len(c) for c in contexts)
    tokens = torch.tensor([c[:p] for c in contexts], dtype=torch.int64,
                          device="cuda")
    cache = models.init_cache(cfg, n, p + steps)

    def prefill():
        nonlocal logits, cache
        logits, cache = models.prefill(params, cfg, tokens, cache)

    logits = None
    wall, busy, top = device_profile(prefill)
    flash_ms = sum(row["device_ms"] for row in top
                   if re.search(r"\bflash_(wgmma|fp32)\b", row["name"]))
    emit({"phase": "profile", "what": "prefill", "arch": cfg.name,
          "batch": n, "prompt_len": p, "wall_s": wall,
          "tokens_per_s": n * p / wall, "device_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall,
          "flash_attention_ms": flash_ms,
          "flash_attention_share": flash_ms / (busy * 1e3),
          "top": top[:10], "card": card})

    def decode():
        nonlocal logits, cache
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = models.decode_step(params, cfg, tok, cache)

    wall, busy, top = device_profile(decode)
    emit({"phase": "profile", "what": "decode", "arch": cfg.name,
          "steps": steps,
          "batch": n, "wall_s": wall, "ms_per_step": wall / steps * 1e3,
          "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
          "top": top[:10], "card": card})


class plain_route:
    """Inside ``with plain_route():`` the model kernels' public entry
    points (``repro_torch.kernels.ops``) run their plain versions, on
    CUDA tensors too - the reference the serve phase holds the kernel
    route to.  The port itself has no such switch."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.saved = (ops.rmsnorm, ops.flash_attention, ops.decode_attention,
                      ops.rwkv6_scan)
        ops.rmsnorm = lambda x, w, eps=1e-6, block_rows=128: \
            ref.rmsnorm_plain(x, w, eps)
        ops.flash_attention = lambda q, k, v, causal=True, scale=None, \
            block_q=128, block_k=128: ref.attention_plain(q, k, v, causal,
                                                          scale)
        ops.decode_attention = lambda q, kc, vc, kv_len=None, scale=None, \
            block_k=256: ref.decode_attention_plain(q, kc, vc, kv_len, scale)
        ops.rwkv6_scan = ref.rwkv6_scan_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        (ops.rmsnorm, ops.flash_attention, ops.decode_attention,
         ops.rwkv6_scan) = self.saved
        return False


def model_kernels():
    """The wrappers of the serving paths' kernels, by kernel name."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention, "rwkv6_scan": rwkv6_scan}


def expected_launches(cfg, prefills: int, steps: int) -> dict:
    """Launches of each model kernel over ``prefills`` prefills and
    ``steps`` decode steps: per forward one rmsnorm per norm (norm1 and
    norm2 of each layer, rwkv's ln_x, the final norm) and one mixer
    kernel per layer - flash attention per prefill and decode attention
    per step, or the WKV scan in both."""
    from repro_torch.models.transformer import layer_specs
    mixers = [spec.mixer for spec in layer_specs(cfg)]
    forwards = prefills + steps
    n_attn, n_rwkv = mixers.count("attn"), mixers.count("rwkv")
    return {"rmsnorm": (2 * cfg.n_layers + n_rwkv + 1) * forwards,
            "flash_attention": n_attn * prefills,
            "decode_attention": n_attn * steps,
            "rwkv6_scan": n_rwkv * forwards}


def phase_serve(card: str, serve=SERVE) -> dict:
    """Coherent serving of ``serve``'s workload at its model's registered
    width, with the model kernels' launch counts set to 0 before it;
    returns the counts of the kernels it launched."""
    import torch
    from repro_torch import models
    from repro_torch.launch.serve import batched_request

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    (system, stats), _ = sync_time(lambda: serving_system(serve))
    cfg = system.cfg
    phase = "serve" if serve is SERVE else "serve_rwkv"
    params, init_s = sync_time(lambda: models.init_params(cfg, seed=SEED))
    n_params = models.params_count(params)
    n = len(system.agents)
    contexts = [len(system.context_tokens(i)) for i in range(n)]
    for i in range(n):
        logits, secs = sync_time(lambda: system.materialize_prefill(
            params, i, max_len=serve["max_len"]))
        tokens = min(contexts[i], serve["max_len"])
        check(bool(torch.isfinite(logits).all()),
              f"agent {i}: finite prefill logits")
        emit({"phase": phase, "agent": i, "prefill_tokens": tokens,
              "seconds": secs, "prefill_tokens_per_s": tokens / secs,
              "card": card})
    steps = serve["decode_steps"]
    pre, pre_s = sync_time(lambda: batched_request(system, params, 0))
    out, full_s = sync_time(lambda: batched_request(system, params, steps))
    P = out["prompt_len"]
    check(bool(torch.isfinite(out["logits"]).all()),
          "finite logits of the batched request")
    launches = {name: fn.launches for name, fn in model_kernels().items()}
    expected = expected_launches(cfg, n + 2, steps)
    check(launches == expected,
          f"{cfg.name}: launch counts {launches} == {expected}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    with plain_route():
        plain, plain_s = sync_time(lambda: batched_request(
            system, params, steps, forced=out["tokens"]))
    rel_steps = (torch.linalg.vector_norm(
        (out["logits"] - plain["logits"]).float(), dim=-1)
        / torch.linalg.vector_norm(plain["logits"].float(), dim=-1))
    rel = float(rel_steps[:, 0].max())
    worst = float(rel_steps[:, 1:].max()) if steps else None
    agree = float((torch.argmax(plain["logits"][:, :-1], dim=-1)
                   == out["tokens"]).float().mean()) if steps else 1.0
    decode_s = full_s - pre_s
    emit({"phase": phase, "arch": cfg.name, "params": n_params,
          "dtype": cfg.dtype, "init_seconds": init_s, "agents": n,
          "context_tokens": contexts, "prompt_len": P,
          "batched_prefill_tokens_per_s": n * P / pre_s,
          "batched_prefill_seconds": pre_s,
          "decode_tokens_per_s": n * steps / decode_s if steps else None,
          "decode_seconds": decode_s, "plain_route_seconds": plain_s,
          "logits_rel_l2": rel,
          "logits_rel_l2_max_step": float(rel_steps.max()),
          "logits_rel_l2_max_decode_step": worst,
          "logits_rel_l2_by_step": rel_steps.max(dim=0).values.tolist(),
          "greedy_agreement": agree, "launches": launches,
          "peak_gib": peak, "token_savings": stats.token_savings,
          "flops_savings": stats.flops_savings,
          "prefill_tokens": stats.prefill_tokens,
          "broadcast_tokens": stats.broadcast_tokens,
          "fetches": stats.fetches, "cache_hits": stats.cache_hits,
          "card": card})
    layers = layer_divergence(card, system, params, phase)
    worst_layer = max(row["local"] for row in layers)
    check(worst_layer <= LAYER_REL_L2,
          f"{cfg.name}: every layer's own share of the routes' distance "
          f"{worst_layer} <= {LAYER_REL_L2}")
    last_limit, step_limit = LOGITS_REL_L2[serve["arch"]]
    check(rel <= last_limit,
          f"{cfg.name} prefill logits: kernel vs plain relative L2 {rel} "
          f"<= {last_limit}")
    if steps:
        check(worst <= step_limit,
              f"{cfg.name} decode-step logits: kernel vs plain relative L2 "
              f"{worst} <= {step_limit}")
    serve_profile(card, system, params)
    return {name: count for name, count in launches.items() if count}


def layer_divergence(card: str, system, params, phase: str) -> list:
    """Where the kernel and plain routes part: the batched request's
    prompt through the layers one at a time, on both routes.  Per layer,
    the relative L2 distance of the residual stream after it (whole, and
    at the last position, the one the logits read): ``chained``, each
    route fed its own previous output; ``local``, the kernel route fed
    the plain route's input, so the layer's own share.  Returns the
    rows."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_map

    cfg, n = system.cfg, len(system.agents)
    contexts = [system.context_tokens(i) for i in range(n)]
    p = min(len(c) for c in contexts)
    tokens = torch.tensor([c[:p] for c in contexts], dtype=torch.int64,
                          device="cuda")
    positions = torch.arange(p, device="cuda")[None, :]
    specs = tf.layer_specs(cfg)
    prefix, period = tf.split_pattern(specs)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    def layer(i, x):
        blk = tree_map(lambda a: a[(i - prefix) // period], params["blocks"])
        return tf.layer_apply(blk[f"sub{(i - prefix) % period}"], cfg,
                              specs[i], x, positions=positions)[0]

    check(prefix == 0, "layer_divergence walks stacked layers only")
    xk = xp = tf._embed_tokens(params, cfg, tokens)
    rows = []
    for i in range(cfg.n_layers):
        local = layer(i, xp)
        xk = layer(i, xk)
        with plain_route():
            xp = layer(i, xp)
        rows.append({"layer": i, "chained": rel(xk, xp),
                     "chained_last": rel(xk[:, -1], xp[:, -1]),
                     "local": rel(local, xp),
                     "local_last": rel(local[:, -1], xp[:, -1])})
    torch.cuda.synchronize()
    emit({"phase": phase, "what": "layer_divergence", "arch": cfg.name,
          "prompt": [n, p], "layers": rows, "card": card})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import build, chunk_diff, mesi_transition as mt

    card = card_line()
    rate, flops = memory_rate(card), bf16_rate(card)
    fp32_flops = fp32_rate(card)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "memory_bytes_per_s": rate, "bf16_flops_per_s": flops,
          "fp32_flops_per_s": fp32_flops})
    phase_build(card)
    kernels = phase_kernels(card, rate)
    system, _ = serving_system()
    contexts = [len(system.context_tokens(i))
                for i in range(len(system.agents))]
    kernels.update(phase_model_kernels(card, rate, flops, fp32_flops,
                                       contexts))

    mt.mesi_tick_.launches = 0
    chunk_diff.chunk_tick_.launches = 0
    phase_scenarios(card)
    fleet_seconds = phase_fleet(card)
    launches = {"mesi_tick": mt.mesi_tick_.launches,
                "chunk_tick": chunk_diff.chunk_tick_.launches}

    mt.mesi_tick_.launches = 0
    chunk_diff.chunk_tick_.launches = 0
    phase_service(card)
    launches["mesi_tick"] += mt.mesi_tick_.launches
    launches["chunk_tick"] += chunk_diff.chunk_tick_.launches

    for serve in (SERVE, SERVE_RWKV):
        for fn in model_kernels().values():
            fn.launches = 0
        for name, count in phase_serve(card, serve).items():
            launches[name] = launches.get(name, 0) + count
    check(set(kernels) == set(launches) == set(REPLACES)
          == set(build.KERNELS) and all(v > 0 for v in launches.values()),
          "the main paths launched every kernel")

    phase_profile(card, fleet_seconds)
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": REPLACES[name][0],
        "replaces": REPLACES[name][1], "launches": launches[name],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row.get("bound_by", "bytes"),
        "library_ms": row.get("library_ms"), "shape": row["shape"],
        "staged_sims": row.get("staged_sims"),
        "device_ms": row["device_ms"], "host_ms": row["host_ms"],
        "max_abs_diff": row["max_abs_err"], "kernel_ms": row["ms"]}
        for name, row in kernels.items()], "card": card})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
