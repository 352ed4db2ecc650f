#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. build   - compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
             with nvcc for sm_90a into ``build/repro_torch_kernels/``.
2. kernels - holds each kernel against its plain PyTorch version on the
             card (exact equality of every output) at a mid-size shape
             and at every shape the main path gives it, and times the
             wrapper call and the kernel alone (CUDA events),
             the plain version and the memory bound.
3. scenarios - the paper's scenarios A-D (n=4, m=3, |d|=4096, S=40) with
             4096 runs each: savings must clear the Token Coherence
             Theorem's bound and sit within 2.5 pp of the published table;
             the kernel and scan routes must agree on every statistic
             of the whole grid.
4. fleet   - the six-family workload zoo at n=16 agents, m=16 artifacts,
             4096 runs per family with 64-token chunks (24,576 episodes
             per variant): delta bytes never exceed whole-artifact bytes,
             and each kernel launches once per step; then eager and
             access_count at 1024 runs per family without content.
5. the ``kernels`` line, the card's name and power limit, and the final
   ``{"ok": true, ...}`` line.

Phases 3 and 4 are the main path; the kernels' launch counts are set to
0 just before them and read just after.  Any failed check raises, and
the script then exits non-zero.  Without a CUDA device, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
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

#: mid-size, then every shape the main path gives the kernel: the four
#: scenarios' batch, the eager/access_count fleets, the content fleet
#: (last: the ``kernels`` line reports this one)
MESI_SHAPES = ((8192, 16, 16), (16384, 4, 3), (6144, 16, 16),
               (24576, 16, 16))
CHUNK_SHAPES = ((4096, 16, 16, 64), (24576, 16, 16, 64))
FLEET_RUNS = 4096
#: GPU clock cycles a spin kernel holds the stream for (about 1 ms)
SPIN_CYCLES = 2_000_000
REPLACES = {
    "mesi_tick": ("src/repro_torch/kernels/csrc/mesi_tick.cu",
                  "src/repro/kernels/mesi_transition.py:151"),
    "chunk_tick": ("src/repro_torch/kernels/csrc/chunk_tick.cu",
                   "src/repro/kernels/chunk_diff.py:131"),
}


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


def memory_rate(name: str) -> float:
    if "H100" not in name:
        raise RuntimeError(f"no memory rate on record for {name!r}")
    for variant, rate in H100_BYTES_PER_S.items():
        if variant in name:
            return rate
    return H100_BYTES_PER_S["SXM"]   # "H100 80GB HBM3" is the SXM part


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


def device_ms(fn, make_args, reps: int) -> float:
    """Median device time of ``fn(*make_args())`` alone over ``reps``
    calls: a spin kernel queued first holds the stream while the host
    runs the wrapper, so the CUDA events bracket the kernel's device
    work and none of the host's.  Checks that the spin outlasted the
    host's work on every call."""
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
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        check(held.elapsed_time(start) > host_ms,
              "the spin kernel outlasted the wrapper's host work")
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def changed_words(before, after) -> int:
    return sum(int((b != a).sum()) for b, a in zip(before, after))


def mesi_bound_bytes(inputs, outputs) -> int:
    """Least bytes one MESI tick moves on these inputs: the action
    vectors read in full; the state words the decisions read (the
    addressed cell of every acting agent, the whole column of every
    written artifact, the version of every addressed artifact, the
    read counters of acting agents where the tick reads them); miss and
    counters written in full; every state word whose value changed
    written once."""
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
    state_read = int((cell | (written > 0)[:, None, :]).sum())
    reads_read = int(cell.sum())
    words = (3 * B * n + state_read + int((addressed > 0).sum())
             + reads_read + B * n + B * 8
             + changed_words(inputs[:4], outputs[:4]))
    return 4 * words


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


def phase_build(card: str) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    check(all(build.library_path(name).exists() for name in build.KERNELS),
          "every kernel library is built")
    usage = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": seconds, "arch": "sm_90a",
          "compiled": sorted(logs), "ptxas": usage, "card": card})


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


def phase_kernels(card: str, rate: float) -> dict:
    """Kernel against plain version on the card; returns, per kernel,
    the measurements at the fleet shape (the last shape listed)."""
    import torch
    from repro_torch.core import invariants
    from repro_torch.core.acs import draw_write_chunks
    from repro_torch.kernels import chunk_diff, mesi_transition as mt

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
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
            dev_ms = device_ms(lambda *a: mt.mesi_tick_(*a, **opts), fresh,
                               10)
            plain_ms = median_ms(lambda *a: mt.mesi_tick_plain_(*a, **opts),
                                 fresh, 3)
            bound_ms = mesi_bound_bytes(inputs, out) / rate * 1e3
            row = {"phase": "kernels", "kernel": "mesi_tick",
                   "strategy": label, "shape": [B, n, m],
                   "equal": True, "max_abs_err": err, "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "card": card}
            emit(row)
            if label == "lazy":
                results["mesi_tick"] = row

    for B, n, m, C in CHUNK_SHAPES:
        tokens, chunk = C * 64, 64
        acts, arts, writes = random_mesi_inputs(gen, B, n, m)[4:]
        mesi_in = random_mesi_inputs(gen, B, n, m)[:4] + (acts, arts, writes)
        miss = mt.mesi_tick(*mesi_in, artifact_tokens=tokens)[5]
        cv = torch.randint(1, 5, (B, m, C), generator=gen, device="cuda",
                           dtype=torch.int32)
        lag = torch.randint(0, 2, (B, n, m, C), generator=gen,
                            device="cuda", dtype=torch.int32)
        cs = torch.clamp(cv[:, None] - lag, min=0)
        dirty = (cv > 1).to(torch.int32)
        wmask = draw_write_chunks(gen, B, n, C, 0.25).to(torch.int32)
        inputs = (cv, cs, dirty, miss, (acts * writes).contiguous(), arts,
                  wmask)
        opts = dict(artifact_tokens=tokens, chunk_tokens=chunk,
                    signal_tokens=12)
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
        dev_ms = device_ms(lambda *a: chunk_diff.chunk_tick_(*a, **opts),
                           fresh, 10)
        plain_ms = median_ms(lambda *a: chunk_diff.chunk_tick_plain_(
            *a, **opts), fresh, 3)
        bound_ms = chunk_bound_bytes(inputs, out) / rate * 1e3
        row = {"phase": "kernels", "kernel": "chunk_tick",
               "shape": [B, n, m, C], "equal": True, "max_abs_err": err,
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "card": card}
        emit(row)
        results["chunk_tick"] = row
    return results


def phase_scenarios(card: str) -> None:
    import torch
    from repro_torch.core import acs, theorem
    from repro_torch.kernels import mesi_transition as mt
    from repro_torch.sim import SCENARIOS, compare_grid

    scns = [dataclasses.replace(SCENARIOS[k], n_runs=4096) for k in "ABCD"]
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
    emit({"phase": "scenarios", "episodes": 2 * 4 * 4096,
          "seconds": seconds, "episodes_per_s": 2 * 4 * 4096 / seconds,
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
          "episodes": 4 * 4096,
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
              for w in zoo(n_agents=16, n_artifacts=16, n_runs=1024)]
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
              "episodes_per_variant": len(ws) * 1024, "seconds": seconds,
              "episodes_per_s": 2 * len(ws) * 1024 / seconds,
              "savings_mean": {c.scenario: c.savings_mean for c in res},
              "card": card})
    return fleet_seconds


def phase_profile(card: str, fleet_seconds: float) -> None:
    """Where the time goes in the content-plane fleet run: device time
    by kernel name over one repeat of it, and the device's busy share
    of the wall time, both of the profiled repeat and of the unprofiled
    run that took ``fleet_seconds``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim import compare_workloads, zoo

    workloads = zoo(n_agents=16, n_artifacts=16, n_runs=FLEET_RUNS,
                    chunk_tokens=64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compare_workloads(workloads)
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
    busy = busy_us / 1e6
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if on_device(ev) and ev.self_device_time_total > 0),
                  reverse=True)
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall,
          "unprofiled_wall_s": fleet_seconds,
          "unprofiled_device_idle_share": 1.0 - busy / fleet_seconds,
          "top": [{"name": k[:60], "device_ms": us / 1e3, "calls": c}
                  for us, k, c in rows[:10]], "card": card})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import chunk_diff, mesi_transition as mt

    card = card_line()
    rate = memory_rate(card)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "memory_bytes_per_s": rate})
    phase_build(card)
    kernels = phase_kernels(card, rate)

    mt.mesi_tick_.launches = 0
    chunk_diff.chunk_tick_.launches = 0
    phase_scenarios(card)
    fleet_seconds = phase_fleet(card)
    launches = {"mesi_tick": mt.mesi_tick_.launches,
                "chunk_tick": chunk_diff.chunk_tick_.launches}
    check(all(v > 0 for v in launches.values()),
          "the main path launched every kernel")

    phase_profile(card, fleet_seconds)
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": REPLACES[name][0],
        "replaces": REPLACES[name][1], "launches": launches[name],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape": row["shape"],
        "device_ms": row["device_ms"],
        "max_abs_diff": row["max_abs_err"], "kernel_ms": row["ms"]}
        for name, row in kernels.items()], "card": card})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
