"""Tick-based discrete-event simulation engine (paper SS8), sharded over
the host's devices.

Every public function runs a whole evaluation grid - variant x cell x
run, where a cell is one scenario or one workload - as batches of
independent episodes, eagerly.  Cells that share a static configuration
(everything but volatility, activity, rates, locality and seed) and a
run count form one group, and each group runs under its own
``shard_plan``: over ``devices`` shards (``devices=``, else
``REPRO_SWEEP_DEVICES``, else one), by contiguous
blocks of global run indices when the shard count divides the runs,
else by blocks of cells when it divides the cells, else over the runs
padded to the next multiple (the padded runs are real episodes whose
results are dropped).  Shard ``i`` runs on ``cuda:i``.  Every shard's
inputs are built first, then every shard's episodes are queued, and
only then is anything read back, so the devices run at once.  On one
device the plan is one shard over the whole grid, and so it is by
default: every shard repeats the whole grid's per-step host work from
one host thread, and on every grid measured on H100s (``PERF.md``) one
batch beat its shards, on one card and on four.  A ``device`` that
names a card (``cuda:1``) runs unsharded on that card.  The broadcast
baseline and the coherent variant run one after the other over the
same draws.

Per-tick work takes one of two routes (``resolve_tick_backend``):

* ``kernel`` - the hand-written CUDA kernels: per step and shard one
  ``mesi_tick_`` launch and, with the content plane, one
  ``chunk_tick_`` launch fed that step's ``miss`` output.  It covers
  lazy, eager and access_count without K-staleness enforcement, and is
  the default for them.  Staleness diagnostics are not tracked there
  and report the ``-1`` sentinel.  On CPU tensors the same route runs
  the kernels' plain versions.
* ``scan`` - the batched ACS state machine of ``repro_torch.core.acs``.
  Broadcast (always, including every baseline), TTL and K-staleness
  take it; ``tick_backend="scan"`` or ``REPRO_SIM_TICK=scan`` forces
  it for the others.

Random numbers: the reference's threefry stream (``core/prng.py``).
Run ``r`` of a cell is keyed by ``fold_in(PRNGKey(seed), r)`` on the
global run index, split once per step, and each step draws as the
reference's ``draw_actions`` / ``draw_write_chunks`` do, so every
per-run ledger equals ``repro.sim``'s whatever the plan, and a run's
draws do not depend on the grid or the shard around it.
``partitionable`` selects the ``jax_threefry_partitionable`` mode the
draws follow (the committed golden ledgers need ``False``).  All steps'
draws of a shard are made before its step loop, in a few large batched
calls, and both variants of a comparison consume the same draws.

Population statistics (mean, population std) are reported exactly as
the paper does, from the per-run arrays joined over the shards.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.content.chunks import BYTES_PER_TOKEN
from repro_torch.core import acs, prng
from repro_torch.core.states import MESIState
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.chunk_diff import N_CHUNK_COUNTERS, chunk_tick_
from repro_torch.kernels.mesi_transition import (N_COUNTERS,
                                                 episode_step_keys,
                                                 mesi_tick_)
from repro_torch.sim.scenarios import ScenarioConfig

_KERNEL_STRATEGIES = (acs.LAZY, acs.EAGER, acs.ACCESS_COUNT)
_I = int(MESIState.I)
_I32 = torch.int32


def _kernel_tick_supported(cfg: acs.ACSConfig) -> bool:
    """The kernels implement the invalidation strategies (lazy / eager /
    access-count) without K-staleness enforcement; broadcast and TTL
    are bulk-inject paths with no per-agent kernel."""
    return cfg.strategy in _KERNEL_STRATEGIES and cfg.max_stale_steps == 0


def resolve_tick_backend(cfg: acs.ACSConfig,
                         tick_backend: Optional[str] = None) -> str:
    """'kernel' | 'scan' for episodes of ``cfg``.  An explicit
    ``tick_backend`` wins over ``REPRO_SIM_TICK``; either may force
    ``scan``, and a request for ``kernel`` on a configuration the
    kernels do not cover gives ``scan``."""
    requested = tick_backend or os.environ.get("REPRO_SIM_TICK", "auto")
    if requested not in ("auto", "kernel", "scan"):
        raise ValueError(f"tick backend must be auto|kernel|scan, got "
                         f"{requested!r}")
    if requested == "scan" or not _kernel_tick_supported(cfg):
        return "scan"
    return "kernel"


# ---------------------------------------------------------------------------
# Device sharding.  Sweep grids are embarrassingly parallel along their
# batch axes; ``shard_plan`` picks which axis a grid shards over.

#: the ``(device, stream)`` placements standing in for the host's
#: devices inside ``_placed`` (None: the host's own)
_PLACED: contextvars.ContextVar = contextvars.ContextVar("_PLACED",
                                                         default=None)


@contextlib.contextmanager
def _placed(placements):
    """Within the block the engine takes ``placements``, ``(device,
    stream or None)`` pairs, for the host's devices: the local count is
    their number, and shard ``i`` of a sharded plan runs on the ``i``-th
    (queued on its stream when it has one).  The counterpart of the
    reference's forced host devices on a host with one device: N x
    ``("cpu", None)`` on the CPU, N streams of ``cuda:0`` on one card."""
    token = _PLACED.set(tuple((torch.device(d), s) for d, s in placements))
    try:
        yield
    finally:
        _PLACED.reset(token)


def _local_device_count(device=None) -> int:
    """Devices a sweep on ``device`` (None: CUDA) may shard over: every
    CUDA device of the host, one on the CPU and one on a named card."""
    placed = _PLACED.get()
    if placed is not None:
        return len(placed)
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return 1
    return max(1, torch.cuda.device_count())


def resolve_sweep_devices(device=None) -> int:
    """Device count the sweep engine shards over (1 = unsharded).

    ``REPRO_SWEEP_DEVICES=n`` forces a count (capped at the local
    device count; ``1`` disables sharding) and ``auto`` takes every
    local device: ``torch.cuda.device_count()`` on CUDA, 1 on the CPU.
    Unset, it is 1: the one batch has beaten its shards on every grid
    measured (the module's docstring).
    """
    forced = os.environ.get("REPRO_SWEEP_DEVICES", "1")
    n_local = _local_device_count(device)
    if forced != "auto":
        try:
            n = int(forced)
        except ValueError:
            raise ValueError(
                f"REPRO_SWEEP_DEVICES must be an integer or 'auto', "
                f"got {forced!r}") from None
        return max(1, min(n, n_local))
    return n_local


class ShardPlan(NamedTuple):
    """How one grid call maps onto the devices.

    ``axis`` is ``None`` (one unsharded batch), ``"runs"`` (blocks of
    runs) or ``"workloads"`` (blocks of scenario / workload cells).
    ``pad_runs`` is the padded run count the shards cover; padding runs
    is the always-available fallback because run keys are derived from
    **global** run indices, so extra trailing runs are real (discarded)
    episodes, not perturbed ones.
    """

    devices: int
    axis: Optional[str]
    pad_runs: int


def shard_plan(n_cells: int, n_runs: int, devices: Optional[int] = None,
               device=None) -> ShardPlan:
    """Pick the sharded axis of an ``(n_cells x n_runs)`` grid on
    ``device`` (None: CUDA).

    Preference order: shard ``runs`` when the device count divides it,
    else the cell (``workloads``) axis when that divides, else pad
    ``runs`` up to the next multiple and shard it (the padded tail is
    cut on the host).  ``devices=None`` resolves via
    ``resolve_sweep_devices``; the count is capped at the local count.
    """
    if devices is None:
        devices = resolve_sweep_devices(device)
    devices = max(1, min(devices, _local_device_count(device)))
    if devices <= 1:
        return ShardPlan(1, None, n_runs)
    if n_runs % devices == 0:
        return ShardPlan(devices, "runs", n_runs)
    if n_cells % devices == 0:
        return ShardPlan(devices, "workloads", n_runs)
    pad = -n_runs % devices
    return ShardPlan(devices, "runs", n_runs + pad)


def _placements(plan: ShardPlan, device: torch.device) -> tuple:
    """Each shard's ``(device, stream)``: ``device`` unsharded, else
    ``cuda:i`` for shard ``i`` or the placements of ``_placed``."""
    if plan.axis is None:
        return ((device, None),)
    placed = _PLACED.get()
    if placed is not None:
        return placed[:plan.devices]
    return tuple((torch.device("cuda", i), None)
                 for i in range(plan.devices))


# ---------------------------------------------------------------------------
# Result containers.


@dataclasses.dataclass(frozen=True)
class RunStats:
    """Per-configuration population statistics over n_runs.

    ``max_staleness_max`` / ``max_version_lag_max`` are ``-1`` when the
    episodes ran on the kernel route, which does not track staleness
    diagnostics (use ``tick_backend="scan"`` to audit them).
    """

    name: str
    strategy: str
    n_runs: int
    total_tokens_mean: float
    total_tokens_std: float
    sync_tokens_mean: float
    sync_tokens_std: float
    fetch_tokens_mean: float
    signal_tokens_mean: float
    push_tokens_mean: float
    broadcast_tokens_mean: float
    cache_hit_rate_mean: float
    cache_hit_rate_std: float
    n_fetches_mean: float
    n_writes_mean: float
    n_reads_mean: float
    max_staleness_max: int
    max_version_lag_max: int
    #: worst staleness a served cache hit carried (post-revalidation);
    #: ``-1`` on the kernel route (not tracked there).
    max_consumed_staleness_max: int = -1
    #: content-plane bytes-on-wire (``-1`` when ``chunk_tokens == 0``):
    #: delta = what chunk coherence shipped, full = what whole-artifact
    #: lazy would ship for the same miss sequence.
    delta_bytes_mean: float = -1.0
    full_bytes_mean: float = -1.0
    n_chunks_fetched_mean: float = -1.0

    def savings_vs(self, baseline: "RunStats") -> float:
        return 1.0 - self.total_tokens_mean / baseline.total_tokens_mean

    def savings_std_vs(self, baseline: "RunStats",
                       per_run_tokens: np.ndarray,
                       baseline_mean: Optional[float] = None) -> float:
        b = baseline.total_tokens_mean if baseline_mean is None \
            else baseline_mean
        return float(np.std(1.0 - per_run_tokens / b))


@dataclasses.dataclass(frozen=True)
class RunResult:
    stats: RunStats
    per_run_total_tokens: np.ndarray  # (n_runs,)
    per_run_chr: np.ndarray


@dataclasses.dataclass(frozen=True)
class Comparison:
    """Coherent strategy vs broadcast baseline for one scenario."""

    scenario: str
    volatility: float
    strategy: str
    broadcast: RunStats
    coherent: RunStats
    savings_mean: float
    savings_std: float
    crr: float           # Coherence Reduction Ratio (SS8.2)
    chr_mean: float
    chr_std: float


# ---------------------------------------------------------------------------
# Episode batches.


class _Cell(NamedTuple):
    """One scenario or workload of a grid."""

    seed: int
    volatility: float
    p_act: float
    locality: float
    rates: Optional[acs.RateMatrices] = None  # one workload's (n,)/(n, m)


def _scenario_cell(scn: ScenarioConfig, device) -> _Cell:
    return _Cell(scn.seed, scn.acs.volatility, scn.acs.p_act,
                 scn.acs.write_locality)


def _workload_cell(w, device) -> _Cell:
    return _Cell(w.seed, w.acs.volatility, w.acs.p_act, w.write_locality,
                 w.rates(device))


#: element budget of one batched draw call: a shard's steps are drawn
#: in as few calls as keep each call's int64 temporaries near 256 MB
_DRAW_ELEMENTS = 1 << 25


class _Shard(NamedTuple):
    """One shard's inputs, a row per simulation (its cells x its runs),
    on the shard's device."""

    place: tuple                 # (device, stream or None)
    n_cells: int
    n_runs: int
    keys: torch.Tensor           # (B, 2) episode keys
    volatility: torch.Tensor     # (B,)
    p_act: torch.Tensor
    locality: torch.Tensor
    rates: Optional[acs.RateMatrices]   # (B, n) / (B, n, m) leaves


def _on(place):
    """Context in which a shard's work is queued: its stream, else its
    CUDA device, else nothing (the CPU)."""
    device, stream = place
    if stream is not None:
        return torch.cuda.stream(stream)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shard_inputs(items: Sequence, cell_of, runs: range, place) -> _Shard:
    """The cells of ``items`` (``cell_of(item, device)``), episode keys
    of their global run indices ``runs`` and their per-simulation
    inputs, allocated on ``place``.  The host-to-device copies happen
    here, before any shard's episodes are queued."""
    dev = place[0]
    R = len(runs)
    with _on(place):
        cells = [cell_of(item, dev) for item in items]
        ids = torch.arange(runs.start, runs.stop, device=dev)
        keys = torch.cat([acs.run_keys(prng.prng_key(c.seed, dev), ids)
                          for c in cells])

        def per_cell(field):
            return torch.tensor([getattr(c, field) for c in cells],
                                dtype=torch.float32,
                                device=dev).repeat_interleave(R)

        rates = None
        if cells[0].rates is not None:
            rates = acs.RateMatrices(*(
                torch.cat([leaf.expand((R,) + tuple(leaf.shape))
                           for leaf in leaves])
                for leaves in zip(*(c.rates for c in cells))))
        return _Shard(place, len(cells), R, keys, per_cell("volatility"),
                      per_cell("p_act"), per_cell("locality"), rates)


class _Draws(NamedTuple):
    """Every step's draws of a shard: (S, B, n) tensors."""

    acts: torch.Tensor
    arts: torch.Tensor
    writes: torch.Tensor
    span_start: Optional[torch.Tensor]   # content plane only
    locality: torch.Tensor               # (B,)


def _draw(cfg: acs.ACSConfig, shard: _Shard, partitionable: bool) -> _Draws:
    """The reference's draws for a shard's episodes: every step key in
    one call, then the steps' draws in a few batched calls."""
    S, n, m = cfg.n_steps, cfg.n_agents, cfg.n_artifacts
    step_keys = episode_step_keys(shard.keys, S, partitionable)  # (S, B, 2)
    per_step = shard.keys.shape[0] * n * (m if shard.rates is not None
                                          else 1)
    chunk = max(1, _DRAW_ELEMENTS // per_step)
    parts, starts = [], []
    content = acs.content_enabled(cfg)
    for s0 in range(0, S, chunk):
        ks = step_keys[s0:s0 + chunk]
        parts.append(acs.draw_actions(ks, n, m, shard.volatility,
                                      shard.p_act, shard.rates,
                                      partitionable=partitionable))
        if content:
            starts.append(acs.write_span_start(
                ks, n, acs.content_chunks(cfg), partitionable))
    acts, arts, writes = (torch.cat(x) for x in zip(*parts))
    return _Draws(acts, arts, writes, torch.cat(starts) if content else None,
                  shard.locality)


def _step_source(cfg: acs.ACSConfig, draws: _Draws):
    """``step -> (acts, arts, writes, write_chunks)`` over ``draws``;
    ``write_chunks`` only when ``cfg`` has the content plane."""
    content = acs.content_enabled(cfg)
    C = acs.content_chunks(cfg) if content else 0

    def source(step):
        wchunks = (acs.write_span_mask(draws.span_start[step], C,
                                       draws.locality)
                   if content else None)
        return draws.acts[step], draws.arts[step], draws.writes[step], \
            wchunks

    return source


def _episodes_scan(cfg: acs.ACSConfig, source, shard: _Shard) -> dict:
    """The shard through the ACS state machine; metrics dict of (B,)."""
    B = shard.keys.shape[0]
    device = shard.place[0]
    arrays = acs.init_arrays(cfg, B, device)
    met = acs.init_metrics(B, device)
    for step in range(cfg.n_steps):
        arrays, met = acs.tick_(cfg, arrays, met, step, source(step),
                                p_act=shard.p_act, rates=shard.rates)
    out = {
        "total_tokens": met.total_tokens,
        "sync_tokens": met.sync_tokens,
        "fetch_tokens": met.fetch_tokens,
        "signal_tokens": met.signal_tokens,
        "push_tokens": met.push_tokens,
        "broadcast_tokens": met.broadcast_tokens,
        "cache_hit_rate": met.cache_hit_rate,
        "n_fetches": met.n_fetches,
        "n_writes": met.n_writes,
        "n_reads": met.n_reads,
        "max_staleness": met.max_staleness,
        "max_version_lag": met.max_version_lag,
        "max_consumed_staleness": met.max_consumed_staleness,
    }
    if acs.content_enabled(cfg):
        out["delta_bytes"] = met.delta_bytes
        out["full_bytes"] = met.full_bytes
        out["n_chunks_fetched"] = met.n_chunks_fetched
    return out


def _episodes_kernel(cfg: acs.ACSConfig, source, B: int, device) -> dict:
    """The batch through the MESI tick kernel and, with the content
    plane, the chunk tick kernel fed the same step's ``miss``; metrics
    dict of (B,).  The kernels update the state buffers in place, so
    they are allocated once for the episode."""
    n, m = cfg.n_agents, cfg.n_artifacts
    content = acs.content_enabled(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=_I32, device=device)

    state = torch.full((B, n, m), _I, dtype=_I32, device=device)
    version = torch.ones((B, m), dtype=_I32, device=device)
    sync, reads = zeros(B, n, m), zeros(B, n, m)
    counters, n_reads, n_writes = zeros(B, N_COUNTERS), zeros(B), zeros(B)
    if content:
        C = acs.content_chunks(cfg)
        cv = torch.ones((B, m, C), dtype=_I32, device=device)
        cs, dirty = zeros(B, n, m, C), zeros(B, m, C)
        ccounters = zeros(B, N_CHUNK_COUNTERS)
    access_k = cfg.access_k if cfg.strategy == acs.ACCESS_COUNT else 0
    for step in range(cfg.n_steps):
        acts, arts, writes, wchunks = source(step)
        a = acts.to(_I32).contiguous()
        d = arts.to(_I32).contiguous()
        w = writes.to(_I32).contiguous()
        cnt, miss = mesi_tick_(state, version, sync, reads, a, d, w,
                               artifact_tokens=cfg.artifact_tokens,
                               eager=cfg.strategy == acs.EAGER,
                               access_k=access_k,
                               signal_tokens=acs.SIGNAL_TOKENS)
        counters += cnt
        aw = a * w
        n_reads += torch.sum(a - aw, dim=1, dtype=_I32)
        n_writes += torch.sum(aw, dim=1, dtype=_I32)
        if content:
            _, ccnt = chunk_tick_(cv, cs, dirty, miss, aw, d,
                                  wchunks.to(_I32).contiguous(),
                                  artifact_tokens=cfg.artifact_tokens,
                                  chunk_tokens=cfg.chunk_tokens,
                                  signal_tokens=acs.SIGNAL_TOKENS)
            ccounters += ccnt

    fetch, signal, push = counters[:, 0], counters[:, 1], counters[:, 2]
    n_fetches, n_hits = counters[:, 3], counters[:, 4]
    untracked = torch.full((B,), -1, dtype=_I32, device=device)
    out = {
        "total_tokens": fetch + signal + push,
        "sync_tokens": fetch + signal,
        "fetch_tokens": fetch,
        "signal_tokens": signal,
        "push_tokens": push,
        "broadcast_tokens": zeros(B),
        "cache_hit_rate": n_hits.to(torch.float32)
        / torch.clamp(n_hits + n_fetches, min=1),
        "n_fetches": n_fetches,
        "n_writes": n_writes,
        "n_reads": n_reads,
        "max_staleness": untracked,
        "max_version_lag": untracked,
        "max_consumed_staleness": untracked,
    }
    if content:
        out["delta_bytes"] = ccounters[:, 0]
        out["full_bytes"] = ccounters[:, 1]
        out["n_chunks_fetched"] = ccounters[:, 2]
    return out


def _broadcast_content_fill(cfg: acs.ACSConfig, out: dict) -> dict:
    """Analytic bytes-on-wire of the broadcast baseline (content-plane
    grids only): every step injects every artifact into every agent,
    so delta and whole-artifact accounting coincide - ``n_steps * n *
    m * (|d| + signal)`` bytes, mirroring ``broadcast_tokens``."""
    per_ep = (cfg.n_steps * cfg.n_agents * cfg.n_artifacts
              * (cfg.artifact_tokens + acs.SIGNAL_TOKENS)
              * BYTES_PER_TOKEN)
    like = out["total_tokens"]
    out = dict(out)
    out["delta_bytes"] = torch.full_like(like, per_ep)
    out["full_bytes"] = torch.full_like(like, per_ep)
    out["n_chunks_fetched"] = torch.full_like(
        like, cfg.n_steps * cfg.n_agents * cfg.n_artifacts
        * acs.content_chunks(cfg))
    return out


def _queue(cfg: acs.ACSConfig, shard: _Shard, include_broadcast: bool,
           route: str, partitionable: bool) -> list:
    """Queue a shard's episodes on its placement; per variant
    (``[broadcast, coherent]`` or ``[coherent]``) a metrics dict of (B,)
    tensors.  Nothing here waits for the device."""
    with _on(shard.place):
        draws = _draw(cfg, shard, partitionable)
        outs = []
        if include_broadcast:
            # Broadcast has no content plane (bulk injection ships
            # everything) and no per-agent kernel: it always takes the
            # scan route, and its byte columns are filled analytically.
            bc_cfg = dataclasses.replace(cfg, strategy=acs.BROADCAST,
                                         chunk_tokens=0)
            bc = _episodes_scan(bc_cfg, _step_source(bc_cfg, draws), shard)
            if acs.content_enabled(cfg):
                bc = _broadcast_content_fill(cfg, bc)
            outs.append(bc)
        source = _step_source(cfg, draws)
        if route == "kernel":
            outs.append(_episodes_kernel(cfg, source, shard.keys.shape[0],
                                         shard.place[0]))
        else:
            outs.append(_episodes_scan(cfg, source, shard))
    return outs


def _read_back(shard: _Shard, outs: list) -> list:
    """A shard's outputs on the host: per variant, a dict of (its cells,
    its runs) numpy arrays."""
    with _on(shard.place):
        return [{k: v.cpu().numpy().reshape(shard.n_cells, shard.n_runs)
                 for k, v in out.items()} for out in outs]


def _run_grid(cfg: acs.ACSConfig, items: Sequence, cell_of, n_runs: int,
              include_broadcast: bool, tick_backend: Optional[str], device,
              partitionable: bool, devices: Optional[int]) -> list:
    """Per variant (``[broadcast, coherent]`` or ``[coherent]``), a dict
    of (len(items), n_runs) numpy arrays: the grid of ``items`` (cells
    made by ``cell_of(item, device)`` on each shard's device) under its
    ``shard_plan``.  Every shard's inputs are built, then every shard's
    episodes queued, then the outputs read back, joined on the sharded
    axis, and the padded runs cut.  Both variants consume the same
    draws, as both of the reference's do."""
    plan = shard_plan(len(items), n_runs, devices, device)
    route = resolve_tick_backend(cfg, tick_backend)
    if plan.axis == "workloads":
        per = len(items) // plan.devices
        blocks = [(items[i * per:(i + 1) * per], range(n_runs))
                  for i in range(plan.devices)]
    else:
        per = plan.pad_runs // plan.devices
        blocks = [(items, range(i * per, (i + 1) * per))
                  for i in range(plan.devices)]
    shards = [_shard_inputs(block, cell_of, runs, place)
              for (block, runs), place in zip(blocks,
                                              _placements(plan, device))]
    queued = [_queue(cfg, shard, include_broadcast, route, partitionable)
              for shard in shards]
    parts = [_read_back(shard, outs) for shard, outs in zip(shards, queued)]
    axis = 0 if plan.axis == "workloads" else 1
    return [{k: np.concatenate([part[v][k] for part in parts],
                               axis=axis)[:, :n_runs]
             for k in parts[0][v]} for v in range(len(parts[0]))]


# ---------------------------------------------------------------------------
# Host-side aggregation.


def _result_from(cell: dict, name: str, strategy_name: str,
                 n_runs: int) -> RunResult:
    total = np.asarray(cell["total_tokens"], dtype=np.float64)
    chr_ = np.asarray(cell["cache_hit_rate"], dtype=np.float64)
    stats = RunStats(
        name=name,
        strategy=strategy_name,
        n_runs=n_runs,
        total_tokens_mean=float(total.mean()),
        total_tokens_std=float(total.std()),
        sync_tokens_mean=float(np.mean(cell["sync_tokens"])),
        sync_tokens_std=float(np.std(np.asarray(
            cell["sync_tokens"], dtype=np.float64))),
        fetch_tokens_mean=float(np.mean(cell["fetch_tokens"])),
        signal_tokens_mean=float(np.mean(cell["signal_tokens"])),
        push_tokens_mean=float(np.mean(cell["push_tokens"])),
        broadcast_tokens_mean=float(np.mean(cell["broadcast_tokens"])),
        cache_hit_rate_mean=float(chr_.mean()),
        cache_hit_rate_std=float(chr_.std()),
        n_fetches_mean=float(np.mean(cell["n_fetches"])),
        n_writes_mean=float(np.mean(cell["n_writes"])),
        n_reads_mean=float(np.mean(cell["n_reads"])),
        max_staleness_max=int(np.max(cell["max_staleness"])),
        max_version_lag_max=int(np.max(cell["max_version_lag"])),
        max_consumed_staleness_max=int(
            np.max(cell["max_consumed_staleness"])),
        delta_bytes_mean=float(np.mean(cell["delta_bytes"]))
        if "delta_bytes" in cell else -1.0,
        full_bytes_mean=float(np.mean(cell["full_bytes"]))
        if "full_bytes" in cell else -1.0,
        n_chunks_fetched_mean=float(np.mean(cell["n_chunks_fetched"]))
        if "n_chunks_fetched" in cell else -1.0,
    )
    return RunResult(stats=stats, per_run_total_tokens=total,
                     per_run_chr=chr_)


def _cell(out: dict, v: int) -> dict:
    return {k: a[v] for k, a in out.items()}


def _comparison_of(name: str, volatility: float, bc: RunResult,
                   co: RunResult) -> Comparison:
    savings_runs = (1.0 - co.per_run_total_tokens
                    / bc.stats.total_tokens_mean)
    return Comparison(
        scenario=name,
        volatility=volatility,
        strategy=co.stats.strategy,
        broadcast=bc.stats,
        coherent=co.stats,
        savings_mean=float(savings_runs.mean()),
        savings_std=float(savings_runs.std()),
        crr=co.stats.total_tokens_mean / bc.stats.total_tokens_mean,
        chr_mean=co.stats.cache_hit_rate_mean,
        chr_std=co.stats.cache_hit_rate_std,
    )


def _static_key(cfg: acs.ACSConfig) -> acs.ACSConfig:
    """A config with its per-simulation inputs (volatility, activity,
    locality) blanked: configs with equal keys share one batch."""
    return dataclasses.replace(cfg, volatility=0.0, p_act=0.0,
                               write_locality=0.0)


def _grouped(items, n_runs_of, cfg_of) -> dict:
    groups: dict = {}
    for i, item in enumerate(items):
        groups.setdefault((_static_key(cfg_of(item)), n_runs_of(item)),
                          []).append(i)
    return groups


# ---------------------------------------------------------------------------
# Public API.  ``devices`` caps the shard count (default:
# ``resolve_sweep_devices``, one unsharded batch on ``device`` unless
# ``REPRO_SWEEP_DEVICES`` asks for more); per-run ledgers are equal at
# any count.


def run_scenario(scn: ScenarioConfig, tick_backend: Optional[str] = None,
                 device=None,
                 partitionable: bool = prng.PARTITIONABLE_DEFAULT,
                 devices: Optional[int] = None) -> RunResult:
    """Run ``scn.n_runs`` seeded episodes, sharded per ``shard_plan``."""
    dev = resolve_device(device)
    out = _run_grid(scn.acs, [scn], _scenario_cell, scn.n_runs, False,
                    tick_backend, dev, partitionable, devices)
    return _result_from(_cell(out[0], 0), scn.name,
                        acs.STRATEGY_NAMES[scn.acs.strategy], scn.n_runs)


def compare_grid(scns: Sequence[ScenarioConfig],
                 tick_backend: Optional[str] = None,
                 device=None,
                 partitionable: bool = prng.PARTITIONABLE_DEFAULT,
                 devices: Optional[int] = None) -> list[Comparison]:
    """Broadcast-vs-coherent for many scenarios.  Scenarios sharing a
    static configuration and a run count form one grid per variant,
    sharded under its own ``shard_plan``."""
    dev = resolve_device(device)
    results: list = [None] * len(scns)
    groups = _grouped(scns, lambda s: s.n_runs, lambda s: s.acs)
    for (_, n_runs), idxs in groups.items():
        sub = [scns[i] for i in idxs]
        cfg = sub[0].acs
        bc_out, co_out = _run_grid(cfg, sub, _scenario_cell, n_runs, True,
                                   tick_backend, dev, partitionable,
                                   devices)
        for j, i in enumerate(idxs):
            bc = _result_from(_cell(bc_out, j), sub[j].name,
                              acs.STRATEGY_NAMES[acs.BROADCAST], n_runs)
            co = _result_from(_cell(co_out, j), sub[j].name,
                              acs.STRATEGY_NAMES[cfg.strategy], n_runs)
            results[i] = _comparison_of(sub[j].name, sub[j].acs.volatility,
                                        bc, co)
    return results


def compare(scn: ScenarioConfig, strategy_code: Optional[int] = None,
            tick_backend: Optional[str] = None,
            device=None,
            partitionable: bool = prng.PARTITIONABLE_DEFAULT,
            devices: Optional[int] = None) -> Comparison:
    """Run broadcast + coherent variants of one scenario."""
    coh_scn = scn if strategy_code is None else scn.with_strategy(
        strategy_code)
    return compare_grid([coh_scn], tick_backend=tick_backend,
                        device=device, partitionable=partitionable,
                        devices=devices)[0]


def sweep_cells(base_scn: ScenarioConfig, volatilities,
                n_runs: Optional[int] = None) -> list[ScenarioConfig]:
    """The per-volatility scenario cells of a V-sweep (deterministic
    per-cell seeds derived from the base seed)."""
    runs = n_runs or base_scn.n_runs
    return [dataclasses.replace(
        base_scn,
        acs=dataclasses.replace(base_scn.acs, volatility=float(v)),
        n_runs=runs,
        seed=base_scn.seed + int(round(float(v) * 1000)))
        for v in volatilities]


def compare_workloads(workloads, tick_backend: Optional[str] = None,
                      device=None,
                      partitionable: bool = prng.PARTITIONABLE_DEFAULT,
                      devices: Optional[int] = None) -> list[Comparison]:
    """Broadcast-vs-coherent for heterogeneous workloads
    (``repro_torch.sim.workloads.Workload`` instances).  Workloads
    sharing a static configuration and a run count form one grid per
    variant - a whole zoo of families is one grid - sharded over runs,
    else over workloads."""
    dev = resolve_device(device)
    results: list = [None] * len(workloads)
    groups = _grouped(workloads, lambda w: w.n_runs, lambda w: w.acs)
    for (_, n_runs), idxs in groups.items():
        sub = [workloads[i] for i in idxs]
        cfg = sub[0].acs
        bc_out, co_out = _run_grid(cfg, sub, _workload_cell, n_runs, True,
                                   tick_backend, dev, partitionable,
                                   devices)
        for j, i in enumerate(idxs):
            bc = _result_from(_cell(bc_out, j), sub[j].name,
                              acs.STRATEGY_NAMES[acs.BROADCAST], n_runs)
            co = _result_from(_cell(co_out, j), sub[j].name,
                              acs.STRATEGY_NAMES[cfg.strategy], n_runs)
            results[i] = _comparison_of(
                sub[j].name, sub[j].effective_volatility(), bc, co)
    return results


def run_workload(w, tick_backend: Optional[str] = None, device=None,
                 partitionable: bool = prng.PARTITIONABLE_DEFAULT,
                 devices: Optional[int] = None) -> RunResult:
    """Run one heterogeneous workload (no baseline)."""
    dev = resolve_device(device)
    out = _run_grid(w.acs, [w], _workload_cell, w.n_runs, False,
                    tick_backend, dev, partitionable, devices)
    return _result_from(_cell(out[0], 0), w.name,
                        acs.STRATEGY_NAMES[w.acs.strategy], w.n_runs)


def sweep_volatility(base_scn: ScenarioConfig, volatilities,
                     n_runs: Optional[int] = None,
                     tick_backend: Optional[str] = None,
                     device=None,
                     partitionable: bool = prng.PARTITIONABLE_DEFAULT,
                     devices: Optional[int] = None) -> list[Comparison]:
    """V-sweep: every volatility cell of the sweep in one grid."""
    return compare_grid(sweep_cells(base_scn, volatilities, n_runs),
                        tick_backend=tick_backend, device=device,
                        partitionable=partitionable, devices=devices)
