"""Four-way differential conformance oracle (the port's legs).

The repo carries four independent executions of the CCS protocol:

  1. the message-level reference implementation
     (``repro_torch.core.protocol``: coordinator / event bus / agent
     caches);
  2. the batched PyTorch state machine (``repro_torch.core.acs``);
  3. the MESI tick kernel (``repro_torch.kernels.mesi_transition``),
     launched on the card for CUDA tensors;
  4. the model checker's transition relation
     (``repro_torch.core.model_check.successors``).

This module samples ONE action trace from a (possibly heterogeneous)
workload - using the exact PRNG key schedule of the sweep engine, so
the trace is precisely what ``run_episode`` executes - and replays it
through all four, asserting **bit-exact token-ledger and final
MESI-state agreement**.  It is the twin of ``repro.sim.oracle``: the
legs are the same, and the kernel leg is called ``kernel`` where the
JAX package says ``pallas``.  The tensor legs run on ``device``
(``None``: CUDA); the protocol and model-check legs are host Python.

Scope notes:

  * The differential strategies are the invalidation family
    (lazy / eager / access_count) - broadcast and TTL are bulk-inject
    paths with no per-agent transition to diff.
  * The model-checker leg covers LAZY only: the spec has no push
    (eager) or expiry-refetch-from-valid (access_count) action.  It
    verifies the trace is a *path* of the transition relation and that
    the final abstract state agrees, under the abstraction
    ``M -> S`` for the committed writer (the spec's Write leaves the
    writer in M; the executable protocol commits the writer back to S,
    paper SS5.3).
  * The kernel tracks token counters, not the staleness diagnostics;
    its ledger comparison covers every counter the kernel emits
    (fetch/signal/push tokens, fetches, hits, invalidations).

Beyond the four token-ledger legs, :func:`check_content_trace` is the
**byte-exact** leg for the chunk-granular content plane
(``repro_torch.content``): the same trace replays through the chunked
ACS, the MESI tick chased by the chunk tick, a real-payload
content-addressed chunk store (asserting every patched reader copy
reassembles to the authority artifact), and the whole-artifact
protocol baseline - bit-identical byte ledgers, ``delta <= full`` per
fill.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import acs, model_check as mc, prng
from repro_torch.core.protocol import (AgentRuntime, ArtifactStore,
                                       CoordinatorService, EventBus)
from repro_torch.core.states import MESIState
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.chunk_diff import chunk_tick_
from repro_torch.kernels.mesi_transition import mesi_tick_

_I, _S, _E, _M = (int(MESIState.I), int(MESIState.S),
                  int(MESIState.E), int(MESIState.M))

#: strategies the differential harness covers (see module docstring).
DIFFERENTIAL_STRATEGIES = (acs.LAZY, acs.EAGER, acs.ACCESS_COUNT)


class ConformanceError(AssertionError):
    """Two implementations of the protocol disagreed on a trace."""


@dataclasses.dataclass(frozen=True)
class Trace:
    """One sampled episode of actions, (n_steps, n_agents) arrays.

    ``write_chunks`` is the content plane's per-write dirty chunk mask
    ((n_steps, n_agents, C) bool; ``None`` for whole-artifact traces):
    engine traces sample it from the write-locality span distribution,
    service traces record the *measured* content diff of each commit.
    """

    acts: np.ndarray    # bool: agent a acted at step s
    arts: np.ndarray    # int32: artifact chosen
    writes: np.ndarray  # bool: action was a write
    write_chunks: np.ndarray | None = None

    @property
    def n_actions(self) -> int:
        return int(self.acts.sum())


@dataclasses.dataclass(frozen=True)
class Ledger:
    """Implementation-neutral token ledger (all exact integers)."""

    fetch_tokens: int
    signal_tokens: int
    push_tokens: int
    n_fetches: int
    n_hits: int
    n_reads: int
    n_writes: int
    n_invalidation_signals: int

    @property
    def total_tokens(self) -> int:
        return self.fetch_tokens + self.signal_tokens + self.push_tokens


@dataclasses.dataclass(frozen=True)
class DiffReport:
    """Agreed-upon results of a conformance run (post-assertion)."""

    workload: str
    strategy: str
    trace: Trace
    ledger: Ledger
    state: np.ndarray      # (n, m) final MESI states
    version: np.ndarray    # (m,) final canonical versions
    last_sync: np.ndarray  # (n, m) version at last fill/commit
    implementations: tuple


# ---------------------------------------------------------------------------
# Trace sampling - the engine's exact action stream.


def episode_key(seed: int, run: int = 0, device=None) -> torch.Tensor:
    """The engine's per-run key: ``fold_in(PRNGKey(seed), run)``
    (``acs.run_keys``), so replays target a specific grid cell."""
    return prng.fold_in(prng.prng_key(int(seed), resolve_device(device)),
                        int(run))


def sample_trace(cfg: acs.ACSConfig, key: torch.Tensor,
                 rates: acs.RateMatrices | None = None,
                 locality: float | None = None, *,
                 partitionable: bool = prng.PARTITIONABLE_DEFAULT
                 ) -> Trace:
    """Sample the action stream ``run_episode(cfg, key[None],
    rates=rates)`` executes, via the shared ``acs.draw_actions`` sampler
    and the same per-step key split.  With the content plane enabled the
    per-step write spans are sampled too (``acs.draw_write_chunks``,
    same fold-in key schedule the engine uses), so the trace pins byte
    ledgers as exactly as it pins token ledgers.  ``partitionable``
    picks the threefry mode, as in ``repro_torch.core.prng``."""
    keys = prng.split(key, cfg.n_steps, partitionable)      # (S, 2)
    acts, arts, writes = acs.draw_actions(
        keys, cfg.n_agents, cfg.n_artifacts, cfg.volatility, cfg.p_act,
        rates, partitionable=partitionable)
    write_chunks = None
    if acs.content_enabled(cfg):
        loc = cfg.write_locality if locality is None else locality
        write_chunks = acs.draw_write_chunks(
            keys, cfg.n_agents, acs.content_chunks(cfg), loc,
            partitionable=partitionable).cpu().numpy()
    return Trace(acts=acts.cpu().numpy().astype(bool),
                 arts=arts.cpu().numpy().astype(np.int32),
                 writes=writes.cpu().numpy().astype(bool),
                 write_chunks=write_chunks)


def _actions(trace: Trace):
    """Serialized (step, agent, artifact, is_write) stream - authority
    order: steps ascending, agents ascending within a step (the agent
    loop order of ``acs.apply_actions``)."""
    n_steps, n_agents = trace.acts.shape
    for s in range(n_steps):
        for a in range(n_agents):
            if trace.acts[s, a]:
                yield s, a, int(trace.arts[s, a]), bool(trace.writes[s, a])


# ---------------------------------------------------------------------------
# Leg 1: message-level protocol.


def replay_protocol(cfg: acs.ACSConfig, trace: Trace):
    """Replay through coordinator / event bus / agent runtimes."""
    strategy = acs.STRATEGY_NAMES[cfg.strategy]
    bus = EventBus()
    store = ArtifactStore()
    coord = CoordinatorService(bus, store, strategy=strategy)
    for d in range(cfg.n_artifacts):
        coord.register_artifact(f"artifact-{d}",
                                list(range(cfg.artifact_tokens)))
    agents = [AgentRuntime(f"agent-{a}", coord, bus, strategy=strategy,
                           access_k=cfg.access_k,
                           max_stale_steps=cfg.max_stale_steps)
              for a in range(cfg.n_agents)]
    for s, a, d, is_write in _actions(trace):
        if is_write:
            agents[a].write(f"artifact-{d}", [s] * cfg.artifact_tokens)
        else:
            agents[a].read(f"artifact-{d}")

    led = coord.ledger
    ledger = Ledger(
        fetch_tokens=led.fetch_tokens, signal_tokens=led.signal_tokens,
        push_tokens=led.push_tokens, n_fetches=led.n_fetches,
        n_hits=led.n_hits, n_reads=led.n_reads, n_writes=led.n_writes,
        n_invalidation_signals=led.n_invalidation_signals)
    state = np.array([[int(ag.state_of(f"artifact-{d}"))
                       for d in range(cfg.n_artifacts)] for ag in agents],
                     np.int32)
    # the authority directory must mirror the agent-side cache states
    # (immediate bus delivery); a divergence is a protocol bug.
    dir_state = np.array(
        [[int(coord.agent_state(f"agent-{a}", f"artifact-{d}"))
          for d in range(cfg.n_artifacts)] for a in range(cfg.n_agents)],
        np.int32)
    if not np.array_equal(state, dir_state):
        raise ConformanceError(
            "protocol authority directory diverged from agent caches:\n"
            f"agents:\n{state}\ndirectory:\n{dir_state}")
    version = np.array([coord.directory[f"artifact-{d}"].version
                        for d in range(cfg.n_artifacts)], np.int32)
    sync = np.zeros((cfg.n_agents, cfg.n_artifacts), np.int32)
    for a, ag in enumerate(agents):
        for d in range(cfg.n_artifacts):
            entry = ag.cache.get(f"artifact-{d}")
            if entry is not None:
                sync[a, d] = entry.version
    return ledger, state, version, sync


# ---------------------------------------------------------------------------
# Leg 2: the batched PyTorch state machine, one action at a time.


def _slots(cfg: acs.ACSConfig, trace: Trace, device):
    """Replay ``trace`` through ``acs.apply_slot_`` on one simulation,
    one action at a time; yields ``(s, a, d, arrays, met)`` before each
    action, then ``(None, None, None, arrays, met)`` after the last."""
    dev = resolve_device(device)
    content = acs.content_enabled(cfg)
    arrays = acs.init_arrays(cfg, 1, dev)
    met = acs.init_metrics(1, dev)
    bidx = torch.zeros(1, dtype=torch.long, device=dev)
    act = torch.ones(1, dtype=torch.bool, device=dev)
    arts = torch.as_tensor(trace.arts, dtype=torch.long, device=dev)
    writes = torch.as_tensor(trace.writes, device=dev)
    wchunks = (torch.as_tensor(trace.write_chunks, device=dev)
               if content else None)
    for s, a, d, _ in _actions(trace):
        yield s, a, d, arrays, met
        met, _, _ = acs.apply_slot_(
            cfg, arrays, met, bidx, a, act, arts[s, a:a + 1],
            writes[s, a:a + 1], wchunks[s, a:a + 1] if content else None)
    yield None, None, None, arrays, met


def _ledger(met: acs.ACSMetrics) -> Ledger:
    values = torch.cat([getattr(met, f.name)
                        for f in dataclasses.fields(Ledger)]).tolist()
    return Ledger(*values)


def replay_vectorized(cfg: acs.ACSConfig, trace: Trace, device=None):
    """Replay through the ACS's own per-agent slot
    (``acs.apply_slot_``), one action at a time on ``device``."""
    for *_, arrays, met in _slots(cfg, trace, device):
        pass
    return (_ledger(met), arrays.state[0].cpu().numpy(),
            arrays.version[0].cpu().numpy(),
            arrays.last_sync[0].cpu().numpy())


# ---------------------------------------------------------------------------
# Leg 3: the MESI tick kernel (batch of one simulation).


def _step_inputs(trace: Trace, dev):
    """The trace as (S, 1, n) int32 act / artifact / write tensors."""
    return [torch.as_tensor(x[:, None].astype(np.int32), device=dev)
            for x in (trace.acts, trace.arts, trace.writes)]


def replay_kernel(cfg: acs.ACSConfig, trace: Trace, device=None):
    """Replay through ``mesi_tick_``, one launch a step on ``device``
    (the kernel for CUDA, its plain version on the CPU)."""
    if cfg.strategy not in DIFFERENTIAL_STRATEGIES:
        raise ValueError("kernel leg covers the invalidation strategies")
    dev = resolve_device(device)
    arrays = acs.init_arrays(dataclasses.replace(cfg, chunk_tokens=0),
                             1, dev)
    counters = torch.zeros(8, dtype=torch.int64, device=dev)
    acts, arts, writes = _step_inputs(trace, dev)
    for s in range(trace.acts.shape[0]):
        cnt, _ = mesi_tick_(
            arrays.state, arrays.version, arrays.last_sync,
            arrays.reads_since_fetch, acts[s], arts[s], writes[s],
            artifact_tokens=cfg.artifact_tokens,
            eager=cfg.strategy == acs.EAGER,
            access_k=(cfg.access_k
                      if cfg.strategy == acs.ACCESS_COUNT else 0),
            signal_tokens=acs.SIGNAL_TOKENS)
        counters += cnt[0]
    c = counters.tolist()
    ledger = Ledger(
        fetch_tokens=c[0], signal_tokens=c[1], push_tokens=c[2],
        n_fetches=c[3], n_hits=c[4],
        n_reads=int((trace.acts & ~trace.writes).sum()),
        n_writes=int((trace.acts & trace.writes).sum()),
        n_invalidation_signals=c[5])
    return (ledger, arrays.state[0].cpu().numpy(),
            arrays.version[0].cpu().numpy(),
            arrays.last_sync[0].cpu().numpy())


# ---------------------------------------------------------------------------
# Leg 4: model-checker transition relation (abstract, per-artifact).


#: exploration caps large enough that replay guards never bind.
_UNCAPPED = 1 << 28


def replay_model_check(cfg: acs.ACSConfig, trace: Trace):
    """Drive ``model_check.successors`` with the trace's micro-actions.

    Each artifact runs an independent instance of the single-artifact
    spec (artifacts never interact; the sharded-directory argument).
    An ACS read decomposes into ``[Fetch] Read``; an ACS write into
    ``[Fetch] [Upgrade] Write`` (Fetch iff Invalid, Upgrade iff Shared
    - a committed writer is the spec's M owner and writes directly).
    Every micro-action must be *enabled* in the spec's Next relation at
    the current state, so the whole trace is a path of the model the
    paper model-checked.  Invariants are asserted on every visited
    state.
    """
    if cfg.strategy != acs.LAZY:
        raise ValueError("model-check leg covers LAZY only")
    n, m = cfg.n_agents, cfg.n_artifacts
    mc_cfg = mc.CheckConfig(n_agents=n, max_stale_steps=_UNCAPPED,
                            max_version=_UNCAPPED, max_steps=_UNCAPPED)
    # ACS cold start: all Invalid at version 1, never synced.
    states = [(1, (mc.I,) * n, (0,) * n, (0,) * n) for _ in range(m)]

    def apply(d: int, label: str) -> None:
        succ = dict(mc.successors(mc_cfg, states[d]))
        if label not in succ:
            raise ConformanceError(
                f"micro-action {label} not enabled at model state "
                f"{states[d]} (artifact {d}); enabled: {sorted(succ)}")
        states[d] = succ[label]
        if not mc.inv_single_writer(mc_cfg, states[d]):
            raise ConformanceError(
                f"SWMR violated at model state {states[d]}")

    for _, a, d, is_write in _actions(trace):
        if states[d][1][a] == mc.I:
            apply(d, f"Fetch({a})")
        if is_write:
            if states[d][1][a] == mc.S:
                apply(d, f"Upgrade({a})")
            apply(d, f"Write({a})")
        else:
            apply(d, f"Read({a})")

    # Abstraction map: the spec's Write leaves the committed writer in
    # M; the executable protocol downgrades it to S on commit (SS5.3).
    # E never persists (Upgrade is always immediately followed by
    # Write in the decomposition above).
    state = np.empty((n, m), np.int32)
    version = np.empty(m, np.int32)
    sync = np.empty((n, m), np.int32)
    for d in range(m):
        ver, sts, _steps, syn = states[d]
        version[d] = ver
        for a in range(n):
            if sts[a] == _E:
                raise ConformanceError(
                    f"Exclusive state persisted at artifact {d}")
            state[a, d] = _S if sts[a] in (_S, _M) else _I
            sync[a, d] = syn[a]
    return state, version, sync


# ---------------------------------------------------------------------------
# The four-way check.


def _expect(label: str, got, want, context: str) -> None:
    if isinstance(got, np.ndarray) or isinstance(want, np.ndarray):
        equal = np.array_equal(np.asarray(got), np.asarray(want))
    else:
        equal = got == want
    if not equal:
        raise ConformanceError(
            f"{context}: {label} mismatch\n  got:  {got}\n  want: {want}")


def check_trace(cfg: acs.ACSConfig, trace: Trace, *,
                name: str = "trace", context: str | None = None,
                device=None) -> DiffReport:
    """Replay a *given* action trace through every implementation and
    assert bit-exact agreement.

    This is the trace-level core of :func:`differential_check`, exposed
    so traces captured from the **live coherence service**
    (``repro_torch.service.trace``) replay through the identical
    four-way harness - the trace need not come from the engine's PRNG
    schedule.  ``cfg.n_steps`` must equal ``trace.acts.shape[0]``.  The
    tensor legs run on ``device``.  Returns the agreed-upon
    :class:`DiffReport`; raises :class:`ConformanceError` on any
    divergence.
    """
    if cfg.strategy not in DIFFERENTIAL_STRATEGIES:
        raise ValueError(
            f"differential harness covers "
            f"{[acs.STRATEGY_NAMES[s] for s in DIFFERENTIAL_STRATEGIES]},"
            f" got {acs.STRATEGY_NAMES[cfg.strategy]}")
    if cfg.max_stale_steps > 0:
        raise ValueError("K-staleness revalidation is scan-path only; "
                         "run the differential check with "
                         "max_stale_steps=0")
    if trace.acts.shape != (cfg.n_steps, cfg.n_agents):
        raise ValueError(
            f"trace shape {trace.acts.shape} does not match config "
            f"({cfg.n_steps} steps x {cfg.n_agents} agents)")
    ctx = context or f"trace {name!r}"

    led_vec, st_vec, ver_vec, sync_vec = replay_vectorized(cfg, trace,
                                                           device)
    led_pro, st_pro, ver_pro, sync_pro = replay_protocol(cfg, trace)
    led_ker, st_ker, ver_ker, sync_ker = replay_kernel(cfg, trace, device)

    for field in dataclasses.fields(Ledger):
        _expect(f"ledger.{field.name} (protocol vs vectorized)",
                getattr(led_pro, field.name),
                getattr(led_vec, field.name), ctx)
        _expect(f"ledger.{field.name} (kernel vs vectorized)",
                getattr(led_ker, field.name),
                getattr(led_vec, field.name), ctx)
    _expect("state (protocol vs vectorized)", st_pro, st_vec, ctx)
    _expect("state (kernel vs vectorized)", st_ker, st_vec, ctx)
    _expect("version (protocol vs vectorized)", ver_pro, ver_vec, ctx)
    _expect("version (kernel vs vectorized)", ver_ker, ver_vec, ctx)
    _expect("last_sync (kernel vs vectorized)", sync_ker, sync_vec, ctx)
    # protocol caches only materialize entries on first touch and keep
    # the committed version on them; compare where an entry is valid.
    valid = st_vec != _I
    _expect("last_sync on valid entries (protocol vs vectorized)",
            sync_pro[valid], sync_vec[valid], ctx)

    implementations = ["protocol", "vectorized", "kernel"]
    if cfg.strategy == acs.LAZY:
        st_mc, ver_mc, sync_mc = replay_model_check(cfg, trace)
        _expect("state (model-check vs vectorized)", st_mc, st_vec, ctx)
        _expect("version (model-check vs vectorized)", ver_mc, ver_vec,
                ctx)
        _expect("last_sync (model-check vs vectorized)", sync_mc,
                sync_vec, ctx)
        implementations.append("model_check")

    return DiffReport(
        workload=name,
        strategy=acs.STRATEGY_NAMES[cfg.strategy],
        trace=trace, ledger=led_vec, state=st_vec, version=ver_vec,
        last_sync=sync_vec, implementations=tuple(implementations))


# ---------------------------------------------------------------------------
# Cross-shard conformance leg: the sharded authority plane partitions
# the directory BY ARTIFACT, so every shard's committed history is the
# global history restricted to its own columns.


def shard_subtrace(trace: Trace, artifact_shards, shard: int):
    """Project a global trace onto one authority shard.

    Returns ``(sub_trace, cols)`` where ``cols`` are the global
    artifact indices owned by ``shard`` and ``sub_trace`` keeps only
    the actions on those artifacts (artifact indices remapped to the
    shard-local ``0..len(cols)-1`` range, steps with no action on this
    shard dropped).  Because exclusivity, versions and sync are all
    per-artifact, this projection is exactly the history the shard's
    local authority executed.
    """
    shards = np.asarray(artifact_shards, np.int32)
    cols = np.flatnonzero(shards == shard)
    lut = np.zeros(shards.size, np.int32)
    lut[cols] = np.arange(cols.size, dtype=np.int32)
    sel = trace.acts & np.isin(trace.arts, cols)
    keep = np.flatnonzero(sel.any(axis=1))
    acts = sel[keep]
    arts = np.where(acts, lut[trace.arts[keep]], 0).astype(np.int32)
    writes = trace.writes[keep] & acts
    write_chunks = None
    if trace.write_chunks is not None:
        write_chunks = trace.write_chunks[keep] & writes[:, :, None]
    return Trace(acts=acts, arts=arts, writes=writes,
                 write_chunks=write_chunks), cols


def check_sharded_trace(cfg: acs.ACSConfig, trace: Trace,
                        artifact_shards, *, name: str = "sharded",
                        context: str | None = None,
                        device=None) -> DiffReport:
    """Conformance harness for the sharded authority plane.

    Two legs, both bit-exact:

    1. **Global serializability** - the interleaved per-shard batch
       stream replays through the full four-way harness
       (:func:`check_trace`) as if ONE authority had committed it.
    2. **Cross-shard decomposition** - each shard's projected
       sub-trace (:func:`shard_subtrace`) replays through the ACS
       *independently*; its directory columns, versions and last_sync
       must equal the global replay restricted to that shard's
       artifacts, and the per-shard ledgers must SUM to the global
       ledger.  Together these prove sharding the authority by
       artifact changed nothing observable: SWMR, monotonic versions
       and the token charges survive the partition.
    """
    shards = np.asarray(artifact_shards, np.int32)
    if shards.shape != (cfg.n_artifacts,):
        raise ValueError(
            f"artifact_shards has shape {shards.shape}; expected one "
            f"shard id per artifact ({cfg.n_artifacts},)")
    ctx = context or f"sharded trace {name!r}"
    report = check_trace(cfg, trace, name=name, context=ctx, device=device)
    sums = {f.name: 0 for f in dataclasses.fields(Ledger)}
    for shard in range(int(shards.max()) + 1 if shards.size else 1):
        sub, cols = shard_subtrace(trace, shards, shard)
        if cols.size == 0:
            continue
        sub_cfg = dataclasses.replace(
            cfg, n_artifacts=int(cols.size),
            n_steps=max(sub.acts.shape[0], 1))
        led, st, ver, sync = replay_vectorized(sub_cfg, sub, device)
        for f in sums:
            sums[f] += getattr(led, f)
        sctx = f"{ctx} [shard {shard}]"
        _expect("state (shard-local vs global columns)", st,
                report.state[:, cols], sctx)
        _expect("version (shard-local vs global columns)", ver,
                report.version[cols], sctx)
        _expect("last_sync (shard-local vs global columns)", sync,
                report.last_sync[:, cols], sctx)
    for f in sums:
        _expect(f"ledger.{f} (sum over shards vs global)", sums[f],
                getattr(report.ledger, f), ctx)
    return report


# ---------------------------------------------------------------------------
# Content plane: byte-exact differential harness (chunk-granular delta
# coherence, ``repro_torch.content``).


@dataclasses.dataclass(frozen=True)
class ByteLedger:
    """Bytes-on-wire ledger of the chunk content plane (exact ints)."""

    delta_bytes: int        # shipped under delta coherence
    full_bytes: int         # what whole-artifact lazy ships, same fills
    n_chunks_fetched: int

    @property
    def savings_vs_full(self) -> float:
        return 1.0 - self.delta_bytes / max(self.full_bytes, 1)


@dataclasses.dataclass(frozen=True)
class FillEvent:
    """One coherence fill as the content plane served it."""

    step: int
    agent: int
    artifact: int
    fetched: np.ndarray      # (C,) bool chunks shipped
    sync_before: np.ndarray  # (C,) reader chunk vector before the fill
    dirty: np.ndarray        # (C,) dirty bitmap at fill time
    delta_inc: int           # bytes this fill shipped
    full_inc: int            # bytes whole-artifact lazy would ship


@dataclasses.dataclass(frozen=True)
class ContentReport:
    """Agreed-upon content-plane results (post-assertion)."""

    workload: str
    strategy: str
    trace: Trace
    ledger: ByteLedger
    chunk_version: np.ndarray  # (m, C)
    chunk_sync: np.ndarray     # (n, m, C)
    chunk_dirty: np.ndarray    # (m, C)
    fills: tuple               # FillEvent per coherence fill
    implementations: tuple


def _content_cfg_check(cfg: acs.ACSConfig) -> None:
    if not acs.content_enabled(cfg):
        raise ValueError("content harness needs cfg.chunk_tokens > 0")
    if cfg.strategy not in acs.CONTENT_STRATEGIES:
        raise ValueError(
            f"content plane covers "
            f"{[acs.STRATEGY_NAMES[s] for s in acs.CONTENT_STRATEGIES]},"
            f" got {acs.STRATEGY_NAMES[cfg.strategy]}")
    if cfg.max_stale_steps > 0:
        raise ValueError("content harness runs with max_stale_steps=0")


def replay_content_vectorized(cfg: acs.ACSConfig, trace: Trace,
                              device=None):
    """Replay of the content plane through the ACS's own per-agent slot
    (``acs.apply_slot_``), one action at a time on ``device``.

    Returns ``(ByteLedger, chunk_version, chunk_sync, chunk_dirty,
    fills)`` where ``fills`` carries per-fill byte increments and the
    dirty bitmap snapshot (the delta-subset-of-dirty property surface).
    """
    _content_cfg_check(cfg)
    C = acs.content_chunks(cfg)
    snaps = []   # (s, a, d, host snapshot before the action)
    for s, a, d, arrays, met in _slots(cfg, trace, device):
        # one read-back an action: the chunk rows the action reads and
        # the byte counters before it (after it = before the next)
        rows = ([] if s is None else [arrays.chunk_version[0, d],
                                      arrays.chunk_sync[0, a, d],
                                      arrays.chunk_dirty[0, d]])
        snaps.append((s, a, d, torch.cat(rows + [
            met.n_fetches, met.delta_bytes, met.full_bytes,
            met.n_chunks_fetched]).cpu().numpy()))
    fills = []
    for (s, a, d, snap), (*_, after) in zip(snaps, snaps[1:]):
        ver_b, sync_b, dirty_b = snap[:C], snap[C:2 * C], snap[2 * C:3 * C]
        before, after = snap[-4:], after[-4:]
        if after[0] > before[0]:
            fills.append(FillEvent(
                step=s, agent=a, artifact=d,
                fetched=ver_b > sync_b,
                sync_before=sync_b, dirty=dirty_b.astype(bool),
                delta_inc=int(after[1]) - int(before[1]),
                full_inc=int(after[2]) - int(before[2])))
    final = snaps[-1][3]
    ledger = ByteLedger(delta_bytes=int(final[1]),
                        full_bytes=int(final[2]),
                        n_chunks_fetched=int(final[3]))
    return (ledger, arrays.chunk_version[0].cpu().numpy(),
            arrays.chunk_sync[0].cpu().numpy(),
            arrays.chunk_dirty[0].cpu().numpy(), tuple(fills))


def replay_content_kernel(cfg: acs.ACSConfig, trace: Trace, device=None):
    """Replay through the kernel route: ``mesi_tick_`` (per-agent miss
    output) chased by ``chunk_tick_``, batch of one simulation, one
    launch of each a step on ``device``."""
    _content_cfg_check(cfg)
    dev = resolve_device(device)
    arrays = acs.init_arrays(cfg, 1, dev)
    counters = torch.zeros(4, dtype=torch.int64, device=dev)
    acts, arts, writes = _step_inputs(trace, dev)
    wchunks = torch.as_tensor(trace.write_chunks[:, None].astype(np.int32),
                              device=dev)
    for s in range(trace.acts.shape[0]):
        _, miss = mesi_tick_(
            arrays.state, arrays.version, arrays.last_sync,
            arrays.reads_since_fetch, acts[s], arts[s], writes[s],
            artifact_tokens=cfg.artifact_tokens,
            access_k=(cfg.access_k
                      if cfg.strategy == acs.ACCESS_COUNT else 0),
            signal_tokens=acs.SIGNAL_TOKENS)
        _, ccnt = chunk_tick_(
            arrays.chunk_version, arrays.chunk_sync, arrays.chunk_dirty,
            miss, acts[s] * writes[s], arts[s], wchunks[s],
            artifact_tokens=cfg.artifact_tokens,
            chunk_tokens=cfg.chunk_tokens,
            signal_tokens=acs.SIGNAL_TOKENS)
        counters += ccnt[0]
    c = counters.tolist()
    ledger = ByteLedger(delta_bytes=c[0], full_bytes=c[1],
                        n_chunks_fetched=c[2])
    return (ledger, arrays.chunk_version[0].cpu().numpy(),
            arrays.chunk_sync[0].cpu().numpy(),
            arrays.chunk_dirty[0].cpu().numpy())


def replay_content_store(cfg: acs.ACSConfig, trace: Trace, fills):
    """Message-level content leg with REAL payloads: a content-addressed
    :class:`repro_torch.content.ChunkStore` over the canonical
    ``ArtifactStore``, per-reader chunk caches patched by shipped
    deltas.

    ``fills`` is the serialized miss sequence (from
    :func:`replay_content_vectorized`) - this leg does not re-decide
    MESI, it *serves content* for the decided fills and proves the
    bytes the vectorized ledger charged are exactly the bytes real
    chunks occupy, and that every patched reader copy reassembles to
    the authority artifact byte-for-byte.

    Returns ``(ByteLedger, n_reassembly_checks)``.
    """
    from repro_torch.content.chunks import (BYTES_PER_TOKEN, ChunkStore,
                                            reassemble)
    _content_cfg_check(cfg)
    n, m, C = cfg.n_agents, cfg.n_artifacts, acs.content_chunks(cfg)
    store = ArtifactStore()
    chunks = ChunkStore(store, cfg.chunk_tokens)
    for d in range(m):
        store.put(f"artifact-{d}",
                  [(d * 1009 + i) % 65521 for i in
                   range(cfg.artifact_tokens)])
        chunks.register(f"artifact-{d}")
    cv = np.ones((m, C), np.int64)
    cs = np.zeros((n, m, C), np.int64)
    reader = {}   # (a, d) -> list of chunk payloads (stale allowed)
    fill_iter = iter(fills)
    next_fill = next(fill_iter, None)
    delta_bytes = full_bytes = n_chunks_fetched = 0
    n_checks = 0
    write_counter = 0
    for s, a, d, is_write in _actions(trace):
        name = f"artifact-{d}"
        is_miss = (next_fill is not None and next_fill.step == s
                   and next_fill.agent == a)
        if is_miss:
            stale = np.flatnonzero(cv[d] > cs[a, d])
            payload = chunks.delta(name, stale)
            base = reader.get((a, d))
            if base is None:
                base = [None] * C
            for idx, chunk in payload:
                base[idx] = chunk
            reader[(a, d)] = base
            shipped = sum(len(chunk) for _, chunk in payload)
            delta_bytes += (shipped + acs.SIGNAL_TOKENS) * BYTES_PER_TOKEN
            full_bytes += (cfg.artifact_tokens
                           + acs.SIGNAL_TOKENS) * BYTES_PER_TOKEN
            n_chunks_fetched += len(stale)
            cs[a, d] = cv[d]
            got = reassemble(base)
            want = tuple(store.get(name))
            if got != want:
                raise ConformanceError(
                    f"reassembled copy of {name} at agent {a} (step {s})"
                    f" diverged from the authority artifact")
            n_checks += 1
            next_fill = next(fill_iter, None)
        if is_write:
            span = np.flatnonzero(trace.write_chunks[s, a])
            new_content = list(store.get(name))
            write_counter += 1
            ct = cfg.chunk_tokens
            for c in span:
                lo = c * ct
                hi = min(lo + ct, cfg.artifact_tokens)
                for i in range(lo, hi):
                    # unique value per commit: every spanned chunk's
                    # digest is guaranteed to move
                    new_content[i] = 100000 + write_counter
            measured = chunks.put(name, new_content)
            if not np.array_equal(np.flatnonzero(measured), span):
                raise ConformanceError(
                    f"measured content diff {np.flatnonzero(measured)} "
                    f"!= sampled span {span} (step {s}, agent {a})")
            cv[d][span] += 1
            reader[(a, d)] = [chunks.chunk(name, i) for i in range(C)]
            cs[a, d] = cv[d]
    ledger = ByteLedger(delta_bytes=delta_bytes, full_bytes=full_bytes,
                        n_chunks_fetched=n_chunks_fetched)
    return ledger, n_checks


def check_content_trace(cfg: acs.ACSConfig, trace: Trace, *,
                        name: str = "trace",
                        context: str | None = None,
                        device=None) -> ContentReport:
    """Byte-exact differential leg of the oracle.

    Replays one (possibly service-captured) trace through the chunked
    ACS, the kernel route, the real-payload chunk store, and the
    message-level whole-artifact baseline, asserting:

      * bit-identical byte ledgers and chunk state across the ACS and
        the kernel route;
      * the real-payload leg charges exactly the same bytes and every
        patched reader copy reassembles to the authority artifact;
      * the whole-artifact baseline (the message-level protocol's
        token ledger, in bytes) equals the ``full_bytes`` column - so
        ``delta <= full`` is measured against the actual baseline;
      * ``delta_inc <= full_inc`` for every individual fill.
    """
    from repro_torch.content.chunks import BYTES_PER_TOKEN
    _content_cfg_check(cfg)
    if trace.write_chunks is None:
        raise ValueError("content check needs trace.write_chunks")
    ctx = context or f"content trace {name!r}"

    led_vec, cv_vec, cs_vec, dirty_vec, fills = \
        replay_content_vectorized(cfg, trace, device)
    led_ker, cv_ker, cs_ker, dirty_ker = replay_content_kernel(cfg, trace,
                                                               device)

    for field in dataclasses.fields(ByteLedger):
        _expect(f"byte ledger.{field.name} (kernel vs vectorized)",
                getattr(led_ker, field.name),
                getattr(led_vec, field.name), ctx)
    _expect("chunk_version (kernel vs vectorized)", cv_ker, cv_vec, ctx)
    _expect("chunk_sync (kernel vs vectorized)", cs_ker, cs_vec, ctx)
    _expect("chunk_dirty (kernel vs vectorized)", dirty_ker, dirty_vec,
            ctx)

    led_store, n_checks = replay_content_store(cfg, trace, fills)
    for field in dataclasses.fields(ByteLedger):
        _expect(f"byte ledger.{field.name} (chunk store vs vectorized)",
                getattr(led_store, field.name),
                getattr(led_vec, field.name), ctx)

    # whole-artifact baseline: the message-level protocol's fetch
    # ledger, converted to wire bytes, IS the full_bytes column.
    led_pro, _, _, _ = replay_protocol(cfg, trace)
    _expect("full_bytes vs whole-artifact protocol fetch bytes",
            led_vec.full_bytes,
            led_pro.fetch_tokens * BYTES_PER_TOKEN, ctx)

    for f in fills:
        if f.delta_inc > f.full_inc:
            raise ConformanceError(
                f"{ctx}: fill (step {f.step}, agent {f.agent}, artifact"
                f" {f.artifact}) shipped {f.delta_inc} delta bytes > "
                f"{f.full_inc} whole-artifact bytes")
    if led_vec.delta_bytes > led_vec.full_bytes:
        raise ConformanceError(
            f"{ctx}: total delta {led_vec.delta_bytes} > full "
            f"{led_vec.full_bytes}")

    return ContentReport(
        workload=name, strategy=acs.STRATEGY_NAMES[cfg.strategy],
        trace=trace, ledger=led_vec, chunk_version=cv_vec,
        chunk_sync=cs_vec, chunk_dirty=dirty_vec, fills=fills,
        implementations=("vectorized", "kernel", "chunk_store",
                         "protocol_baseline"))


def _episode_metrics(workload, run: int, device, partitionable: bool,
                     locality=None):
    """The sampled trace of ``workload``'s grid cell ``run`` and the
    metrics ``acs.run_episode`` reaches on the same key."""
    dev = resolve_device(device)
    cfg = workload.acs
    rates = workload.rates(dev) if hasattr(workload, "rates") else None
    key = episode_key(workload.seed, run, dev)
    trace = sample_trace(cfg, key, rates, locality=locality,
                         partitionable=partitionable)
    met = acs.run_episode(cfg, key[None], rates=rates, locality=locality,
                          partitionable=partitionable)
    return trace, met


def content_differential_check(workload, run: int = 0, *, device=None,
                               partitionable: bool =
                               prng.PARTITIONABLE_DEFAULT
                               ) -> ContentReport:
    """Sample one engine-schedule trace of a chunked workload and run
    the byte-exact harness, then close the loop against the batched
    tensor path's own byte ledger."""
    cfg = workload.acs
    locality = getattr(workload, "write_locality", cfg.write_locality)
    trace, met = _episode_metrics(workload, run, device, partitionable,
                                  locality=locality)
    ctx = f"content workload {workload.name!r} run {run}"
    report = check_content_trace(cfg, trace, name=workload.name,
                                 context=ctx, device=device)
    _expect("run_episode delta_bytes vs replay",
            int(met.delta_bytes), report.ledger.delta_bytes, ctx)
    _expect("run_episode full_bytes vs replay",
            int(met.full_bytes), report.ledger.full_bytes, ctx)
    _expect("run_episode n_chunks_fetched vs replay",
            int(met.n_chunks_fetched), report.ledger.n_chunks_fetched,
            ctx)
    return dataclasses.replace(
        report,
        implementations=report.implementations + ("run_episode",))


def differential_check(workload, run: int = 0, strategies=None, *,
                       device=None,
                       partitionable: bool = prng.PARTITIONABLE_DEFAULT
                       ) -> DiffReport:
    """Replay one sampled trace of ``workload`` through every
    implementation and assert bit-exact agreement.

    ``workload``: a ``repro_torch.sim.workloads.Workload``
    (heterogeneous rates) or a ``ScenarioConfig``-like object with
    ``.acs`` and ``.seed`` (scalar rates).  ``run`` selects the engine
    grid cell the trace reproduces.  Returns the agreed-upon
    :class:`DiffReport`; raises :class:`ConformanceError` on any
    divergence.
    """
    cfg = workload.acs
    trace, met = _episode_metrics(workload, run, device, partitionable)
    ctx = f"workload {workload.name!r} run {run}"
    report = check_trace(cfg, trace, name=workload.name, context=ctx,
                         device=device)
    led_vec = report.ledger

    # Close the loop: the batched tensor path executes this very trace.
    _expect("run_episode fetch_tokens vs replay",
            int(met.fetch_tokens), led_vec.fetch_tokens, ctx)
    _expect("run_episode signal_tokens vs replay",
            int(met.signal_tokens), led_vec.signal_tokens, ctx)
    _expect("run_episode push_tokens vs replay",
            int(met.push_tokens), led_vec.push_tokens, ctx)
    _expect("run_episode n_hits vs replay",
            int(met.n_hits), led_vec.n_hits, ctx)
    return dataclasses.replace(
        report,
        implementations=report.implementations + ("run_episode",))
