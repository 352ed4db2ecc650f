"""Artifact Coherence System (ACS) - the batched PyTorch state machine.

The executable form of the paper's six-tuple <A, D, Sigma, delta,
alpha, T> (Def. 1), batched over a leading simulation axis ``B``: the
coherence state function alpha of every simulation is a dense
``(B, n_agents, n_artifacts)`` int32 tensor, and one *tick* applies the
serialized authority semantics of one orchestration step (paper SS8.1)
to all ``B`` simulations at once, with the agents of each simulation
still processed one after another in ascending order:

  * each agent acts with probability ``p_act``;
  * an acting agent picks an artifact uniformly and writes with
    probability ``V`` (else reads);
  * reads from Invalid state trigger a coherence fill (fetch, |d| tokens);
  * writes are read-modify-write: upgrade (peers invalidated), local
    write, commit (version++, writer -> S per protocol SS5.3);
  * token cost = full fetches x artifact size + 12-token signals.

Strategies (paper SS5.5) differ in *when* entries become Invalid and
whether content is pushed:

  BROADCAST     every agent receives every artifact every step (baseline)
  EAGER         invalidate-on-upgrade + push-on-commit to active sharers
  LAZY          invalidate-on-commit; fetch-on-demand (recommended)
  TTL           epoch lease refresh, decoupled from writes
  ACCESS_COUNT  lazy + entries expire after k reads

This module is the sweep engine's ``scan`` route and the reference the
CUDA kernels (``repro_torch.kernels``) are held to.  Where the JAX
reference branches with ``lax.cond`` on one simulation, this code
applies both sides as masks over the simulation axis.

With ``chunk_tokens > 0`` the chunk-granular content plane rides
alongside: per-chunk version counters at the authority, a per-(agent,
artifact) chunk sync vector that survives MESI invalidation, writes
dirtying only a sampled locality span, and fills shipping only stale
chunks.  It is a bytes-on-wire accounting overlay - no token counter
moves.

Every counter is int32, as in the reference.  ``torch.sum`` promotes
int32 to int64, so every sum here names its dtype.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.content.chunks import BYTES_PER_TOKEN, chunk_sizes, n_chunks
from repro_torch.core import prng
from repro_torch.core.states import MESIState
from repro_torch.kernels.backend import resolve_device

# Strategy codes.
BROADCAST = 0
EAGER = 1
LAZY = 2
TTL = 3
ACCESS_COUNT = 4

STRATEGY_NAMES = {
    BROADCAST: "broadcast",
    EAGER: "eager",
    LAZY: "lazy",
    TTL: "ttl",
    ACCESS_COUNT: "access_count",
}
STRATEGY_CODES = {v: k for k, v in STRATEGY_NAMES.items()}

#: per-signal overhead (tokens) for invalidation / envelope messages (SS8.1)
SIGNAL_TOKENS = 12

_I = int(MESIState.I)
_S = int(MESIState.S)

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ACSConfig:
    """Static scenario parameters."""

    n_agents: int
    n_artifacts: int
    artifact_tokens: int
    n_steps: int
    p_act: float = 0.75
    volatility: float = 0.1          # per-action write probability V
    strategy: int = LAZY
    ttl_events: int = 10             # TTL lease, in logical action-events
    access_k: int = 8                # access-count expiry threshold
    max_stale_steps: int = 0         # 0 disables K-staleness enforcement
    #: chunk-granular content plane: artifacts are arrays of
    #: ``chunk_tokens``-token chunks with per-chunk version counters,
    #: misses fetch only stale chunks (delta coherence), and the
    #: metrics grow a bytes-on-wire ledger.  0 disables the plane.
    chunk_tokens: int = 0
    #: fraction of an artifact's chunks one write dirties (a circular
    #: chunk span; sampled per write).  Default 1.0 = whole-artifact
    #: writes.  A per-simulation input of the engine, like
    #: ``volatility`` - this field is only the default.
    write_locality: float = 1.0


class RateMatrices(NamedTuple):
    """Heterogeneous workload rates - the generalization of the scalar
    ``(p_act, volatility)`` pair.  Leaves are either one workload's
    ``(n,)`` / ``(n, m)`` float32 tensors, shared by every simulation,
    or ``(B, n)`` / ``(B, n, m)`` with one row per simulation.  Rows of
    ``exp(log_pick)`` sum to 1."""

    p_act: torch.Tensor       # (n,)   per-agent act probability
    log_pick: torch.Tensor    # (n, m) log artifact-selection probabilities
    write_rate: torch.Tensor  # (n, m) P(write | agent a picked artifact d)


def uniform_rates(cfg: ACSConfig, device=None) -> RateMatrices:
    """The scalar scenario expressed as rate matrices (for tests that
    cross-check the heterogeneous path against the homogeneous one)."""
    dev = resolve_device(device)
    n, m = cfg.n_agents, cfg.n_artifacts
    return RateMatrices(
        p_act=torch.full((n,), cfg.p_act, dtype=torch.float32, device=dev),
        log_pick=-torch.log(torch.full((n, m), float(m),
                                       dtype=torch.float32, device=dev)),
        write_rate=torch.full((n, m), cfg.volatility, dtype=torch.float32,
                              device=dev),
    )


def _per_sim(x) -> torch.Tensor | float:
    """A scalar stays a float; a (B,) tensor becomes a (B, 1) float32
    column that broadcasts against (..., B, n)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).reshape(-1, 1)
    return float(x)


def run_keys(base_key: torch.Tensor, run_ids) -> torch.Tensor:
    """Per-run episode keys: ``fold_in(base_key, run_ids[i])``, (R, 2).

    The sweep engine's per-run key schedule, as in the reference:
    ``run_ids`` carries global run indices, so run ``r`` of a cell
    draws the same stream whatever the grid around it."""
    return prng.fold_in(base_key, torch.as_tensor(run_ids,
                                                  device=base_key.device))


def draw_actions(keys: torch.Tensor, n_agents: int, n_artifacts: int,
                 volatility, p_act, rates: RateMatrices | None = None, *,
                 partitionable: bool = prng.PARTITIONABLE_DEFAULT):
    """Sample one step's (acts, arts, writes) for every agent, from each
    step key of ``keys`` (..., 2): the reference's ``draw_actions``
    batched over the keys' leading axes, bit for bit.

    The key splits three ways (activity, artifact, write).  Scalar path
    (``rates is None``): Bernoulli(p_act) activity, uniform artifact
    choice, Bernoulli(volatility) writes; ``volatility`` and ``p_act``
    are floats or (B,) tensors, one per simulation of the last key
    axis.  Heterogeneous path: per-agent Bernoulli activity, per-agent
    categorical artifact choice (Gumbel-max over ``log_pick``), and a
    write probability looked up at the chosen (agent, artifact) cell.

    Returns ``acts`` (..., n) bool, ``arts`` (..., n) int32 and
    ``writes`` (..., n) bool, on the keys' device.
    """
    sub = prng.split(keys, 3, partitionable)
    k_act, k_art, k_wr = sub[..., 0, :], sub[..., 1, :], sub[..., 2, :]
    shape = (n_agents,)
    if rates is None:
        acts = prng.bernoulli(k_act, _per_sim(p_act), shape, partitionable)
        arts = prng.randint(k_art, shape, 0, n_artifacts, partitionable)
        writes = prng.bernoulli(k_wr, _per_sim(volatility), shape,
                                partitionable)
        return acts, arts.to(_I32), writes
    acts = prng.bernoulli(k_act, rates.p_act, shape, partitionable)
    arts = prng.categorical(k_art, rates.log_pick,
                            (n_agents, n_artifacts), partitionable)
    w_p = torch.gather(rates.write_rate.expand(arts.shape + (n_artifacts,)),
                       -1, arts[..., None])[..., 0]
    writes = prng.bernoulli(k_wr, w_p, shape, partitionable)
    return acts, arts.to(_I32), writes


#: strategies the chunk content plane is defined for: write-invalidate,
#: fetch-on-demand.  Eager push and TTL/broadcast bulk injection ship
#: whole artifacts by construction.
CONTENT_STRATEGIES = (LAZY, ACCESS_COUNT)

#: ``fold_in`` constant deriving the write-span key from a step key, as
#: in the reference: the act/artifact/write streams of a step key stay
#: those of the sampler without the content plane.
_SPAN_FOLD = 0x5EED


def content_enabled(cfg: ACSConfig) -> bool:
    return cfg.chunk_tokens > 0


def content_chunks(cfg: ACSConfig) -> int:
    """Chunks per artifact under this config's chunk geometry."""
    return n_chunks(cfg.artifact_tokens, cfg.chunk_tokens)


def write_span_start(keys: torch.Tensor, n_agents: int, n_chunks_: int,
                     partitionable: bool = prng.PARTITIONABLE_DEFAULT
                     ) -> torch.Tensor:
    """First chunk of each agent's write span, (..., n) int32: uniform
    on [0, C) from ``fold_in(key, 0x5EED)``."""
    k = prng.fold_in(keys, _SPAN_FOLD)
    return prng.randint(k, (n_agents,), 0, n_chunks_,
                        partitionable).to(_I32)


def write_span_mask(start: torch.Tensor, n_chunks_: int,
                    locality) -> torch.Tensor:
    """(..., n, C) bool: chunk ``i`` is dirtied iff ``(i - start) mod C
    < L`` with ``L = clip(round(locality * C), 1, C)`` (rounded half to
    even, in float32, as the reference does).  ``locality`` is a float
    or a (B,) tensor, one per simulation of ``start``'s second-to-last
    axis."""
    dev = start.device
    loc = torch.as_tensor(locality, dtype=torch.float32, device=dev)
    span = torch.clamp(torch.round(loc * n_chunks_).to(_I32), 1, n_chunks_)
    span = span.reshape(-1, 1, 1) if span.ndim else span
    idx = torch.arange(n_chunks_, dtype=_I32, device=dev)
    return ((idx - start[..., None]) % n_chunks_) < span


def draw_write_chunks(keys: torch.Tensor, n_agents: int, n_chunks_: int,
                      locality, *,
                      partitionable: bool = prng.PARTITIONABLE_DEFAULT
                      ) -> torch.Tensor:
    """Sample one step's per-agent write span as a (..., n, C) bool mask,
    from each step key of ``keys`` (..., 2), as the reference does.

    A span is *circular* (:func:`write_span_mask`), so locality is a
    pure span-length knob with no edge effects.  The key is
    ``fold_in(key, 0x5EED)``, which leaves the step's action streams
    untouched.
    """
    start = write_span_start(keys, n_agents, n_chunks_, partitionable)
    return write_span_mask(start, n_chunks_, locality)


def draw_step(cfg: ACSConfig, keys: torch.Tensor, volatility=None,
              p_act=None, rates: RateMatrices | None = None,
              locality=None, *,
              partitionable: bool = prng.PARTITIONABLE_DEFAULT):
    """One step's ``(acts, arts, writes, write_chunks)`` from step keys
    (..., 2) - the draws the reference's ``tick`` makes from its key.
    ``write_chunks`` is ``None`` without the content plane."""
    volatility = cfg.volatility if volatility is None else volatility
    p_act = cfg.p_act if p_act is None else p_act
    acts, arts, writes = draw_actions(keys, cfg.n_agents, cfg.n_artifacts,
                                      volatility, p_act, rates,
                                      partitionable=partitionable)
    wchunks = None
    if content_enabled(cfg):
        locality = cfg.write_locality if locality is None else locality
        wchunks = draw_write_chunks(keys, cfg.n_agents, content_chunks(cfg),
                                    locality, partitionable=partitionable)
    return acts, arts, writes, wchunks


class ACSArrays(NamedTuple):
    """alpha and the bookkeeping the strategies need (all int32, with a
    leading simulation axis B).  The three ``chunk_*`` leaves are the
    content plane; they are ``None`` when ``cfg.chunk_tokens == 0``."""

    state: torch.Tensor            # (B, n, m) MESI state
    version: torch.Tensor          # (B, m)    canonical version
    last_sync: torch.Tensor        # (B, n, m) version at agent's last fill
    reads_since_fetch: torch.Tensor  # (B, n, m) for ACCESS_COUNT
    agent_actions: torch.Tensor    # (B, n)    logical action clock
    last_validate: torch.Tensor    # (B, n, m) agent_actions at last validate
    chunk_version: Optional[torch.Tensor] = None  # (B, m, C)
    chunk_sync: Optional[torch.Tensor] = None     # (B, n, m, C)
    chunk_dirty: Optional[torch.Tensor] = None    # (B, m, C)


class ACSMetrics(NamedTuple):
    """Per-simulation ledgers, each a (B,) int32 tensor."""

    fetch_tokens: torch.Tensor
    push_tokens: torch.Tensor
    signal_tokens: torch.Tensor
    broadcast_tokens: torch.Tensor
    n_fetches: torch.Tensor
    n_hits: torch.Tensor
    n_reads: torch.Tensor
    n_writes: torch.Tensor
    n_invalidation_signals: torch.Tensor
    max_staleness: torch.Tensor
    max_version_lag: torch.Tensor
    #: largest action-clock staleness a *served* cache hit carried,
    #: after any forced revalidation (never exceeds K under
    #: ``max_stale_steps = K > 0``).
    max_consumed_staleness: torch.Tensor
    #: bytes-on-wire ledger of the chunk content plane (all zero when
    #: ``chunk_tokens == 0``): what delta coherence shipped, what
    #: whole-artifact lazy would have shipped for the same misses, and
    #: the stale chunks fetched.
    delta_bytes: torch.Tensor
    full_bytes: torch.Tensor
    n_chunks_fetched: torch.Tensor

    @property
    def total_tokens(self) -> torch.Tensor:
        return (self.fetch_tokens + self.push_tokens
                + self.signal_tokens + self.broadcast_tokens)

    @property
    def sync_tokens(self) -> torch.Tensor:
        """Synchronous (critical-path) traffic only: demand fetches +
        signals + broadcast sweeps; eager's push-on-commit is reported
        separately as ``push_tokens``."""
        return self.fetch_tokens + self.signal_tokens + self.broadcast_tokens

    @property
    def cache_hit_rate(self) -> torch.Tensor:
        """int32 / int32 -> float32, as the reference divides."""
        denom = torch.clamp(self.n_hits + self.n_fetches, min=1)
        return self.n_hits.to(torch.float32) / denom


def init_arrays(cfg: ACSConfig, n_sims: int, device=None) -> ACSArrays:
    """Cold start of ``n_sims`` simulations: all caches Invalid,
    canonical version 1 (SS8.1); with the content plane, chunk versions
    1 and reader chunk vectors 0 (a cold fill ships every chunk)."""
    dev = resolve_device(device)
    n, m, B = cfg.n_agents, cfg.n_artifacts, n_sims

    def z(*shape):
        return torch.zeros((B,) + shape, dtype=_I32, device=dev)

    chunk_version = chunk_sync = chunk_dirty = None
    if content_enabled(cfg):
        if cfg.strategy not in CONTENT_STRATEGIES:
            raise ValueError(
                f"chunk content plane covers "
                f"{[STRATEGY_NAMES[s] for s in CONTENT_STRATEGIES]} "
                f"(write-invalidate, fetch-on-demand); got "
                f"{STRATEGY_NAMES[cfg.strategy]}")
        C = content_chunks(cfg)
        chunk_version = torch.ones((B, m, C), dtype=_I32, device=dev)
        chunk_sync = z(n, m, C)
        chunk_dirty = z(m, C)
    return ACSArrays(
        state=torch.full((B, n, m), _I, dtype=_I32, device=dev),
        version=torch.ones((B, m), dtype=_I32, device=dev),
        last_sync=z(n, m),
        reads_since_fetch=z(n, m),
        agent_actions=z(n),
        last_validate=z(n, m),
        chunk_version=chunk_version,
        chunk_sync=chunk_sync,
        chunk_dirty=chunk_dirty,
    )


def init_metrics(n_sims: int, device=None) -> ACSMetrics:
    dev = resolve_device(device)
    return ACSMetrics(*(torch.zeros((n_sims,), dtype=_I32, device=dev)
                        for _ in ACSMetrics._fields))


def arrays_from_numpy(arrays, device=None) -> ACSArrays:
    """``ACSArrays`` of int32 tensors on ``device`` from any sequence of
    nine array-likes (``None`` leaves stay ``None``) - e.g. the numpy
    form of the reference's ``ACSArrays`` batched over simulations.
    Every leaf is a copy: the ticks update their arrays in place, and a
    numpy view (read-only, from JAX) must not be written through."""
    dev = resolve_device(device)
    return ACSArrays(*(None if x is None else torch.tensor(
        np.asarray(x), dtype=_I32, device=dev) for x in arrays))


def arrays_to_numpy(arrays: ACSArrays) -> ACSArrays:
    """The inverse of :func:`arrays_from_numpy`: int32 numpy leaves."""
    return ACSArrays(*(None if x is None else x.cpu().numpy()
                       for x in arrays))


def _clone(arrays: ACSArrays) -> ACSArrays:
    return ACSArrays(*(None if x is None else x.clone() for x in arrays))


def _i32(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(_I32)


def _fill(cfg: ACSConfig, arrays: ACSArrays, met: ACSMetrics, a, d, bidx,
          fill):
    """Coherence fill where ``fill``: FETCH_REQUEST -> content + version,
    I -> S.  With the content plane on, the payload is a *delta* - only
    chunks whose authority version exceeds the reader's chunk vector
    ship; the byte ledger records both what delta coherence shipped and
    what whole-artifact lazy would have shipped for this same fill."""
    cell = (bidx, a, d)
    arrays.state[cell] = torch.where(fill, _S, arrays.state[cell])
    arrays.last_sync[cell] = torch.where(fill, arrays.version[bidx, d],
                                         arrays.last_sync[cell])
    arrays.reads_since_fetch[cell] = torch.where(
        fill, 0, arrays.reads_since_fetch[cell])
    arrays.last_validate[cell] = torch.where(
        fill, arrays.agent_actions[:, a], arrays.last_validate[cell])
    f = _i32(fill)
    met = met._replace(
        fetch_tokens=met.fetch_tokens
        + f * (cfg.artifact_tokens + SIGNAL_TOKENS),
        n_fetches=met.n_fetches + f,
    )
    if content_enabled(cfg):
        sizes = chunk_sizes(cfg.artifact_tokens, cfg.chunk_tokens,
                            fill.device)
        cv_d = arrays.chunk_version[bidx, d]               # (B, C)
        cs_ad = arrays.chunk_sync[cell]                    # (B, C)
        stale = cv_d > cs_ad
        delta_tokens = torch.sum(_i32(stale) * sizes, dim=1, dtype=_I32)
        met = met._replace(
            delta_bytes=met.delta_bytes
            + f * ((delta_tokens + SIGNAL_TOKENS) * BYTES_PER_TOKEN),
            full_bytes=met.full_bytes
            + f * ((cfg.artifact_tokens + SIGNAL_TOKENS) * BYTES_PER_TOKEN),
            n_chunks_fetched=met.n_chunks_fetched
            + f * torch.sum(stale, dim=1, dtype=_I32),
        )
        arrays.chunk_sync[cell] = torch.where(fill[:, None], cv_d, cs_ad)
    return met


def _access(cfg: ACSConfig, arrays: ACSArrays, met: ACSMetrics, a, d, bidx,
            act):
    """Shared read/write prologue for the simulations where ``act``:
    ensure a valid, fresh local copy.  Counts hit/miss and enforces
    K-bounded staleness when enabled (Invariant 3, SS6.2)."""
    cell = (bidx, a, d)
    clock = arrays.agent_actions[:, a]
    staleness = clock - arrays.last_validate[cell]
    entry_valid = arrays.state[cell] != _I
    # Content staleness a coherent read may observe: canonical version
    # minus the version this valid entry was filled at.
    version_lag = arrays.version[bidx, d] - arrays.last_sync[cell]
    zero = torch.zeros_like(staleness)
    met = met._replace(
        max_staleness=torch.where(act, torch.maximum(
            met.max_staleness, torch.where(entry_valid, staleness, zero)),
            met.max_staleness),
        max_version_lag=torch.where(act, torch.maximum(
            met.max_version_lag, torch.where(entry_valid, version_lag,
                                             zero)),
            met.max_version_lag))

    invalid = ~entry_valid
    if cfg.strategy == ACCESS_COUNT:
        expired = entry_valid & (arrays.reads_since_fetch[cell]
                                 >= cfg.access_k)
    else:
        expired = torch.zeros_like(entry_valid)

    if cfg.max_stale_steps > 0:
        # forced revalidation: version check (12 tokens); full fetch only
        # if the canonical version moved on.
        needs_check = act & entry_valid & (staleness > cfg.max_stale_steps)
        version_moved = arrays.last_sync[cell] != arrays.version[bidx, d]
        met = met._replace(signal_tokens=met.signal_tokens
                           + _i32(needs_check) * SIGNAL_TOKENS)
        arrays.last_validate[cell] = torch.where(
            needs_check & ~version_moved, clock, arrays.last_validate[cell])
        expired = expired | (needs_check & version_moved)

    miss = invalid | expired
    met = _fill(cfg, arrays, met, a, d, bidx, act & miss)
    hit = act & ~miss
    # Staleness the consumer actually sees: read last_validate AFTER any
    # forced revalidation above reset it.
    consumed = clock - arrays.last_validate[cell]
    return met._replace(
        n_hits=met.n_hits + _i32(hit),
        max_consumed_staleness=torch.where(hit, torch.maximum(
            met.max_consumed_staleness, consumed),
            met.max_consumed_staleness))


def _write(cfg: ACSConfig, arrays: ACSArrays, met: ACSMetrics, a, d, bidx,
           w, wchunks):
    """Upgrade -> local write -> commit (SS5.3) for the simulations
    where ``w``, after the read-modify-write prologue.  ``wchunks`` is
    the (B, C) bool chunk mask each write dirties (content plane)."""
    cell = (bidx, a, d)
    n = cfg.n_agents
    if cfg.strategy != TTL:
        # UPGRADE: authority invalidates peers; one signal per peer whose
        # copy was actually valid (idempotent re-invalidation is free).
        col = arrays.state[bidx, :, d]                       # (B, n)
        peer_valid = (col != _I) & w[:, None]
        peer_valid[:, a] = False
        n_signals = torch.sum(peer_valid, dim=1, dtype=_I32)
        arrays.state[bidx, :, d] = torch.where(peer_valid, _I, col)
        met = met._replace(
            signal_tokens=met.signal_tokens + SIGNAL_TOKENS * n_signals,
            n_invalidation_signals=met.n_invalidation_signals + n_signals)
    else:
        peer_valid = torch.zeros((w.shape[0], n), dtype=torch.bool,
                                 device=w.device)

    # Local write (E -> M) then COMMIT: version++, writer downgrades to S.
    new_version = arrays.version[bidx, d] + 1
    arrays.version[bidx, d] = torch.where(w, new_version,
                                          arrays.version[bidx, d])
    arrays.state[cell] = torch.where(w, _S, arrays.state[cell])
    arrays.last_sync[cell] = torch.where(w, new_version,
                                         arrays.last_sync[cell])
    arrays.reads_since_fetch[cell] = torch.where(
        w, 0, arrays.reads_since_fetch[cell])
    arrays.last_validate[cell] = torch.where(
        w, arrays.agent_actions[:, a], arrays.last_validate[cell])
    met = met._replace(n_writes=met.n_writes + _i32(w))

    if content_enabled(cfg):
        # Chunk-granular commit: bump only the dirtied span's versions,
        # mark the dirty bitmap (monotone), and sync the writer's chunk
        # vector to the post-commit state.
        span = wchunks & w[:, None]
        new_cv = arrays.chunk_version[bidx, d] + _i32(span)
        arrays.chunk_version[bidx, d] = new_cv
        arrays.chunk_dirty[bidx, d] = torch.where(
            span, 1, arrays.chunk_dirty[bidx, d])
        arrays.chunk_sync[cell] = torch.where(w[:, None], new_cv,
                                              arrays.chunk_sync[cell])

    if cfg.strategy == EAGER:
        # Push-on-commit: pre-populate the caches of active sharers
        # (peers that held a valid copy at upgrade time), SS8.8.
        n_push = torch.sum(peer_valid, dim=1, dtype=_I32)
        arrays.state[bidx, :, d] = torch.where(
            peer_valid, _S, arrays.state[bidx, :, d])
        arrays.last_sync[bidx, :, d] = torch.where(
            peer_valid, new_version[:, None], arrays.last_sync[bidx, :, d])
        arrays.reads_since_fetch[bidx, :, d] = torch.where(
            peer_valid, 0, arrays.reads_since_fetch[bidx, :, d])
        arrays.last_validate[bidx, :, d] = torch.where(
            peer_valid, arrays.agent_actions,
            arrays.last_validate[bidx, :, d])
        met = met._replace(push_tokens=met.push_tokens + n_push * (
            cfg.artifact_tokens + SIGNAL_TOKENS))
    return met


class DecisionOutcome(NamedTuple):
    """Per-agent result of one serialized authority pass: did the
    action trigger a coherence fill, and which canonical version is the
    agent synced to right after its serialization slot."""

    miss: torch.Tensor     # (B, n) bool
    version: torch.Tensor  # (B, n) int32: last_sync[a, d] after a's slot
    #: (B, n, C) bool: chunks shipped to each agent's fill this pass
    #: (content plane only; ``None`` when ``chunk_tokens == 0``).
    fetched_chunks: Optional[torch.Tensor] = None


def apply_slot_(cfg: ACSConfig, arrays: ACSArrays, met: ACSMetrics, bidx,
                a: int, act, d, is_write, wchunks=None):
    """Agent ``a``'s serialization slot of one authority pass, updating
    ``arrays`` in place: in every simulation where ``act`` (B,) bool,
    the agent reads or (where ``is_write``) writes artifact ``d`` (B,)
    long.  ``bidx`` is ``arange(B)``; ``wchunks`` (B, C) bool is the
    write's dirty chunk mask (content plane).  Returns ``(metrics',
    missed (B,) bool, stale_before (B, C) bool or None)``: whether the
    action filled, and which chunks were stale at the slot's start (a
    fill ships exactly those - the agent's own commit bumps versions
    only after its prologue fill)."""
    content = content_enabled(cfg)
    w = act & is_write
    r = act & ~is_write
    arrays.agent_actions[:, a] += _i32(act)
    fetches_before = met.n_fetches
    stale_before = None
    if content:
        stale_before = (arrays.chunk_version[bidx, d]
                        > arrays.chunk_sync[bidx, a, d])
    if cfg.strategy == BROADCAST:
        # Everything is already injected; actions are free, but writes
        # still bump the canonical version.
        met = met._replace(n_reads=met.n_reads + _i32(r),
                           n_writes=met.n_writes + _i32(w),
                           n_hits=met.n_hits + _i32(act))
        arrays.version[bidx, d] += _i32(w)
    else:
        met = _access(cfg, arrays, met, a, d, bidx, act)
        met = _write(cfg, arrays, met, a, d, bidx, w, wchunks)
        arrays.reads_since_fetch[bidx, a, d] += _i32(r)
        met = met._replace(n_reads=met.n_reads + _i32(r))
    return met, met.n_fetches > fetches_before, stale_before


def apply_actions_(cfg: ACSConfig, arrays: ACSArrays, met: ACSMetrics,
                    acts, arts, writes, write_chunks=None):
    """:func:`apply_actions` updating ``arrays`` in place."""
    content = content_enabled(cfg)
    if content and write_chunks is None:
        raise ValueError("content plane enabled but no write chunk mask "
                         "was supplied")
    acts = acts.bool()
    writes = writes.bool()
    arts = arts.long()
    B, n = acts.shape
    dev = acts.device
    bidx = torch.arange(B, device=dev)
    out_miss = torch.zeros((B, n), dtype=torch.bool, device=dev)
    out_ver = torch.zeros((B, n), dtype=_I32, device=dev)
    out_chunks = None
    if content:
        write_chunks = write_chunks.bool()
        out_chunks = torch.zeros((B, n, content_chunks(cfg)),
                                 dtype=torch.bool, device=dev)

    for a in range(n):
        act = acts[:, a]
        d = arts[:, a]
        met, missed, stale_before = apply_slot_(
            cfg, arrays, met, bidx, a, act, d, writes[:, a],
            write_chunks[:, a] if content else None)
        out_miss[:, a] = missed
        out_ver[:, a] = torch.where(act, arrays.last_sync[bidx, a, d], 0)
        if content:
            out_chunks[:, a] = missed[:, None] & stale_before
    return arrays, met, DecisionOutcome(out_miss, out_ver, out_chunks)


def apply_actions(cfg: ACSConfig, arrays: ACSArrays, met: ACSMetrics,
                  acts, arts, writes, write_chunks=None):
    """Apply one serialized authority pass for fixed action tensors.

    ``acts``/``writes`` are (B, n) bools, ``arts`` (B, n) ints - at most
    one action per agent, processed in ascending agent order (the
    authority's serialization order, as in the CUDA kernel).
    ``write_chunks`` is the (B, n, C) bool per-agent dirty chunk mask
    (content plane only; ignored for reads).

    Functional: ``arrays`` is left as it was.  Returns ``(arrays',
    metrics', DecisionOutcome)``.
    """
    return apply_actions_(cfg, _clone(arrays), met, acts, arts, writes,
                           write_chunks)


def tick_(cfg: ACSConfig, arrays: ACSArrays, met: ACSMetrics, step: int,
           actions, p_act=None, rates: RateMatrices | None = None):
    """:func:`tick` on given actions, updating ``arrays`` in place."""
    acts, arts, writes, wchunks = actions
    B = acts.shape[0]
    n, m = cfg.n_agents, cfg.n_artifacts
    if cfg.strategy == BROADCAST:
        # Full-state rebroadcast: every agent receives every artifact.
        met = met._replace(broadcast_tokens=met.broadcast_tokens
                           + n * m * (cfg.artifact_tokens + SIGNAL_TOKENS))
        arrays.state.fill_(_S)
        arrays.last_sync.copy_(arrays.version[:, None, :].expand(B, n, m))
        arrays.last_validate.copy_(
            arrays.agent_actions[:, :, None].expand(B, n, m))

    if cfg.strategy == TTL:
        # Epoch lease refresh, driven by the orchestrator's logical event
        # clock (expected n*p_act action events per step), in float32
        # exactly as the reference computes it.
        if rates is not None:
            rate = torch.sum(rates.p_act, dim=-1)
        else:
            p = cfg.p_act if p_act is None else p_act
            rate = (n * p.to(torch.float32) if isinstance(p, torch.Tensor)
                    else torch.full((), n * p, dtype=torch.float32,
                                    device=arrays.state.device))
        rate = rate.to(arrays.state.device)
        step_f = torch.full((), float(step), dtype=torch.float32,
                            device=rate.device)
        epoch_now = torch.floor(rate * step_f / cfg.ttl_events).to(_I32)
        if step > 0:
            epoch_prev = torch.floor(
                rate * (step_f - 1.0) / cfg.ttl_events).to(_I32)
        else:
            epoch_prev = torch.full_like(epoch_now, -1)
        do = (epoch_now > epoch_prev).expand(B)
        do3 = do[:, None, None]
        arrays.state.copy_(torch.where(do3, _S, arrays.state))
        arrays.last_sync.copy_(torch.where(
            do3, arrays.version[:, None, :], arrays.last_sync))
        arrays.reads_since_fetch.copy_(torch.where(
            do3, 0, arrays.reads_since_fetch))
        arrays.last_validate.copy_(torch.where(
            do3, arrays.agent_actions[:, :, None], arrays.last_validate))
        n_fill = n * m
        met = met._replace(
            fetch_tokens=met.fetch_tokens
            + _i32(do) * (n_fill * cfg.artifact_tokens),
            n_fetches=met.n_fetches + _i32(do) * n_fill)

    arrays, met, _ = apply_actions_(cfg, arrays, met, acts, arts, writes,
                                     wchunks)
    return arrays, met


def tick(cfg: ACSConfig, arrays: ACSArrays, met: ACSMetrics,
         keys: torch.Tensor | None, step: int,
         volatility=None, p_act=None, rates: RateMatrices | None = None,
         locality=None, actions=None, *,
         partitionable: bool = prng.PARTITIONABLE_DEFAULT):
    """One orchestration step for every agent of every simulation.

    ``keys`` (B, 2) holds each simulation's step key.
    ``volatility`` / ``p_act`` / ``locality`` default to the config
    values and may be (B,) tensors; ``rates`` generalizes the first two
    to per-agent x per-artifact matrices and takes precedence.
    ``actions`` - a ``(acts, arts, writes, write_chunks)`` tuple of
    (B, n[, C]) tensors - replaces the draw from ``keys`` (a test hook).

    Functional: ``arrays`` is left as it was.  Returns ``(arrays',
    metrics')``.
    """
    if actions is None:
        actions = draw_step(cfg, keys, volatility, p_act, rates, locality,
                            partitionable=partitionable)
    return tick_(cfg, _clone(arrays), met, step, actions, p_act=p_act,
                  rates=rates)


def run_episode(cfg: ACSConfig, keys: torch.Tensor, volatility=None,
                p_act=None, rates: RateMatrices | None = None,
                locality=None, *,
                partitionable: bool = prng.PARTITIONABLE_DEFAULT
                ) -> ACSMetrics:
    """Run one full S-step episode per key of ``keys`` (B, 2), on the
    keys' device; returns the final metrics.  Episode ``b`` draws step
    ``s`` from ``split(keys[b], S)[s]``, as the reference's
    ``run_episode`` does."""
    dev = keys.device
    n_sims = keys.shape[0]
    arrays = init_arrays(cfg, n_sims, dev)
    met = init_metrics(n_sims, dev)
    step_keys = prng.split(keys, cfg.n_steps, partitionable)
    for step in range(cfg.n_steps):
        act = draw_step(cfg, step_keys[:, step], volatility, p_act, rates,
                        locality, partitionable=partitionable)
        arrays, met = tick_(cfg, arrays, met, step, act, p_act=p_act,
                             rates=rates)
    return met
