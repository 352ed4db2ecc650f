"""Micro-batching decision layer for the artifact-coherence broker.

The broker never decides one request at a time: in-flight read/write
requests are coalesced into a *micro-batch* (at most one per agent) and
resolved by ONE call into the coherence state machine, whose directory
lives on ``device`` (``None``: CUDA) for the decider's whole life.

Two interchangeable execution routes, both bit-exact with the
simulator (and therefore with the four-way differential oracle):

  ``scan``    one ``acs.apply_actions_`` call on the one-simulation
              directory - literally the simulation's serialized agent
              pass, through a closure made once per static broker
              config (module-level cache).  Covers every invalidation
              strategy plus K-staleness enforcement.
  ``kernel``  one launch of the MESI tick kernel over prefix-replicated
              simulations (``kernels.mesi_transition.decision_tick``),
              which yields per-request outcomes from the kernel's own
              miss bits, counters and the prefixes' sync words, chased
              on the content plane by one launch of the chunk tick; the
              batch reaches the card in one copy.  Covers the
              differential strategies (lazy / eager / access_count)
              with ``max_stale_steps=0``; staleness diagnostics are
              scan-route-only, mirroring the oracle's kernel scope
              note.

Either route reads its results back to the host in ONE copy per
micro-batch: the per-request miss bits and served versions, the
ledger (and, with content, byte-ledger) deltas, the directory's MESI
states and versions, and with content the chunks each fill shipped.

``auto`` resolves to the kernel route whenever the config is one it
covers, on either device (on the CPU the kernels' wrappers run their
plain versions); ``REPRO_SERVICE_DECIDE=scan|kernel`` forces either.
"""

from __future__ import annotations

import functools
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import acs
from repro_torch.core.states import MESIState
from repro_torch.kernels import mesi_transition as mt
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.chunk_diff import chunk_tick_, resolve_chunk_route
from repro_torch.obs import runtime as obs_runtime

#: strategies the kernel route supports (== oracle DIFFERENTIAL scope).
KERNEL_STRATEGIES = (acs.LAZY, acs.EAGER, acs.ACCESS_COUNT)

#: ACSMetrics content-plane counters forwarded as the wire-byte delta.
_WIRE_FIELDS = ("delta_bytes", "full_bytes", "n_chunks_fetched")

_I32 = torch.int32


class BatchDecision(NamedTuple):
    """Host-side result of one coalesced decision pass."""

    miss: np.ndarray     # (n,) bool: request triggered a coherence fill
    version: np.ndarray  # (n,) int32: version served at the agent's slot
    ledger_delta: dict   # exact integer counter deltas for this batch
    #: (n, C) bool chunks each fill shipped (content plane; else None)
    fetched_chunks: np.ndarray | None = None
    #: exact byte-ledger deltas (content plane; else None)
    wire_delta: dict | None = None


def _kernel_supported(cfg: acs.ACSConfig) -> bool:
    """The kernel route's scope: the differential strategies without
    K-staleness enforcement, and on the content plane only while
    ``REPRO_CHUNK_DIFF`` leaves content ticks on the kernel
    (``scan`` there keeps them on the ACS, which is the scan route)."""
    return (cfg.strategy in KERNEL_STRATEGIES
            and cfg.max_stale_steps == 0
            and not (acs.content_enabled(cfg)
                     and resolve_chunk_route("kernel") == "scan"))


def resolve_decide_backend(cfg: acs.ACSConfig,
                           backend: str = "auto") -> str:
    """'scan' | 'kernel' for a broker with static config ``cfg``."""
    forced = os.environ.get("REPRO_SERVICE_DECIDE", backend)
    if forced == "scan":
        return "scan"
    if forced == "kernel":
        if not _kernel_supported(cfg):
            raise ValueError(
                "kernel decision route covers lazy/eager/access_count "
                "with max_stale_steps=0 (and content ticks left on the "
                "kernel by REPRO_CHUNK_DIFF); use backend='scan' for "
                f"strategy={acs.STRATEGY_NAMES[cfg.strategy]} "
                f"max_stale_steps={cfg.max_stale_steps}")
        return "kernel"
    if forced != "auto":
        raise ValueError(f"unknown decision backend {forced!r}")
    return "kernel" if _kernel_supported(cfg) else "scan"


@functools.lru_cache(maxsize=None)
def _scan_decider(cfg: acs.ACSConfig):
    """One serialized-authority pass per static broker config; every
    micro-batch of every broker with this config reuses it.  Making it
    is the route's one-time event (``obs.runtime.note_compile``), as a
    jit trace is in the JAX package."""
    obs_runtime.note_compile(
        "scan", f"agents={cfg.n_agents} artifacts={cfg.n_artifacts} "
                f"strategy={acs.STRATEGY_NAMES[cfg.strategy]}")

    def fn(arrays, met, acts, arts, writes, write_chunks=None):
        return acs.apply_actions_(cfg, arrays, met, acts, arts, writes,
                                  write_chunks=write_chunks)
    return fn


#: ACSMetrics counter fields forwarded into the broker's token ledger.
_LEDGER_FIELDS = ("fetch_tokens", "push_tokens", "signal_tokens",
                  "n_fetches", "n_hits", "n_reads", "n_writes",
                  "n_invalidation_signals")

#: kernel counter slot -> ledger field (mesi_transition layout).
_KERNEL_SLOTS = {"fetch_tokens": 0, "signal_tokens": 1, "push_tokens": 2,
                 "n_fetches": 3, "n_hits": 4,
                 "n_invalidation_signals": 5}

#: position of each ACSMetrics field in the decider's metrics vector
_METRIC_INDEX = {f: i for i, f in enumerate(acs.ACSMetrics._fields)}


class BatchDecider:
    """Stateful decision engine: owns the directory arrays and applies
    one coalesced micro-batch per call.

    The broker is the *single writer* of this state - only the flush
    task calls :meth:`decide`, which is what makes SWMR hold under true
    asyncio interleaving (enforced with a reentrancy guard, checked by
    the invariant suite after every batch).
    """

    def __init__(self, cfg: acs.ACSConfig, backend: str = "auto",
                 device=None) -> None:
        self.cfg = cfg
        self.backend = resolve_decide_backend(cfg, backend)
        #: device this authority's directory lives on (``None``: CUDA)
        self.device = resolve_device(device)
        #: the directory: the ACS arrays of one simulation (leading
        #: axis 1), resident on ``device``
        self.arrays = acs.init_arrays(cfg, 1, self.device)
        self._metrics = torch.zeros(len(acs.ACSMetrics._fields),
                                    dtype=_I32, device=self.device)
        n, m = cfg.n_agents, cfg.n_artifacts
        #: host copies of the directory's MESI states (n, m) and
        #: versions (m,), refreshed from every decide's one read-back
        self.host_state = np.full((n, m), int(MESIState.I), np.int32)
        self.host_version = np.ones(m, np.int32)
        self._scan = _scan_decider(cfg) if self.backend == "scan" else None
        #: the kernel route's metric deltas not yet added on the device
        #: (the route reads its counters back anyway; they move to the
        #: device only when ``metrics`` is read)
        self._pending = np.zeros(len(_METRIC_INDEX), np.int64)
        fields = list(_KERNEL_SLOTS) + ["n_reads", "n_writes"]
        if acs.content_enabled(cfg):
            fields += list(_WIRE_FIELDS)
        self._kernel_index = [_METRIC_INDEX[f] for f in fields]
        self._deciding = False
        self._warmed = False

    @property
    def metrics(self) -> acs.ACSMetrics:
        """The decider's running ACS metrics, (1,) int32 tensors."""
        if self._pending.any():
            self._metrics = self._metrics + torch.as_tensor(
                self._pending, dtype=_I32, device=self.device)
            self._pending[:] = 0
        return acs.ACSMetrics(*self._metrics[:, None].unbind(0))

    # ------------------------------------------------------------------
    def decide(self, acts: np.ndarray, arts: np.ndarray,
               writes: np.ndarray,
               write_chunks: np.ndarray | None = None) -> BatchDecision:
        """Resolve one micro-batch (at most one request per agent).

        ``write_chunks`` (n, C) bool is required for chunked configs:
        the *measured* dirty chunk mask of each write in the batch
        (the broker diffs actual content digests)."""
        if self._deciding:
            raise RuntimeError(
                "re-entrant decide(): the broker's single-writer "
                "discipline was violated")
        if acs.content_enabled(self.cfg) and write_chunks is None:
            raise ValueError("chunked decider needs write_chunks masks")
        self._deciding = True
        t0 = time.perf_counter()
        try:
            if self.backend == "scan":
                return self._decide_scan(acts, arts, writes,
                                         write_chunks)
            return self._decide_kernel(acts, arts, writes, write_chunks)
        finally:
            if not self._warmed:
                # first-call wall time: the first dispatch, and a kernel
                # build where the libraries were not yet built
                self._warmed = True
                obs_runtime.note_warmup(
                    self.backend, time.perf_counter() - t0,
                    f"agents={self.cfg.n_agents} "
                    f"artifacts={self.cfg.n_artifacts}")
            self._deciding = False

    # ------------------------------------------------------------------
    def _read_back(self, parts) -> np.ndarray:
        """The batch's one device-to-host copy: ``parts`` flattened
        into one int32 buffer."""
        return torch.cat([p.reshape(-1).to(_I32) for p in parts]
                         ).cpu().numpy()

    def _refresh_host(self, host: np.ndarray) -> np.ndarray:
        """Take the directory's states and versions off the front of
        ``host``; returns the rest."""
        n, m = self.cfg.n_agents, self.cfg.n_artifacts
        self.host_state = host[:n * m].reshape(n, m)
        self.host_version = host[n * m:n * m + m]
        return host[n * m + m:]

    def _decide_scan(self, acts, arts, writes,
                     write_chunks) -> BatchDecision:
        content = acs.content_enabled(self.cfg)
        n = self.cfg.n_agents
        # the batch moves to the device in one copy
        rows = [np.asarray(x, np.int32).reshape(-1)
                for x in (acts, arts, writes)]
        if content:
            rows.append(np.asarray(write_chunks, np.int32).reshape(-1))
        batch = torch.from_numpy(np.concatenate(rows)).to(self.device)
        acts_d, arts_d, writes_d = batch[:3 * n].view(3, 1, n)
        before = self.metrics
        _, met, out = self._scan(
            self.arrays, before, acts_d, arts_d, writes_d,
            batch[3 * n:].view(1, n, -1) if content else None)
        after = torch.cat(list(met))
        moved, self._metrics = after - self._metrics, after
        parts = [self.arrays.state, self.arrays.version, out.miss,
                 out.version, moved]
        if content:
            parts.append(out.fetched_chunks)
        host = self._refresh_host(self._read_back(parts))
        miss, version = host[:n].astype(bool), host[n:2 * n]
        F = len(_METRIC_INDEX)
        moved = host[2 * n:2 * n + F].tolist()
        delta = {f: moved[_METRIC_INDEX[f]] for f in _LEDGER_FIELDS}
        wire = ({f: moved[_METRIC_INDEX[f]] for f in _WIRE_FIELDS}
                if content else None)
        fetched = (host[2 * n + F:].reshape(n, -1).astype(bool)
                   if content else None)
        return BatchDecision(miss=miss, version=version,
                             ledger_delta=delta, fetched_chunks=fetched,
                             wire_delta=wire)

    def _decide_kernel(self, acts, arts, writes,
                       write_chunks) -> BatchDecision:
        cfg = self.cfg
        content = acs.content_enabled(cfg)
        n, m = cfg.n_agents, cfg.n_artifacts
        acts_np = np.asarray(acts, bool)
        writes_np = np.asarray(writes, bool)
        # the kernel tracks token counters only; action counts come from
        # the batch itself (same derivation as oracle.replay_kernel).
        n_reads = int((acts_np & ~writes_np).sum())
        n_writes = int((acts_np & writes_np).sum())
        # the content plane's inputs ride in the same copy: the write
        # flags and the measured dirty chunk masks
        tail = (np.concatenate([(acts_np & writes_np).astype(np.int32),
                                np.asarray(write_chunks,
                                           np.int32).reshape(-1)])
                if content else None)
        prefix = mt.decision_inputs(acts_np, arts, writes_np, m,
                                    self.device, tail=tail)
        if prefix is None:              # nothing to decide, no launch
            C = acs.content_chunks(cfg) if content else 0
            return BatchDecision(
                miss=np.zeros(n, bool), version=np.zeros(n, np.int32),
                ledger_delta={f: 0 for f in _LEDGER_FIELDS},
                fetched_chunks=np.zeros((n, C), bool) if content else None,
                wire_delta={f: 0 for f in _WIRE_FIELDS} if content
                else None)
        a = self.arrays
        st, ver, sy, rd, cnt, miss, served = mt.decision_tick(
            a.state, a.version, a.last_sync, a.reads_since_fetch, prefix,
            artifact_tokens=cfg.artifact_tokens,
            eager=cfg.strategy == acs.EAGER,
            access_k=(cfg.access_k
                      if cfg.strategy == acs.ACCESS_COUNT else 0),
            signal_tokens=acs.SIGNAL_TOKENS)
        B = n + 1
        head = 3 * B * n + 2 * n
        # agent_actions is a scan-route diagnostic (staleness clocks);
        # each acting agent performed exactly one action this batch.
        self.arrays = a._replace(
            state=st, version=ver, last_sync=sy, reads_since_fetch=rd,
            agent_actions=a.agent_actions + prefix[head - n:head])
        parts = [st, ver, miss, served, cnt[:6]]
        if content:
            # Content plane rides the same serialization order: the
            # chunk tick consumes the per-request miss bits and the
            # measured dirty masks.
            fetched, ccnt = chunk_tick_(
                a.chunk_version, a.chunk_sync, a.chunk_dirty, miss[None],
                prefix[head:head + n][None],
                prefix[B * n:B * n + n][None],     # the batch's arts
                prefix[head + n:].view(1, n, -1),
                artifact_tokens=cfg.artifact_tokens,
                chunk_tokens=cfg.chunk_tokens,
                signal_tokens=acs.SIGNAL_TOKENS)
            parts += [ccnt[0, :3], fetched]
        host = self._refresh_host(self._read_back(parts))
        counts = host[2 * n:2 * n + 6].tolist()
        delta = dict(zip(_KERNEL_SLOTS, counts))
        delta["n_reads"] = n_reads
        delta["n_writes"] = n_writes
        moved = counts + [n_reads, n_writes]
        fetched = wire = None
        if content:
            wire = dict(zip(_WIRE_FIELDS,
                            host[2 * n + 6:2 * n + 9].tolist()))
            moved += list(wire.values())
            fetched = host[2 * n + 9:].reshape(n, -1).astype(bool)
        self._pending[self._kernel_index] += moved
        return BatchDecision(miss=host[:n].astype(bool),
                             version=host[n:2 * n], ledger_delta=delta,
                             fetched_chunks=fetched, wire_delta=wire)
