"""Batched chunk-diff / delta-coherence tick: the CUDA kernel and its
plain version.

The content plane tracks per-chunk version counters at the authority
and a per-chunk sync vector per (agent, artifact) cache entry.  Per
orchestration step, the hot work is: for every fill the MESI tick
decided, compare the reader's chunk vector against the authority's
chunk versions and count the stale chunks' bytes (delta fetch); for
every commit, bump the dirtied span's versions.  :func:`chunk_tick_`
does one tick of ``B`` simulations in one launch of the CUDA kernel in
``csrc/chunk_tick.cu`` (a group of lanes per simulation stages every
row the tick reads in shared memory, then runs the agents in ascending
order there, lanes over chunks; n or m above 32 or rows that are not
16-byte aligned take a direct path, see :func:`plan`), which replaces
the TPU kernel of the JAX package (``chunk_tick_pallas``);
:func:`chunk_tick_plain_` computes the same function in plain PyTorch
and runs for tensors on the CPU.

The MESI decision is **not** recomputed here: the tick takes the
per-agent ``miss`` indicator the MESI tick of the same step emits.

Counters layout (out[..., c]): 0 delta_bytes (shipped), 1 full_bytes
(what whole-artifact lazy would ship for the same fills),
2 n_chunks_fetched; 3 reserved (zero).
"""

from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.content.chunks import BYTES_PER_TOKEN
from repro_torch.kernels import build
from repro_torch.kernels.backend import check_inputs, launch, use_kernel

_I32 = torch.int32
N_CHUNK_COUNTERS = 4


def resolve_chunk_route(default: str = "auto") -> str:
    """'scan' (the ACS content plane in ``repro_torch.core.acs``) |
    'kernel' for content-plane ticks outside the sweep engine (the
    engine follows ``REPRO_SIM_TICK``).  Forced with
    ``REPRO_CHUNK_DIFF``; ``auto`` follows the caller's default."""
    forced = os.environ.get("REPRO_CHUNK_DIFF", default)
    if forced not in ("auto", "scan", "kernel"):
        raise ValueError(f"REPRO_CHUNK_DIFF must be auto|scan|kernel, "
                         f"got {forced!r}")
    return default if forced == "auto" else forced


def chunk_tick_plain_(chunk_version, chunk_sync, chunk_dirty,
                      miss, write_acts, arts, write_chunks, *,
                      artifact_tokens: int, chunk_tokens: int,
                      signal_tokens: int = 12):
    """The plain PyTorch version of the kernel, on any device: same
    arguments, same in-place updates, same ``(fetched, counters)``."""
    cv, cs, dirty = chunk_version, chunk_sync, chunk_dirty
    B, n, m, C = cs.shape
    dev = cs.device
    bidx = torch.arange(B, device=dev)
    # (C,) chunk token sizes from the static geometry (a ragged last
    # chunk), as the reference kernel builds them.
    sizes = torch.full((C,), chunk_tokens, dtype=_I32, device=dev)
    sizes[C - 1] = artifact_tokens - (C - 1) * chunk_tokens
    counters = torch.zeros((B, N_CHUNK_COUNTERS), dtype=_I32, device=dev)
    fetched = torch.zeros((B, n, C), dtype=_I32, device=dev)
    for a in range(n):
        miss_a = miss[:, a] != 0
        w_a = (write_acts[:, a] != 0)[:, None]
        d = arts[:, a].long()
        cv_d = cv[bidx, d]                                   # (B, C)
        cs_ad = cs[bidx, a, d]                               # (B, C)

        # --- delta fetch at this agent's serialization slot
        fetch = miss_a[:, None] & (cv_d > cs_ad)
        delta_tok = torch.sum(fetch.to(_I32) * sizes, dim=1, dtype=_I32)
        m32 = miss_a.to(_I32)
        counters[:, 0] += m32 * ((delta_tok + signal_tokens)
                                 * BYTES_PER_TOKEN)
        counters[:, 1] += m32 * ((artifact_tokens + signal_tokens)
                                 * BYTES_PER_TOKEN)
        counters[:, 2] += torch.sum(fetch, dim=1, dtype=_I32)
        fetched[:, a] = fetch.to(_I32)
        cs_ad = torch.where(miss_a[:, None], cv_d, cs_ad)

        # --- chunk-granular commit: bump the dirtied span
        bump = w_a & (write_chunks[:, a] != 0)
        cv_d = cv_d + bump.to(_I32)
        cv[bidx, d] = cv_d
        dirty[bidx, d] = torch.where(bump, 1, dirty[bidx, d])
        cs[bidx, a, d] = torch.where(w_a, cv_d, cs_ad)
    return fetched, counters


def _check(chunk_version, chunk_sync, chunk_dirty, miss, write_acts, arts,
           write_chunks):
    """Raise unless the tick's buffers are int32, contiguous and shaped
    for one (B, n, m, C) batch, as the kernel's pointers assume.  The
    common case costs one chain of comparisons; a refusal names the
    buffer."""
    B, n, m, C = chunk_sync.shape
    if (chunk_version.shape == chunk_dirty.shape == (B, m, C)
            and miss.shape == write_acts.shape == arts.shape == (B, n)
            and write_chunks.shape == (B, n, C)
            and chunk_version.dtype == chunk_sync.dtype == chunk_dirty.dtype
            == miss.dtype == write_acts.dtype == arts.dtype
            == write_chunks.dtype == _I32
            and chunk_version.is_contiguous() and chunk_sync.is_contiguous()
            and chunk_dirty.is_contiguous() and miss.is_contiguous()
            and write_acts.is_contiguous() and arts.is_contiguous()
            and write_chunks.is_contiguous()):
        return
    check_inputs({"chunk_version": (chunk_version, (B, m, C)),
                  "chunk_sync": (chunk_sync, (B, n, m, C)),
                  "chunk_dirty": (chunk_dirty, (B, m, C)),
                  "miss": (miss, (B, n)), "write_acts": (write_acts, (B, n)),
                  "arts": (arts, (B, n)),
                  "write_chunks": (write_chunks, (B, n, C))})


def plan(n: int, m: int, C: int) -> int:
    """Simulations a block of the kernel's staged path runs for ticks of
    n agents over m artifacts of C chunks, with 16-byte aligned buffers;
    0 where n or m exceeds 32 or C is no multiple of 4 and the kernel's
    direct path indexes the global buffers (as it does for a buffer that
    is not 16-byte aligned)."""
    return build.entry("chunk_tick", "chunk_tick_plan",
                       [ctypes.c_int] * 3)(n, m, C)


def chunk_tick_(chunk_version, chunk_sync, chunk_dirty,
                miss, write_acts, arts, write_chunks, *,
                artifact_tokens: int, chunk_tokens: int,
                signal_tokens: int = 12):
    """One content-plane tick over a batch of simulations, IN PLACE.

    Shapes: chunk_version/chunk_dirty (B, m, C) int32, chunk_sync
    (B, n, m, C) int32, miss/write_acts/arts (B, n) int32, write_chunks
    (B, n, C) int32, all contiguous, with every ``arts`` value in
    [0, m).  ``miss`` comes from the same tick's MESI tick;
    ``write_acts`` is act AND write.  Updates the three arrays in place
    (``chunk_sync`` only at the rows the agents address) and returns
    ``(fetched (B, n, C), counters (B, 4))``.  CUDA tensors launch the
    kernel (and add one to ``chunk_tick_.launches``); CPU tensors run
    :func:`chunk_tick_plain_`.
    """
    _check(chunk_version, chunk_sync, chunk_dirty, miss, write_acts, arts,
           write_chunks)
    if not use_kernel(chunk_version, chunk_sync, chunk_dirty, miss,
                      write_acts, arts, write_chunks):
        return chunk_tick_plain_(
            chunk_version, chunk_sync, chunk_dirty, miss, write_acts, arts,
            write_chunks, artifact_tokens=artifact_tokens,
            chunk_tokens=chunk_tokens, signal_tokens=signal_tokens)
    B, n, m, C = chunk_sync.shape
    dev = chunk_sync.device
    fetched = torch.empty((B, n, C), dtype=_I32, device=dev)
    counters = torch.empty((B, N_CHUNK_COUNTERS), dtype=_I32, device=dev)
    launch("chunk_tick", chunk_sync.get_device(), chunk_version.data_ptr(),
           chunk_sync.data_ptr(), chunk_dirty.data_ptr(), miss.data_ptr(),
           write_acts.data_ptr(), arts.data_ptr(), write_chunks.data_ptr(),
           fetched.data_ptr(), counters.data_ptr(), B, n, m, C, chunk_tokens,
           artifact_tokens, signal_tokens, BYTES_PER_TOKEN)
    chunk_tick_.launches += 1
    return fetched, counters


#: kernel launches since the count was last set to 0
chunk_tick_.launches = 0


def chunk_tick(chunk_version, chunk_sync, chunk_dirty,
               miss, write_acts, arts, write_chunks, *,
               artifact_tokens: int, chunk_tokens: int,
               signal_tokens: int = 12):
    """Functional form of :func:`chunk_tick_` with the signature of the
    reference's ``chunk_tick_pallas``: the inputs are left as they were.
    Returns ``(chunk_version', chunk_sync', chunk_dirty', fetched
    (B, n, C), counters (B, 4))``."""
    m = chunk_version.shape[1]
    if arts.numel() and (int(arts.min()) < 0 or int(arts.max()) >= m):
        raise ValueError(f"arts must lie in [0, {m})")
    out = [t.clone() for t in (chunk_version, chunk_sync, chunk_dirty)]
    fetched, counters = chunk_tick_(*out, miss, write_acts, arts,
                                    write_chunks,
                                    artifact_tokens=artifact_tokens,
                                    chunk_tokens=chunk_tokens,
                                    signal_tokens=signal_tokens)
    return (*out, fetched, counters)
