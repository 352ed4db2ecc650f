"""Batched MESI coherence tick: the CUDA kernel and its plain version.

Per tick, every simulation of a fleet sweep runs a serialized-agent
state transition over its (n_agents x n_artifacts) coherence matrix.
:func:`mesi_tick_` does one tick of ``B`` simulations in one launch of
the CUDA kernel in ``csrc/mesi_tick.cu`` (a group of lanes per
simulation, one lane per agent, runs the agents in ascending order over
the simulation's state slab staged in shared memory and writes back the
words that changed; n or m above 32 takes a direct path), which
replaces the TPU kernel of the JAX package (``mesi_tick_pallas``).
Beside it, :func:`mesi_tick_plain_` computes the same function in plain PyTorch,
batched over simulations and serial over agents; it runs for tensors
on the CPU, and the tests and ``chip_smoke.py`` hold the kernel to it.

Counters layout (out[..., c]): 0 fetch_tokens, 1 signal_tokens,
2 push_tokens, 3 n_fetches, 4 n_hits, 5 n_invalidation_signals;
6-7 reserved (zero).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.states import MESIState
from repro_torch.kernels import build
from repro_torch.kernels.backend import check_inputs, launch, use_kernel

_I, _S = int(MESIState.I), int(MESIState.S)
_I32 = torch.int32
N_COUNTERS = 8


def episode_step_keys(keys: torch.Tensor, n_steps: int,
                      partitionable: bool = prng.PARTITIONABLE_DEFAULT
                      ) -> torch.Tensor:
    """Per-step keys for a (B, 2) batch of episode keys, step-major:
    (n_steps, B, 2), where step ``s`` holds ``split(key, n_steps)[s]``
    - the schedule ``acs.run_episode`` uses, so kernel-routed episodes
    consume the same action stream as the scan route."""
    return prng.split(keys, n_steps, partitionable).transpose(0, 1)


def mesi_tick_plain_(state, version, last_sync, reads_since_fetch,
                     acts, arts, writes, *, artifact_tokens: int,
                     eager: bool = False, access_k: int = 0,
                     signal_tokens: int = 12):
    """The plain PyTorch version of the kernel, on any device: same
    arguments, same in-place updates, same ``(counters, miss)``."""
    state, version, sync, reads = (state, version, last_sync,
                                   reads_since_fetch)
    B, n, m = state.shape
    dev = state.device
    bidx = torch.arange(B, device=dev)
    counters = torch.zeros((B, N_COUNTERS), dtype=_I32, device=dev)
    miss_out = torch.zeros((B, n), dtype=_I32, device=dev)
    for a in range(n):
        act = acts[:, a] != 0
        is_write = act & (writes[:, a] != 0)
        is_read = act & (writes[:, a] == 0)
        d = arts[:, a].long()
        cell = (bidx, a, d)

        # --- coherence fill on miss (read-modify-write prologue)
        expired = (reads[cell] >= access_k if access_k > 0
                   else torch.zeros_like(act))
        miss = act & ((state[cell] == _I) | expired)
        hit = act & ~miss
        state[cell] = torch.where(miss, _S, state[cell])
        sync[cell] = torch.where(miss, version[bidx, d], sync[cell])
        reads[cell] = torch.where(miss, 0, reads[cell])
        counters[:, 0] += miss.to(_I32) * (artifact_tokens + signal_tokens)
        counters[:, 3] += miss.to(_I32)
        counters[:, 4] += hit.to(_I32)
        miss_out[:, a] = miss.to(_I32)

        # --- write path: invalidate peers, bump version, commit
        col = state[bidx, :, d]                               # (B, n)
        peer_valid = is_write[:, None] & (col != _I)
        peer_valid[:, a] = False
        n_peers = torch.sum(peer_valid, dim=1, dtype=_I32)
        counters[:, 1] += signal_tokens * n_peers
        counters[:, 5] += n_peers
        state[bidx, :, d] = torch.where(peer_valid, _I, col)
        new_ver = version[bidx, d] + is_write.to(_I32)
        version[bidx, d] = new_ver
        state[cell] = torch.where(is_write, _S, state[cell])
        sync[cell] = torch.where(is_write, new_ver, sync[cell])
        reads[cell] = torch.where(is_write, 0, reads[cell])
        if eager:
            # push-on-commit to active sharers
            state[bidx, :, d] = torch.where(peer_valid, _S,
                                            state[bidx, :, d])
            sync[bidx, :, d] = torch.where(peer_valid, new_ver[:, None],
                                           sync[bidx, :, d])
            reads[bidx, :, d] = torch.where(peer_valid, 0,
                                            reads[bidx, :, d])
            counters[:, 2] += (artifact_tokens + signal_tokens) * n_peers

        # --- read bookkeeping
        reads[cell] += is_read.to(_I32)
    return counters, miss_out


def _check(state, version, last_sync, reads_since_fetch, acts, arts,
           writes):
    """Raise unless the tick's buffers are int32, contiguous and shaped
    for one (B, n, m) batch, as the kernel's pointers assume.  The common
    case costs one chain of comparisons; a refusal names the buffer."""
    B, n, m = state.shape
    if (state.shape == last_sync.shape == reads_since_fetch.shape
            and version.shape == (B, m)
            and acts.shape == arts.shape == writes.shape == (B, n)
            and state.dtype == version.dtype == last_sync.dtype
            == reads_since_fetch.dtype == acts.dtype == arts.dtype
            == writes.dtype == _I32
            and state.is_contiguous() and version.is_contiguous()
            and last_sync.is_contiguous()
            and reads_since_fetch.is_contiguous() and acts.is_contiguous()
            and arts.is_contiguous() and writes.is_contiguous()):
        return
    check_inputs({"state": (state, (B, n, m)), "version": (version, (B, m)),
                  "last_sync": (last_sync, (B, n, m)),
                  "reads_since_fetch": (reads_since_fetch, (B, n, m)),
                  "acts": (acts, (B, n)), "arts": (arts, (B, n)),
                  "writes": (writes, (B, n))})


def _outputs(B: int, n: int, device):
    """The kernel's outputs: counters (B, 8) and miss (B, n)."""
    return (torch.empty((B, N_COUNTERS), dtype=_I32, device=device),
            torch.empty((B, n), dtype=_I32, device=device))


def plan(n: int, m: int) -> int:
    """Simulations a block of the kernel's staged path runs for ticks of
    n agents over m artifacts; 0 where n or m exceeds a warp's 32 lanes
    and the kernel's direct path indexes the global buffers."""
    return build.entry("mesi_tick", "mesi_tick_plan",
                       [ctypes.c_int] * 2)(n, m)


def mesi_tick_(state, version, last_sync, reads_since_fetch,
               acts, arts, writes, *, artifact_tokens: int,
               eager: bool = False, access_k: int = 0,
               signal_tokens: int = 12):
    """One coherence tick over a batch of simulations, IN PLACE.

    Shapes: state/last_sync/reads (B, n, m) int32; version (B, m) int32;
    acts/arts/writes (B, n) int32, all contiguous, with every ``arts``
    value in [0, m).  Updates the four state arrays in place and returns
    ``(counters (B, 8), miss (B, n))``; ``miss`` is the per-agent
    coherence-fill indicator the chunk tick consumes.  CUDA tensors
    launch the kernel (and add one to ``mesi_tick_.launches``); CPU
    tensors run :func:`mesi_tick_plain_`.
    """
    _check(state, version, last_sync, reads_since_fetch, acts, arts,
           writes)
    if not use_kernel(state, version, last_sync, reads_since_fetch, acts,
                      arts, writes):
        return mesi_tick_plain_(
            state, version, last_sync, reads_since_fetch, acts, arts,
            writes, artifact_tokens=artifact_tokens, eager=eager,
            access_k=access_k, signal_tokens=signal_tokens)
    B, n, m = state.shape
    counters, miss = _outputs(B, n, state.device)
    launch("mesi_tick", state.get_device(), state.data_ptr(),
           version.data_ptr(), last_sync.data_ptr(),
           reads_since_fetch.data_ptr(), acts.data_ptr(), arts.data_ptr(),
           writes.data_ptr(), counters.data_ptr(), miss.data_ptr(), B, n, m,
           artifact_tokens, int(eager), access_k, signal_tokens)
    mesi_tick_.launches += 1
    return counters, miss


#: kernel launches since the count was last set to 0
mesi_tick_.launches = 0


def mesi_tick(state, version, last_sync, reads_since_fetch,
              acts, arts, writes, *, artifact_tokens: int,
              eager: bool = False, access_k: int = 0,
              signal_tokens: int = 12):
    """Functional form of :func:`mesi_tick_` with the signature of the
    reference's ``mesi_tick_pallas``: the inputs are left as they were.
    Returns ``(state', version', sync', reads', counters (B, 8),
    miss (B, n))``."""
    m = state.shape[2]
    if arts.numel() and (int(arts.min()) < 0 or int(arts.max()) >= m):
        raise ValueError(f"arts must lie in [0, {m})")
    out = [t.clone() for t in (state, version, last_sync,
                               reads_since_fetch)]
    counters, miss = mesi_tick_(*out, acts, arts, writes,
                                artifact_tokens=artifact_tokens,
                                eager=eager, access_k=access_k,
                                signal_tokens=signal_tokens)
    return (*out, counters, miss)


def decision_inputs(acts, arts, writes, n_artifacts: int, device,
                    tail=None):
    """The prefix-replicated batch of one micro-batch, built on the host
    and moved to ``device`` in one copy (from pinned memory, without
    waiting, to a CUDA device).

    ``acts``/``arts``/``writes`` are (n,) array-likes of the requests to
    one directory of ``n_artifacts`` columns.  Simulation ``j`` of the
    ``B = n+1`` enables only the first ``j`` active agents in ascending
    order (rows past the last request repeat the full batch).  Returns
    ``None`` for an empty batch, else one int32 tensor on ``device``
    holding, in order, the batch's ``acts``, ``arts`` and ``writes``
    (B, n) each, then two (n,) vectors that :func:`decision_tick` reads:
    the flat index of each request's sync word after its slot, and its
    act flag; then ``tail`` (an int32 array-like, e.g. a content plane's
    inputs), flattened, when given.
    """
    acts_np = np.asarray(acts, bool)
    order = np.flatnonzero(acts_np)          # ascending agent order
    if order.size == 0:
        return None
    n = acts_np.size
    B = n + 1
    dev = torch.device(device)
    arts_np = np.asarray(arts, np.int64)
    tail = (np.zeros(0, np.int32) if tail is None
            else np.asarray(tail, np.int32).reshape(-1))
    head = 3 * B * n + 2 * n
    host = torch.empty(head + tail.size, dtype=_I32,
                       pin_memory=dev.type == "cuda")
    buf = host.numpy()
    acts_b, arts_b, writes_b = buf[:3 * B * n].reshape(3, B, n)
    pos = np.zeros(n, np.int64)
    pos[order] = np.arange(order.size)
    # acts_b[j, a] = 1 iff agent a holds prefix slot < j
    acts_b[:] = (np.arange(B)[:, None] > pos[None, :]) & acts_np
    arts_b[:] = arts_np
    writes_b[:] = np.asarray(writes, bool)
    sidx, act = buf[3 * B * n:head].reshape(2, n)
    # sim j+1 processed request j last: its sync cell is the version
    # agent a is synced to at its serialization slot
    sidx[:] = np.where(acts_np, ((pos + 1) * n + np.arange(n))
                       * n_artifacts + arts_np, 0)
    act[:] = acts_np
    buf[head:] = tail
    return host.to(dev, non_blocking=True)


def decision_tick(state, version, last_sync, reads_since_fetch, prefix, *,
                  artifact_tokens: int, eager: bool = False,
                  access_k: int = 0, signal_tokens: int = 12):
    """One micro-batch of live decisions in ONE tick launch, with no
    read-back: the internal entry the service's decider uses.

    ``state``/``last_sync``/``reads`` are one directory's (n, m) (or
    (1, n, m)) int32 tensors and ``version`` its (m,) (or (1, m)),
    left as they were; ``prefix`` is :func:`decision_inputs`' result on
    their device.  Returns, on that device, ``(state', version', sync',
    reads')`` each with a leading axis of 1, ``counters (8,)``,
    ``miss (n,)`` int32 and ``served_version (n,)`` int32.  The last
    simulation runs the whole batch in order, so its own counters and
    miss bits are the batch's; only the served versions need the
    prefixes (an eager commit later in the batch pushes to an earlier
    reader).
    """
    n, m = state.shape[-2:]
    B = n + 1
    acts_b, arts_b, writes_b = prefix[:3 * B * n].view(3, B, n)
    sidx, act = prefix[3 * B * n:3 * B * n + 2 * n].view(2, n)
    st = state.reshape(n, m).expand(B, n, m).contiguous()
    sy = last_sync.reshape(n, m).expand(B, n, m).contiguous()
    rd = reads_since_fetch.reshape(n, m).expand(B, n, m).contiguous()
    ver = version.reshape(m).expand(B, m).contiguous()
    cnt, miss = mesi_tick_(st, ver, sy, rd, acts_b, arts_b, writes_b,
                           artifact_tokens=artifact_tokens, eager=eager,
                           access_k=access_k, signal_tokens=signal_tokens)
    served = sy.view(-1).index_select(0, sidx) * act
    return (st[-1:], ver[-1:], sy[-1:], rd[-1:], cnt[-1], miss[-1], served)


def mesi_decision_batch(state, version, last_sync, reads_since_fetch,
                        acts, arts, writes, *, artifact_tokens: int,
                        eager: bool = False, access_k: int = 0,
                        signal_tokens: int = 12):
    """One micro-batch of live coherence decisions via prefix-replicated
    simulations.

    The tick emits per-*simulation* counters, yet a live broker must
    answer each request on its own (fill vs hit, served version).  So
    the single directory is replicated into ``B = n+1`` simulations
    where simulation ``j`` enables only the first ``j`` active agents in
    ascending order.  The last simulation runs the whole batch, so its
    miss bits and counters are the batch's; request ``j``'s served
    version is its sync word in simulation ``j+1``, which ends with it.
    Every decision of the batch falls out of one tick
    (:func:`decision_inputs`, :func:`decision_tick`).

    Inputs: one directory's ``state``/``last_sync``/``reads`` (n, m) and
    ``version`` (m,) int32 tensors, plus ``acts``/``arts``/``writes``
    (n,).  Returns ``(state', version', sync', reads', counters (8,),
    miss (n,) bool, served_version (n,) int32)``, on the directory's
    device.
    """
    n, m = state.shape
    dev = state.device
    host = [np.asarray(torch.as_tensor(x).cpu()) for x in (acts, arts,
                                                           writes)]
    prefix = decision_inputs(*host, m, dev)
    if prefix is None:
        return (state, version, last_sync, reads_since_fetch,
                torch.zeros((N_COUNTERS,), dtype=_I32, device=dev),
                torch.zeros((n,), dtype=torch.bool, device=dev),
                torch.zeros((n,), dtype=_I32, device=dev))
    directory = [torch.as_tensor(x, device=dev).to(_I32)
                 for x in (state, version, last_sync, reads_since_fetch)]
    st, ver, sy, rd, cnt, miss, served = decision_tick(
        *directory, prefix, artifact_tokens=artifact_tokens, eager=eager,
        access_k=access_k, signal_tokens=signal_tokens)
    return st[0], ver[0], sy[0], rd[0], cnt, miss.bool(), served
