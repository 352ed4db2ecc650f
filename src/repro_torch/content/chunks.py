"""Chunk geometry + content-addressed chunk store (the content plane's
host side).

An artifact is a fixed array of ``n_chunks`` chunks of ``chunk_tokens``
tokens each (the last chunk may be ragged), every chunk is
content-addressed by digest, and a reader that already holds an older
copy re-fetches only the chunks whose authority version moved.

Two consumers:

  * the batched simulator and the chunk tick
    (``repro_torch.core.acs``, ``repro_torch.kernels.chunk_diff``)
    track per-chunk *version counters* and account delta bytes-on-wire
    from the geometry without materializing content;
  * the live service (``repro_torch.service``) layers a
    :class:`ChunkStore` over ``repro_torch.core.protocol.ArtifactStore``
    so broker reads ship **actual** delta payloads and clients
    reassemble byte-exact copies.

Wire accounting uses ``BYTES_PER_TOKEN`` so the ledgers read in bytes;
the constant cancels in every savings ratio.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

#: wire width of one token in the byte ledgers (constant factor only -
#: it cancels in every delta/full/broadcast savings ratio).
BYTES_PER_TOKEN = 4


def n_chunks(artifact_tokens: int, chunk_tokens: int) -> int:
    """Chunk count of one artifact (last chunk may be ragged)."""
    if chunk_tokens <= 0:
        raise ValueError(f"chunk_tokens must be positive, got "
                         f"{chunk_tokens}")
    if artifact_tokens <= 0:
        raise ValueError(f"artifact_tokens must be positive, got "
                         f"{artifact_tokens}")
    return -(-artifact_tokens // chunk_tokens)


def chunk_sizes(artifact_tokens: int, chunk_tokens: int, device=None):
    """(C,) int32 token size per chunk; sums to ``artifact_tokens``.  A
    numpy array, or with ``device`` a tensor computed there (no copy
    from the host, which would wait for the device)."""
    C = n_chunks(artifact_tokens, chunk_tokens)
    if device is None:
        starts = np.arange(C, dtype=np.int32) * chunk_tokens
        return np.minimum(artifact_tokens - starts,
                          chunk_tokens).astype(np.int32)
    starts = torch.arange(C, dtype=torch.int32, device=device) * chunk_tokens
    return torch.clamp(artifact_tokens - starts, max=chunk_tokens)


def split_chunks(content: Sequence[int],
                 chunk_tokens: int) -> List[Tuple[int, ...]]:
    """Split a token sequence into its chunk array."""
    content = tuple(int(t) for t in content)
    return [content[i:i + chunk_tokens]
            for i in range(0, len(content), chunk_tokens)]


def reassemble(chunks: Iterable[Sequence[int]]) -> Tuple[int, ...]:
    """Inverse of :func:`split_chunks` (chunk -> reassembly identity)."""
    out: List[int] = []
    for c in chunks:
        out.extend(int(t) for t in c)
    return tuple(out)


def chunk_digest(chunk: Sequence[int]) -> str:
    """Content address of one chunk (sha1 over the token bytes)."""
    h = hashlib.sha1()
    h.update(np.asarray(chunk, np.int64).tobytes())
    return h.hexdigest()


def apply_delta(base: Sequence[int], delta, chunk_tokens: int
                ) -> Tuple[int, ...]:
    """Patch ``base`` with ``delta`` = iterable of (chunk_idx, payload)
    pairs - what a client does with a delta read response."""
    chunks = split_chunks(base, chunk_tokens)
    for idx, payload in delta:
        chunks[int(idx)] = tuple(int(t) for t in payload)
    return reassemble(chunks)


def diff_chunks(cur: Sequence[int], new: Sequence[int],
                chunk_tokens: int) -> np.ndarray:
    """(C,) bool digest-diff between two same-slot contents - the
    single measured-dirty-set implementation (store commits and the
    broker's mid-batch chaining both use it)."""
    old = [chunk_digest(c) for c in split_chunks(cur, chunk_tokens)]
    fresh = [chunk_digest(c) for c in split_chunks(new, chunk_tokens)]
    if len(fresh) != len(old):
        raise ValueError(
            f"write changes chunk count: {len(old)} -> {len(fresh)} "
            f"(fixed-slot artifacts only)")
    return np.array([a != b for a, b in zip(old, fresh)], bool)


class ChunkStore:
    """Content-addressed chunk index layered over an ``ArtifactStore``.

    The wrapped store stays the canonical whole-artifact content plane
    (``store.get`` is always the authority copy); this index maps every
    artifact to its current chunk-digest vector and deduplicates chunk
    payloads by digest, so identical chunks across versions (or across
    artifacts) are stored once and a delta response is assembled by
    digest lookup.
    """

    def __init__(self, store, chunk_tokens: int) -> None:
        self.store = store
        self.chunk_tokens = int(chunk_tokens)
        self._digests: Dict[str, List[str]] = {}
        self._payloads: Dict[str, Tuple[int, ...]] = {}

    # ------------------------------------------------------------ index
    def register(self, name: str) -> None:
        """Index the store's current content for ``name``."""
        chunks = split_chunks(self.store.get(name), self.chunk_tokens)
        digests = []
        for c in chunks:
            dg = chunk_digest(c)
            self._payloads[dg] = c
            digests.append(dg)
        self._digests[name] = digests

    def n_chunks_of(self, name: str) -> int:
        return len(self._digests[name])

    @property
    def n_unique_chunks(self) -> int:
        """Deduplicated payload count (content-addressing at work)."""
        return len(self._payloads)

    # ------------------------------------------------------------ write
    def diff_mask(self, name: str, new_content: Sequence[int]
                  ) -> np.ndarray:
        """(C,) bool: chunks whose digest would change if ``name`` were
        rewritten to ``new_content`` - the *actual* dirty set a live
        write carries (the simulator samples this; the service measures
        it)."""
        old = self._digests[name]
        new = [chunk_digest(c)
               for c in split_chunks(new_content, self.chunk_tokens)]
        if len(new) != len(old):
            raise ValueError(
                f"write changes chunk count of {name!r}: {len(old)} -> "
                f"{len(new)} (fixed-slot artifacts only)")
        return np.array([a != b for a, b in zip(old, new)], bool)

    def put(self, name: str, new_content: Sequence[int]) -> np.ndarray:
        """Commit ``new_content``; returns the (C,) bool dirty mask."""
        mask = self.diff_mask(name, new_content)
        self.store.put(name, list(new_content))
        self.register(name)
        return mask

    # ------------------------------------------------------------- read
    def chunk(self, name: str, idx: int) -> Tuple[int, ...]:
        return self._payloads[self._digests[name][int(idx)]]

    def delta(self, name: str, indices) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
        """Delta payload: ((chunk_idx, chunk_tokens), ...) for the
        requested stale chunk indices."""
        return tuple((int(i), self.chunk(name, i)) for i in indices)

    def reassembled(self, name: str) -> Tuple[int, ...]:
        """Rebuild the artifact from its chunk index (must equal the
        wrapped store's canonical copy - asserted by the oracle)."""
        return reassemble(self.chunk(name, i)
                          for i in range(len(self._digests[name])))
