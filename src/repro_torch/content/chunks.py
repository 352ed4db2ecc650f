"""Chunk geometry of the content plane.

An artifact is a fixed array of ``n_chunks`` chunks of ``chunk_tokens``
tokens each (the last chunk may be ragged).  The simulator and the
chunk-diff kernel track per-chunk version counters and account delta
bytes-on-wire from this geometry without materializing content.

Wire accounting uses ``BYTES_PER_TOKEN`` so the ledgers read in bytes;
the constant cancels in every savings ratio.
"""

from __future__ import annotations

import numpy as np

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


def chunk_sizes(artifact_tokens: int, chunk_tokens: int) -> np.ndarray:
    """(C,) int32 token size per chunk; sums to ``artifact_tokens``."""
    C = n_chunks(artifact_tokens, chunk_tokens)
    sizes = np.full(C, chunk_tokens, np.int32)
    sizes[-1] = artifact_tokens - (C - 1) * chunk_tokens
    return sizes
