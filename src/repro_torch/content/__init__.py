"""Chunk-granular content plane: delta coherence below MESI's
whole-artifact granularity.

Geometry + host-side content-addressed store live in
:mod:`repro_torch.content.chunks`; the per-chunk version/dirty state
machine is threaded through ``repro_torch.core.acs`` (scan route) and
``repro_torch.kernels.chunk_diff`` (CUDA kernel); the byte-exact
differential harness is ``repro_torch.sim.oracle.check_content_trace``.
"""

from repro_torch.content.chunks import (BYTES_PER_TOKEN, ChunkStore,
                                        apply_delta, chunk_digest,
                                        chunk_sizes, n_chunks, reassemble,
                                        split_chunks)

__all__ = [
    "BYTES_PER_TOKEN", "ChunkStore", "apply_delta", "chunk_digest",
    "chunk_sizes", "n_chunks", "reassemble", "split_chunks",
]
