"""Chunk-granular content plane: chunk geometry.  The per-chunk
version/dirty state machine is threaded through
``repro_torch.core.acs`` (scan route) and
``repro_torch.kernels.chunk_diff`` (CUDA kernel)."""

from repro_torch.content.chunks import BYTES_PER_TOKEN, chunk_sizes, n_chunks

__all__ = ["BYTES_PER_TOKEN", "chunk_sizes", "n_chunks"]
