"""Authority-shard placement on one card.

The JAX package pins each of the sharded authority plane's K brokers
to its own device (``repro.launch.mesh.shard_devices``), so every
shard's micro-batch decision runs as its own device program.  The port
runs on one H100 and gives each shard its own CUDA stream on that card
instead: every shard's directory is allocated on its stream and every
one of its decisions (batch upload, ticks, read-back) is queued there.
The JAX module's pod meshes have no counterpart here yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_device


def shard_streams(n_shards: int, device=None) -> tuple:
    """K streams for K authority shards on ``device`` (``None``: CUDA):
    a new ``torch.cuda.Stream`` each on a CUDA device, ``None`` each on
    the CPU (where nothing is queued)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (None,) * int(n_shards)
    return tuple(torch.cuda.Stream(device=dev) for _ in range(int(n_shards)))
