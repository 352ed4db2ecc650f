"""Device meshes: the JAX package's pod meshes over a
``torch.distributed`` world, and the authority shards' placement over
the host's cards.

* :func:`make_production_mesh`, :func:`make_host_mesh` and
  :func:`make_sweep_mesh` give a ``torch.distributed.device_mesh.
  DeviceMesh`` with the reference's shape and axis names, built by
  ``init_device_mesh`` over the process group that is initialized (on
  CUDA unless the caller asks for the CPU).  Each needs a world of
  exactly its size and raises without one: a mesh is never shrunk to
  what the world has.  The 256- and 512-rank meshes exist only as
  data on one host (in tests, over PyTorch's fake process group).
* :func:`mesh_axes` is the reference's ``mesh.shape`` mapping ``{axis:
  size}``; the sharding rules and the dry-run read only that, so they
  also take a plain mapping.
* :func:`shard_devices`: the sharded authority plane's K brokers over
  the host's cards, round-robin over ``min(K, cards)`` as the
  reference's ``repro.launch.mesh.shard_devices`` pins them to devices,
  each shard with a CUDA stream of its own on its card: every shard's
  directory is allocated on its stream and every one of its decisions
  (batch upload, ticks, read-back) is queued there.  On one card the K
  shards are K streams of it (:func:`shard_streams`).
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional

import torch

from repro_torch.kernels.backend import resolve_device

#: the pods' mesh shapes and axis names (``repro.launch.mesh``)
POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTI_POD_SHAPE, MULTI_POD_AXES = (2, 16, 16), ("pod", "data", "model")


def _mesh(shape: tuple, axes: tuple, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    world, which must have exactly ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"a {dict(zip(axes, shape))} mesh needs a process group of "
            f"{need} ranks; "
            + ("none is initialized" if have is None
               else f"the initialized one has {have}"))
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """One pod: (data 16, model 16), 256 ranks.  Two pods: (pod 2,
    data 16, model 16), 512 ranks; 'pod' is an outer data-parallel
    axis."""
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device)
    return _mesh(POD_SHAPE, POD_AXES, device)


def make_host_mesh(device=None):
    """The one-rank (data 1, model 1) mesh, with the pod's axis names."""
    return _mesh((1, 1), POD_AXES, device)


def make_sweep_mesh(n_devices: Optional[int] = None,
                    axis_name: str = "runs", device=None):
    """The 1-D mesh of the fleet sweep over ``n_devices`` ranks (None:
    the whole world)."""
    if n_devices is None:
        import torch.distributed as dist
        n_devices = dist.get_world_size() if dist.is_initialized() else 0
    return _mesh((int(n_devices),), (axis_name,), device)


def mesh_axes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh``, or of a mapping given as
    one (the reference's ``mesh.shape``)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def shard_streams(n_shards: int, device=None) -> tuple:
    """K streams for K authority shards on ``device`` (``None``: CUDA):
    a new ``torch.cuda.Stream`` each on a CUDA device, ``None`` each on
    the CPU (where nothing is queued)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (None,) * int(n_shards)
    return tuple(torch.cuda.Stream(device=dev) for _ in range(int(n_shards)))


def shard_cards(n_shards: int, n_cards: int) -> tuple:
    """The reference's round-robin: shard ``s`` of K on card ``s %
    min(K, n_cards)``."""
    n = max(1, min(int(n_shards), int(n_cards)))
    return tuple(s % n for s in range(int(n_shards)))


def shard_devices(n_shards: int, device=None) -> tuple:
    """``(device, stream)`` for each of K authority shards on ``device``
    (``None``: CUDA).  On CUDA shard ``s`` gets card ``shard_cards(K,
    cards)[s]`` of the host's cards (every shard the named card when
    ``device`` has an index) and a new ``torch.cuda.Stream`` on it; on
    the CPU ``(cpu, None)`` each (nothing is queued)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ((dev, None),) * int(n_shards)
    if dev.index is not None:
        cards = (dev.index,) * int(n_shards)
    else:
        cards = shard_cards(n_shards, torch.cuda.device_count())
    return tuple((torch.device("cuda", c),
                  torch.cuda.Stream(device=torch.device("cuda", c)))
                 for c in cards)
