"""Tensor-parallel serving over a mesh's 'model' axis, for the dense and
vision families (the JAX package's prefill and decode steps over a mesh
whose 'model' axis is above 1).

The reference shards params by ``param_specs`` and caches by
``cache_specs`` and leaves the collectives to XLA's SPMD partitioner.
The port runs eagerly, so this module does the partitioner's part:

* :func:`shard_params` cuts, as a copy, each rank's contiguous block of
  every leaf whose spec has a 'model' entry (the q / k / v / output
  projections' heads, the FFN's hidden dim, the vocab rows), with the
  q / k / v biases cut as their projections; :func:`gather_params` puts
  the blocks back together;
* :func:`init_cache` gives each rank the cache of its K / V heads, and
  of its batch rows where 'data' > 1 (``batch_specs``' split);
* under :func:`using`, the active group that the model code reads
  (:func:`active`), the attention's output projection and the FFN's
  down projection are row-parallel, each rank's partial product summed
  over 'model' before a bias is added (:func:`reduce`); the embedding
  lookup is vocab-parallel (each rank's vocab range, zeros elsewhere,
  summed: exact in any float type, :func:`embed`); the head's logits
  are each rank's vocab slice, gathered on the last dim so that every
  rank returns whole logits (:func:`gather_vocab`).

Rank r holds q heads [r Hq / tp, (r + 1) Hq / tp) and exactly the K / V
heads those read: its contiguous block of ``wk`` and ``wv`` where tp
divides Hkv, and where Hkv divides tp (fewer K / V heads than ranks)
the one head r Hkv // tp, which tp / Hkv ranks hold alike.  There the
reference's spec splits a head's channels, and its cache spec the time
axis: the port computes the same function with another layout.  Any
other head count raises ``ValueError``; the families this slice does
not split (MoE, MLA, Mamba, RWKV, whisper) raise ``NotImplementedError``
(:func:`refuse`).

Every collective is an ``all_reduce`` over the group; a gather is the
``all_reduce`` of a zero-filled buffer that holds this rank's block
(:func:`gather`), exact in any float type.  That one collective serves
gloo, whose CUDA support covers ``all_reduce`` (two ranks on one card),
and NCCL alike.

Without an active group the model code runs the one-device code:
:func:`reduce` and :func:`gather_vocab` return their input and
:func:`embed` is the plain lookup.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import AxisGroup, axis_group, mesh_axes
from repro_torch.runtime import sharding as shd

#: the 'model' group the model code splits over (None: one device)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "tensor_parallel_group", default=None)

#: leaves cut by K / V heads (the rest of a split leaf by even blocks)
KV_LEAVES = ("wk", "wv", "bk", "bv")
#: bias leaves that the specs replicate but that follow their
#: projection's heads
HEAD_BIASES = ("bq", "bk", "bv")


def active() -> Optional[AxisGroup]:
    """The active 'model' group, None outside :func:`using`."""
    return _ACTIVE.get()


@contextlib.contextmanager
def using(group: AxisGroup):
    """Inside ``with using(group):`` the model code splits over
    ``group``."""
    token = _ACTIVE.set(group)
    try:
        yield group
    finally:
        _ACTIVE.reset(token)


def refuse(cfg: ModelConfig) -> None:
    """Raises ``NotImplementedError`` for a model with a part this slice
    does not split over 'model'."""
    parts = [name for name, on in (
        ("the MoE feed-forward (expert parallelism)", cfg.moe is not None),
        ("MLA", cfg.mla is not None),
        ("the Mamba mixer", cfg.mamba is not None),
        ("the RWKV mixer", cfg.rwkv is not None),
        ("whisper's encoder and audio MLP",
         cfg.family == "audio" or cfg.encoder_layers > 0)) if on]
    if parts:
        raise NotImplementedError(
            f"{cfg.name}: tensor-parallel serving of {', '.join(parts)} "
            f"is not ported (ROADMAP §1 item 9b); only the dense and "
            f"vision families split over 'model'")


def local_kv_heads(cfg: ModelConfig, tp: int) -> int:
    """A rank's K / V heads over ``tp`` ranks; ``ValueError`` where the
    heads do not split (q heads not a multiple of tp, or K / V heads
    neither a multiple nor a divisor of tp)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % tp or (hkv % tp and tp % hkv):
        raise ValueError(
            f"{cfg.name}: {hq} q heads and {hkv} K/V heads do not split "
            f"over {tp} ranks (q heads a multiple of tp, K/V heads a "
            f"multiple or a divisor of it)")
    return max(1, hkv // tp)


def _model_dim(path: str, x) -> Optional[int]:
    """The dim of a leaf that is split over 'model' (None: replicated)."""
    for d, entry in enumerate(shd.spec_for(path, x.ndim)):
        if "model" in shd.axes_of(entry):
            return d
    if path.rsplit("/", 1)[-1] in HEAD_BIASES:
        return x.ndim - 1
    return None


def _block(cfg: ModelConfig, path: str, size: int, tp: int,
           index: int) -> tuple:
    """(start, length) of rank ``index``'s block of a split dim."""
    if path.rsplit("/", 1)[-1] in KV_LEAVES and cfg.n_kv_heads < tp:
        hd = cfg.kv_head_dim()
        return index * cfg.n_kv_heads // tp * hd, hd
    if size % tp:
        raise ValueError(f"{path}: a dim of {size} does not split over "
                         f"{tp} ranks")
    return index * (size // tp), size // tp


def shard_params(cfg: ModelConfig, params, mesh) -> dict:
    """This rank's params over the mesh's 'model' axis, as copies: each
    split leaf its block (module docstring), every other leaf whole."""
    g = axis_group(mesh)
    refuse(cfg)
    local_kv_heads(cfg, g.size)

    def one(path, x):
        dim = _model_dim(path, x)
        if dim is not None:
            start, n = _block(cfg, path, x.shape[dim], g.size, g.index)
            x = x.narrow(dim, start, n)
        return x.clone(memory_format=torch.contiguous_format)

    return shd.unflatten_like(params, {p: one(p, x) for p, x in
                                       shd.flatten_with_paths(params)})


def gather_params(cfg: ModelConfig, params, mesh) -> dict:
    """Whole params from every rank's :func:`shard_params` (a
    collective; a K / V head that several ranks hold is taken once)."""
    g = axis_group(mesh)

    def one(path, x):
        dim = _model_dim(path, x)
        if dim is None:
            return x
        whole = gather(x, dim, g)
        if path.rsplit("/", 1)[-1] in KV_LEAVES and cfg.n_kv_heads < g.size:
            whole = torch.cat(whole.chunk(g.size, dim)[
                ::g.size // cfg.n_kv_heads], dim)
        return whole

    return shd.unflatten_like(params, {p: one(p, x) for p, x in
                                       shd.flatten_with_paths(params)})


def row_axes(batch: int, mesh) -> tuple:
    """The DP axes, outermost first, that ``batch_specs`` splits a
    ``batch``-row input over (none: every rank holds every row)."""
    spec = shd.batch_specs(torch.empty((batch,), device="meta"), mesh)
    return shd.axes_of(spec[0] if spec else None)


def local_rows(batch: int, mesh) -> int:
    """A rank's rows of a ``batch``-row input, as ``batch_specs`` splits
    them."""
    axes = mesh_axes(mesh)
    return batch // math.prod(axes[a] for a in row_axes(batch, mesh))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               ctx_len: int = 0, mesh=None, device=None) -> dict:
    """An empty cache for ``batch`` rows: the whole cache without a mesh
    or over 'model' 1 (``transformer.init_cache``), else this rank's, its
    K / V heads and its rows."""
    from repro_torch.models import transformer as tf
    if mesh is None or mesh_axes(mesh).get("model", 1) == 1:
        return tf.init_cache(cfg, batch, max_len, ctx_len, device)
    tp = mesh_axes(mesh)["model"]
    refuse(cfg)
    local = dataclasses.replace(cfg, n_kv_heads=local_kv_heads(cfg, tp))
    return tf.init_cache(local, local_rows(batch, mesh), max_len, ctx_len,
                         device)


# ---------------------------- collectives ----------------------------

def gather(x: torch.Tensor, dim: int, g: AxisGroup) -> torch.Tensor:
    """The group's blocks of ``x`` joined along ``dim`` in index order:
    the ``all_reduce`` of a zero-filled buffer holding this rank's."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * g.size
    out = x.new_zeros(shape)
    out.narrow(dim, g.index * n, n).copy_(x)
    dist.all_reduce(out, group=g.group)
    return out


def reduce(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums added over the active group
    (in place); ``y`` itself without one."""
    g = _ACTIVE.get()
    if g is not None:
        dist.all_reduce(y, group=g.group)
    return y


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``; under an active group ``table``
    is this rank's vocab range, the rows of tokens outside it are 0, and
    the ranks' rows are summed."""
    g = _ACTIVE.get()
    if g is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - g.index * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)], 0)
    dist.all_reduce(x, group=g.group)
    return x


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Whole logits from each rank's vocab slice under an active group;
    ``logits`` itself without one."""
    g = _ACTIVE.get()
    return logits if g is None else gather(logits, -1, g)
