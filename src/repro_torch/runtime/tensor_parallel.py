"""Tensor-parallel serving over a mesh's 'model' axis, for every family
(the JAX package's prefill and decode steps over a mesh whose 'model'
axis is above 1).

The reference shards params by ``param_specs`` and caches by
``cache_specs`` and leaves the collectives to XLA's SPMD partitioner.
The port runs eagerly, so this module does the partitioner's part:

* :func:`shard_params` cuts, as a copy, each rank's contiguous block of
  every leaf whose spec has a 'model' entry (the attention and MLA head
  projections, the FFN's hidden dim, the MoE's experts and shared
  hidden dim, Mamba's inner channels, RWKV's heads, the vocab rows),
  with the q / k / v biases cut as their projections;
  :func:`gather_params` puts the blocks back together;
* :func:`init_cache` gives each rank the cache of its K / V heads, Mamba
  channels and RWKV heads, and of its batch rows where 'data' > 1
  (``batch_specs``' split); MLA's latent and RWKV's token shifts whole;
* under :func:`using`, the active groups that the model code reads
  (:func:`active`), every output projection (attention, MLA, the
  encoder's, RWKV's ``w_o``, Mamba's ``w_out``) and every down
  projection (the GLU's, whisper's MLP, the MoE's experts and shared
  experts, RWKV's channel mix) is row-parallel, each rank's partial
  product summed over 'model' before a bias is added (:func:`reduce`);
  the embedding lookup is vocab-parallel (each rank's vocab range, zeros
  elsewhere, summed: exact in any float type, :func:`embed`); the head's
  logits are each rank's vocab slice, gathered on the last dim so that
  every rank returns whole logits (:func:`gather_vocab`).

Rank r holds q heads [r Hq / tp, (r + 1) Hq / tp) and exactly the K / V
heads those read: its contiguous block of ``wk`` and ``wv`` where tp
divides Hkv, and where Hkv divides tp (fewer K / V heads than ranks)
the one head r Hkv // tp, which tp / Hkv ranks hold alike.  There the
reference's spec splits a head's channels, and its cache spec the time
axis: the port computes the same function with another layout.  Any
other head count raises ``ValueError``.  The other families:

* MoE (expert parallelism): rank r holds experts [r E / tp, (r + 1) E /
  tp) and its block of the shared experts' hidden dim; the router is
  whole, so every rank routes every token of its rows as one device
  does, with the reference's capacity and slot positions over the
  global batch (under 'data' > 1 the ranks' expert choices are gathered
  over the DP axes, :func:`gather_rows`), and runs only its own
  experts' buffers;
* MLA: rank r holds its heads' columns of ``w_dq``, ``w_uk`` and
  ``w_uv``; the latent cache (``ckv``, ``kpe``) stays whole on every
  rank (the reference's cache spec splits its time axis: the same
  function in another layout), and each rank expands only its heads;
* Mamba: rank r holds inner channels [r D / tp, (r + 1) D / tp) of x and
  the same channels of the gate z, its ``w_in`` block laid out [x_r |
  z_r] (``PAIRED``: the spec's one contiguous block would give rank 0
  all of x at tp 2); ``w_x_dbc``'s partial products are summed before
  dt, b and c are taken from them;
* RWKV: the time mix's heads; ``ln_x``, an RMSNorm over all d channels,
  runs on the heads gathered over 'model' (:func:`gather_heads`, exact)
  and each rank keeps its own channels (:func:`own`); the channel mix
  holds ``w_k``'s d_ff columns, ``w_v``'s d_ff rows and ``w_r`` whole
  (``ROW_LEAVES``, ``WHOLE_LEAVES``: the specs split ``w_v``'s and
  ``w_r``'s output d, which would take two gathers where this takes one
  sum);
* whisper: the encoder's heads and MLP channels as the decoder's, the
  cross caches by heads.

Training does not split over 'model' (ROADMAP §1 item 9c): it raises
``NotImplementedError`` (:func:`refuse`).

Every collective is an ``all_reduce`` over a group; a gather is the
``all_reduce`` of a zero-filled buffer that holds this rank's block
(:func:`gather`), exact in any float or integer type.  That one
collective serves gloo, whose CUDA support covers ``all_reduce`` (two
ranks on one card), and NCCL alike.

Without an active group the model code runs the one-device code:
:func:`reduce`, :func:`gather_vocab`, :func:`gather_heads`, :func:`own`
and :func:`gather_rows` return their input and :func:`embed` is the
plain lookup.
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

#: the 'model' group the model code splits over and the DP groups that
#: split the rows, outermost first (None: one device)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "tensor_parallel_group", default=None)

#: leaves cut by K / V heads (the rest of a split leaf by even blocks)
KV_LEAVES = ("wk", "wv", "bk", "bv")
#: bias leaves that the specs replicate but that follow their
#: projection's heads
HEAD_BIASES = ("bq", "bk", "bv")
#: leaves whose split dim holds two halves, each cut in blocks: Mamba's
#: ``w_in``, [x | z]
PAIRED = ("mixer/w_in",)
#: leaves the port splits by rows where the specs split the columns:
#: RWKV's channel-mix value projection (d_ff, d)
ROW_LEAVES = ("ffn/w_v",)
#: leaves the port keeps whole where the specs split them: RWKV's
#: channel-mix receptance (d, d)
WHOLE_LEAVES = ("ffn/w_r",)
#: cache leaves split over 'model' by a dim other than the K / V heads:
#: Mamba's conv state (..., d_conv - 1, D) and scan state (..., D, N),
#: RWKV's WKV state (..., H, dh, dh)
CACHE_DIMS = {"conv": -1, "ssm": -2, "wkv": -3}


@dataclasses.dataclass(frozen=True)
class _Groups:
    model: AxisGroup
    rows: tuple


def active() -> Optional[AxisGroup]:
    """The active 'model' group, None outside :func:`using`."""
    groups = _ACTIVE.get()
    return None if groups is None else groups.model


@contextlib.contextmanager
def using(group: AxisGroup, rows: tuple = ()):
    """Inside ``with using(group, rows):`` the model code splits over
    ``group``; ``rows`` are the DP axes' groups that split the batch
    rows, outermost first (none: every rank holds every row)."""
    token = _ACTIVE.set(_Groups(group, tuple(rows)))
    try:
        yield group
    finally:
        _ACTIVE.reset(token)


def refuse() -> None:
    """Raises ``NotImplementedError``: training does not split over
    'model' (ROADMAP §1 item 9c); serving splits every family."""
    raise NotImplementedError(
        "tensor parallelism ('model' > 1) is not ported to training "
        "(ROADMAP §1 item 9c); the serving steps split every family over "
        "'model'")


def local_kv_heads(cfg: ModelConfig, tp: int) -> int:
    """A rank's K / V heads over ``tp`` ranks; ``ValueError`` where the
    heads do not split (q heads not a multiple of tp, or K / V heads
    neither a multiple nor a divisor of it)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % tp or (hkv % tp and tp % hkv):
        raise ValueError(
            f"{cfg.name}: {hq} q heads and {hkv} K/V heads do not split "
            f"over {tp} ranks (q heads a multiple of tp, K/V heads a "
            f"multiple or a divisor of it)")
    return max(1, hkv // tp)


def _is(path: str, names) -> bool:
    return any(path.endswith("/" + n) for n in names)


def _model_dim(path: str, x) -> Optional[int]:
    """The dim of a leaf that is split over 'model' (None: whole)."""
    if _is(path, WHOLE_LEAVES):
        return None
    if _is(path, ROW_LEAVES):
        return x.ndim - 2
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
    local_kv_heads(cfg, g.size)

    def cut(path, x, dim):
        start, n = _block(cfg, path, x.shape[dim], g.size, g.index)
        return x.narrow(dim, start, n)

    def one(path, x):
        dim = _model_dim(path, x)
        if dim is not None and _is(path, PAIRED):
            x = torch.cat([cut(path, h, dim) for h in x.chunk(2, dim)], dim)
        elif dim is not None:
            x = cut(path, x, dim)
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
        elif _is(path, PAIRED):     # [x_0 | z_0 | x_1 | z_1 ...]
            parts = whole.chunk(2 * g.size, dim)
            whole = torch.cat(parts[0::2] + parts[1::2], dim)
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
    or over 'model' 1 (``transformer.init_cache``), else this rank's: its
    rows, K / V heads, Mamba channels and RWKV heads (``CACHE_DIMS``)."""
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.models import transformer as tf
    if mesh is None or mesh_axes(mesh).get("model", 1) == 1:
        return tf.init_cache(cfg, batch, max_len, ctx_len, device)
    tp = mesh_axes(mesh)["model"]
    dev = resolve_device(device)
    local = dataclasses.replace(cfg, n_kv_heads=local_kv_heads(cfg, tp))
    shapes = tf.init_cache(local, local_rows(batch, mesh), max_len, ctx_len,
                           "meta")

    def one(path, x):
        shape = list(x.shape)
        dim = CACHE_DIMS.get(path.rsplit("/", 1)[-1])
        if dim is not None:
            if shape[dim] % tp:
                raise ValueError(f"{path}: a dim of {shape[dim]} does not "
                                 f"split over {tp} ranks")
            shape[dim] //= tp
        return torch.zeros(shape, dtype=x.dtype, device=dev)

    return shd.unflatten_like(shapes, {p: one(p, x) for p, x in
                                       shd.flatten_with_paths(shapes)})


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
    g = active()
    if g is not None:
        dist.all_reduce(y, group=g.group)
    return y


def block_start(n: int) -> int:
    """Where this rank's block of ``n`` starts along a split dim (0
    without an active group)."""
    g = active()
    return 0 if g is None else g.index * n


def own(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor every rank holds whole
    (``x`` itself without an active group)."""
    g = active()
    if g is None:
        return x
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.index * n, n)


def gather_heads(x: torch.Tensor) -> torch.Tensor:
    """Every rank's channels of ``x`` joined on the last dim (``x``
    itself without an active group)."""
    g = active()
    return x if g is None else gather(x, -1, g)


def gather_rows(x: torch.Tensor, rows=None) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0) in the global batch's order:
    gathered over ``rows`` (default: the active DP groups), the
    innermost first."""
    if rows is None:
        groups = _ACTIVE.get()
        rows = () if groups is None else groups.rows
    for g in reversed(rows):
        x = gather(x, 0, g)
    return x


def row_span(t: int) -> tuple:
    """(the global batch's tokens, the first of this rank's) for a rank
    holding ``t`` tokens of its rows under the active DP groups."""
    groups = _ACTIVE.get()
    index, n = 0, 1
    for g in () if groups is None else groups.rows:
        index, n = index * g.size + g.index, n * g.size
    return t * n, t * index


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``; under an active group ``table``
    is this rank's vocab range, the rows of tokens outside it are 0, and
    the ranks' rows are summed."""
    g = active()
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
    g = active()
    return logits if g is None else gather(logits, -1, g)
