"""Sharding rules: param, optimizer, batch and cache specs, with the JAX
package's names and rules (``repro.runtime.sharding``).

Parallelism mapping on the production mesh (pod, data, model):
  * DP   - batch over ('pod', 'data'); gradients averaged there.
  * TP   - 'model' axis: attention head projections, FFN hidden dim,
           vocab rows, Mamba inner channels, RWKV head channels.
  * EP   - MoE expert dim over 'model'.
  * ZeRO - optimizer moments additionally sharded over 'data' on the
           dim the param is replicated on (see :func:`zero_spec`).

A spec is a plain tuple with one entry per leading tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split
over those axes, the first outermost); ``()`` replicates the whole
tensor.  It equals, entry for entry, the reference's ``PartitionSpec``
taken as a tuple.  A mesh is anything :func:`launch.mesh.mesh_axes`
reads: a ``DeviceMesh`` or a ``{axis: size}`` mapping.

Rules pattern-match flattened param paths, so they apply equally to
raw params, stacked params (a leading layer dim gets ``None``) and
optimizer moments (the same tree).  The port's attention K / V caches
are head-major, (..., Hkv, L, D) where the reference keeps
(..., L, Hkv, D): :func:`cache_specs` gives each of their dims the
entry the reference gives the same dim.
"""

from __future__ import annotations

import re
from typing import Optional

from repro_torch.launch.mesh import mesh_axes

#: (regex on path, spec for the unstacked rank); leading layer or
#: superblock dims are padded with None
_RULES: list[tuple[str, Optional[tuple]]] = [
    # embeddings / lm head: shard vocab rows
    (r"(^|/)(embed|lm_head)$", ("model", None)),
    # attention projections
    (r"/(wq|wk|wv)$", (None, "model")),
    (r"/w_dq$", (None, "model")),
    (r"/(w_uk|w_uv)$", (None, "model")),
    (r"/w_dkv$", (None, None)),          # latent rank is small: replicate
    (r"/(wo|w_o)$", ("model", None)),
    # GLU / dense MLPs
    (r"/(w_gate|w_up|w_in)$", (None, "model")),
    (r"/(w_down|w_out)$", ("model", None)),
    (r"/(b_gate|b_up|b_in)$", ("model",)),
    # MoE: expert-parallel over the expert dim; router replicated
    (r"/ffn/router$", (None, None)),
    (r"/(expert_gate|expert_up|expert_down)$",
     ("model", None, None)),
    (r"/(shared_gate|shared_up)$", (None, "model")),
    (r"/shared_down$", ("model", None)),
    # Mamba: shard the expanded inner dim
    (r"/conv_w$", (None, "model")),
    (r"/conv_b$", ("model",)),
    (r"/w_x_dbc$", ("model", None)),
    (r"/w_dt$", (None, "model")),
    (r"/dt_bias$", ("model",)),
    (r"/a_log$", ("model", None)),
    (r"/d_skip$", ("model",)),
    # RWKV time/channel mix
    (r"/(w_r|w_k|w_v|w_g)$", (None, "model")),
    (r"/(mix_lora_a|mix_lora_b|decay_lora_a|decay_lora_b)$", None),
    (r"/bonus$", ("model", None)),       # heads dim
    # everything small (norms, biases, gates, scalar params): replicate
]

#: the port's head-major cache leaves
HEAD_MAJOR = ("k", "v", "xk", "xv", "enc_k", "enc_v")


def spec_for(path: str, ndim: int) -> tuple:
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            if spec is None:
                return ()
            pad = ndim - len(spec)
            if pad < 0:   # scalar or unexpectedly low rank: replicate
                return ()
            return (None,) * pad + tuple(spec)
    return ()


def flatten_with_paths(tree, prefix=""):
    """``(path, leaf)`` of a nested dict (keys sorted) or list."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flatten_with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def unflatten_like(tree, flat: dict, prefix=""):
    """A tree shaped like ``tree`` whose leaves are ``flat[path]``."""
    if isinstance(tree, dict):
        return {k: unflatten_like(v, flat, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [unflatten_like(v, flat, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return flat[prefix]


def _map_paths(fn, tree):
    flat = dict(flatten_with_paths(tree))
    return unflatten_like(tree, {p: fn(p, v) for p, v in flat.items()})


def param_specs(params_shape) -> dict:
    """A tree of specs matching a params (shape) tree."""
    return _map_paths(lambda p, v: spec_for(p, len(v.shape)), params_shape)


def zero_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """ZeRO-1: additionally shard the largest replicated dim over
    'data' when divisible (applied to optimizer moments only)."""
    data = mesh_axes(mesh)["data"]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (s, dim) in enumerate(zip(parts, shape)):
        if s is None and dim % data == 0 and dim > best_size:
            best, best_size = i, dim
    if best is None:
        return spec
    parts[best] = "data"
    return tuple(parts)


def fsdp_param_specs(params_shape, mesh) -> dict:
    """FSDP / ZeRO-3: params sharded over 'data' on top of TP, gathered
    at use."""
    return _map_paths(
        lambda p, v: zero_spec(spec_for(p, len(v.shape)), tuple(v.shape),
                               mesh), params_shape)


def opt_state_specs(params_shape, mesh, zero: bool = True):
    """Specs of the AdamW moments (each a tree like params)."""
    def one(p, v):
        base = spec_for(p, len(v.shape))
        return zero_spec(base, tuple(v.shape), mesh) if zero else base
    return _map_paths(one, params_shape)


# --------------------------- batch / cache ---------------------------

def dp_axes(mesh) -> tuple:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def _usable_dp(b: int, axes: dict, dp: tuple) -> list:
    """The DP axes, outermost first, whose running product divides b."""
    usable, prod = [], 1
    for a in dp:
        if b % (prod * axes[a]) == 0:
            usable.append(a)
            prod *= axes[a]
    return usable


def _entry(usable: list):
    """The spec entry of a dim over ``usable`` axes: one axis by its
    name (as ``PartitionSpec`` normalizes a 1-tuple), more as a tuple."""
    return usable[0] if len(usable) == 1 else tuple(usable)


def batch_specs(batch_shape, mesh, batch_dim: int = 0) -> dict:
    """Shard the batch dim of every input over DP axes.  ``batch_dim``
    is 1 for microbatch-pre-split inputs (nm, B/nm, ...): the scan dim
    stays unsharded."""
    axes, dp = mesh_axes(mesh), dp_axes(mesh)

    def one(_, x):
        if not hasattr(x, "shape") or len(x.shape) <= batch_dim:
            return ()
        usable = _usable_dp(x.shape[batch_dim], axes, dp)
        parts = [None] * len(x.shape)
        if usable:
            parts[batch_dim] = _entry(usable)
        return tuple(parts)

    return _map_paths(one, batch_shape)


def _reference_cache_spec(leaf: str, shape: tuple, axes: dict,
                          dp: tuple) -> tuple:
    """The reference's spec of a cache leaf of ``shape`` in the
    reference's layout.  Index 1 is taken as the batch dim whatever the
    rank, so an unstacked prefix layer's (B, T, ...) cache has its time
    dim sharded over the DP axes where T divides (the reference's
    behaviour, kept)."""
    model = axes.get("model", 1)
    nd = len(shape)
    if nd == 0:
        return ()
    if nd == 1:
        return (None,)
    parts = [None] * nd
    usable = _usable_dp(shape[1], axes, dp)
    if usable:
        parts[1] = _entry(usable)
    if leaf in HEAD_MAJOR and nd >= 5:
        # (L, B, T, H, D)
        if shape[3] % model == 0:
            parts[3] = "model"
        elif shape[2] % model == 0:
            parts[2] = "model"
    elif leaf in ("ckv", "kpe") and nd >= 4:
        if shape[2] % model == 0:        # latent stream: time over model
            parts[2] = "model"
    elif leaf in ("conv", "ssm", "wkv", "tm", "cm") and nd >= 3:
        if shape[2] % model == 0:        # channels / heads
            parts[2] = "model"
    return tuple(parts)


def cache_specs(cache_shape, cfg, mesh) -> dict:
    """Decode-cache sharding: batch over DP axes when divisible; head
    dims of K / V over 'model' when divisible, else their time dim;
    latent caches' time and recurrent states' channels over 'model'.
    A head-major K / V leaf's spec is computed on its shape in the
    reference's order, then its time and head entries are swapped
    back."""
    axes, dp = mesh_axes(mesh), dp_axes(mesh)

    def one(path, x):
        leaf = path.rsplit("/", 1)[-1]
        shape = tuple(x.shape)
        swap = leaf in HEAD_MAJOR and len(shape) >= 3
        if swap:
            shape = shape[:-3] + (shape[-2], shape[-3], shape[-1])
        parts = _reference_cache_spec(leaf, shape, axes, dp)
        if swap:
            parts = parts[:-3] + (parts[-2], parts[-3], parts[-1])
        return parts

    return _map_paths(one, cache_shape)


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(spec: tuple, shape: tuple, mesh) -> tuple:
    """A rank's shard shape of a ``shape`` tensor under ``spec``: each
    dim divided by the product of its entry's axis sizes."""
    axes = mesh_axes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in axes_of(entry):
            out[i] //= axes[a]
    return tuple(out)


def to_placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` over a ``DeviceMesh``: per mesh
    dim, ``Shard(d)`` where the spec's entry of tensor dim d names that
    mesh axis, else ``Replicate()`` (the reference's ``to_named``)."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        for a in axes_of(entry):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)

