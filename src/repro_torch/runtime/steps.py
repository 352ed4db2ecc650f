"""Step factories: train / prefill / decode, with the JAX package's names
(``repro.runtime.steps``).

The reference returns jitted functions with their shardings; the port
runs eagerly, so each factory returns the step function alone.
Gradients come from ``torch.autograd.grad`` over the param leaves, each
set to require a gradient; on the card the model's attention and
RMSNorm run through their backward kernels.  The optimizer updates
params and moments in place (``optim.apply_updates``), so a step
returns the trees it was given; that is what ``donate`` means here.

``make_train_step(..., mesh=)`` runs the step data-parallel over a
``DeviceMesh`` whose 'model' axis is 1 (tensor-parallel training is not
ported, ROADMAP §1 item 9c: it raises for 'model' > 1).  Each rank takes
its ``batch_specs`` slice of the global batch, and the gradients are
averaged over 'pod' and 'data'.  ``zero`` keeps each AdamW moment only
as the rank's ``zero_spec`` shard and updates only that shard of the
param, which is then all-gathered; ``fsdp`` keeps each param as its
``fsdp_param_specs`` shard, all-gathers it for the forward and backward
and reduce-scatters its gradient.  :func:`shard_train_state` cuts a
rank's pieces out of whole trees, :func:`gather_train_state` puts them
back together.  Without a mesh, or over one rank, the step is the
one-device step whatever the options.

``make_prefill_step(cfg, mesh)`` and ``make_decode_step(cfg, mesh)``
serve tensor-parallel over a mesh whose 'model' axis is above 1
(``runtime.tensor_parallel``): each rank calls the step with its
``shard_params`` tree, its cache (``tensor_parallel.init_cache``) and the
global batch or token, runs its ``batch_specs`` rows over its heads,
channels, experts and vocab range (every family), and gets the whole
logits of the global batch back (its rows gathered over the DP axes)
with its own cache.  Without
a mesh, or over 'model' 1, each returns the one-device step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_group, mesh_axes
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import tensor_parallel


@dataclasses.dataclass(frozen=True)
class StepOptions:
    zero: bool = True                 # ZeRO-1 moment sharding over 'data'
    compress_grads: bool = False      # bf16 gradients + fp32 error feedback
    donate: bool = True               # params and moments updated in place
    n_microbatches: int = 1           # gradient accumulation (memory)
    fsdp: bool = False                # params over 'data' too (ZeRO-3)


def loss_fn(params, cfg: ModelConfig, batch):
    return tf.forward_train(params, cfg, batch)


def microbatch_split(batch, n_micro: int):
    """(B, ...) -> (n_micro, B / n_micro, ...) for each tensor of the
    batch (the reference's host-side pre-split layout)."""
    if n_micro <= 1:
        return batch

    def one(x):
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{n_micro} microbatches")
        return x.reshape((n_micro, x.shape[0] // n_micro)
                         + tuple(x.shape[1:]))

    return {k: one(v) for k, v in batch.items()}


def value_and_grad(params, cfg: ModelConfig, batch):
    """(loss, grads) of :func:`loss_fn`, grads a tree like params, each
    leaf in its param's type."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _grad_of(params, cfg: ModelConfig, batch, nm: int):
    """(loss, grads) of a batch, or of a batch pre-split into ``nm``
    microbatches: each microbatch's loss and gradient divided by ``nm``,
    the gradients summed in fp32."""
    if nm <= 1:
        return value_and_grad(params, cfg, batch)
    loss = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(params)[0].device)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    for i in range(nm):
        mb = {k: v[i] for k, v in batch.items()}
        mb_loss, g = value_and_grad(params, cfg, mb)
        acc = _add(acc, g, nm)
        loss = loss + mb_loss / nm
    return loss, acc


def _copied(params, opt_state):
    """Copies of params and moments (a step without ``donate``)."""
    return tree_map(torch.clone, params), opt_state._replace(
        mu=tree_map(torch.clone, opt_state.mu),
        nu=tree_map(torch.clone, opt_state.nu))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    options: StepOptions = StepOptions(), *, mesh=None):
    """fn(params, opt_state, batch) -> (params, opt_state, metrics).

    With ``n_microbatches`` > 1 the batch arrives pre-split
    (:func:`microbatch_split`); each microbatch's loss and gradient are
    divided by ``n_microbatches`` and the gradients summed in fp32, as
    the reference does.  With ``donate`` False the step first copies
    params and moments, so the caller's trees are left as they were.
    With a ``mesh`` of more than one rank the step is data-parallel (the
    module docstring): it takes each rank's pieces of params and moments
    (:func:`shard_train_state`) and the global batch."""
    if mesh is not None and math.prod(mesh_axes(mesh).values()) > 1:
        return _data_parallel_step(cfg, opt_cfg, options, mesh)
    nm = options.n_microbatches

    def step(params, opt_state, batch):
        if not options.donate:
            params, opt_state = _copied(params, opt_state)
        loss, grads = _grad_of(params, cfg, batch, nm)
        if options.compress_grads and opt_state.error is not None:
            grads, new_err = adamw.compress_grads(grads, opt_state.error)
            opt_state = opt_state._replace(error=new_err)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


# --------------------------- data parallel ---------------------------

def _data_dim(spec: tuple):
    """The tensor dim a spec splits over 'data' (None: none)."""
    for d, entry in enumerate(spec):
        if "data" in shd.axes_of(entry):
            return d
    return None


def _shard(x, dim, rank: int, n: int):
    """Rank ``rank``'s view of ``x`` split n ways along ``dim`` (None:
    ``x``)."""
    if dim is None:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, rank * size, size)


def _all_gather(x, dim: int, group, n: int):
    """The n ranks' shards ``x`` joined along ``dim``."""
    parts = [torch.empty_like(x) for _ in range(n)]
    torch.distributed.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _flat(tree) -> dict:
    return dict(shd.flatten_with_paths(tree))


class _Place:
    """This rank's place on a mesh: the axes' sizes, its coordinate, and
    its rows of a batch as ``batch_specs`` splits them."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axes = mesh_axes(mesh)
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))

    def local_batch(self, batch, batch_dim: int):
        """This rank's slice of every batch tensor, as ``batch_specs``
        splits it (a tensor whose batch does not divide stays whole)."""
        specs = _flat(shd.batch_specs(batch, self.axes, batch_dim))

        def one(path, x):
            spec = specs[path]
            index, n = 0, 1
            for a in shd.axes_of(spec[batch_dim] if spec else None):
                index, n = index * self.axes[a] + self.coord[a], \
                    n * self.axes[a]
            return _shard(x, batch_dim if n > 1 else None, index, n)

        return shd.unflatten_like(batch, {p: one(p, x) for p, x in
                                          _flat(batch).items()})

    def row_groups(self, batch: int) -> tuple:
        """The groups of the DP axes that split a ``batch``-row input,
        outermost first."""
        return tuple(axis_group(self.mesh, a) for a in
                     tensor_parallel.row_axes(batch, self.axes))

    def gather_rows(self, x, batch: int):
        """``x``, this rank's rows of a ``batch``-row output split as
        :meth:`local_batch` splits a ``batch``-row input, whole again:
        gathered over the DP axes that split it, the innermost first."""
        return tensor_parallel.gather_rows(x, self.row_groups(batch))


class _Layout(_Place):
    """Where a data-parallel step's pieces live: per param path the dim
    its param (``fsdp``) and its moments (``zero``) are split over
    'data' (None: whole), and this rank's place on the mesh."""

    def __init__(self, cfg: ModelConfig, options: StepOptions, mesh):
        super().__init__(mesh)
        axes = self.axes
        if axes.get("model", 1) > 1:
            tensor_parallel.refuse()
        shape = tf.init_params(cfg, device="meta")
        param = (shd.fsdp_param_specs(shape, axes) if options.fsdp
                 else shd.param_specs(shape))
        moment = shd.opt_state_specs(shape, axes, zero=options.zero)
        self.param_dim = {p: _data_dim(s) for p, s in _flat(param).items()}
        self.moment_dim = {p: _data_dim(s)
                           for p, s in _flat(moment).items()}
        self.n_data, self.rank = axes["data"], self.coord["data"]
        self.n_dp = math.prod(axes[a] for a in shd.dp_axes(axes))
        self.data_group = mesh.get_group("data")
        self.pod_group = (mesh.get_group("pod") if axes.get("pod", 1) > 1
                          else None)

    def shard(self, x, dim):
        return _shard(x, dim, self.rank, self.n_data)

    def gather(self, x, dim):
        return x if dim is None else _all_gather(x, dim, self.data_group,
                                                 self.n_data)

    def scattered(self, path) -> bool:
        """Whether a gradient is reduce-scattered: param and moments
        split on one dim (``fsdp`` under ``zero``)."""
        dim = self.param_dim[path]
        return dim is not None and self.moment_dim[path] == dim


def _pieces(cfg, params, opt_state, mesh, options, fn):
    """``fn(layout, tensor, dim)`` over each param (its ``fsdp`` dim)
    and each moment (its ``zero`` dim)."""
    lay = _Layout(cfg, options, mesh)

    def tree(t, dims):
        return shd.unflatten_like(t, {p: fn(lay, x, dims[p])
                                      for p, x in _flat(t).items()})

    return (tree(params, lay.param_dim),
            opt_state._replace(mu=tree(opt_state.mu, lay.moment_dim),
                               nu=tree(opt_state.nu, lay.moment_dim)))


def shard_train_state(cfg: ModelConfig, params, opt_state, mesh,
                      options: StepOptions = StepOptions()):
    """This rank's params and AdamW state, cut (as copies) from whole
    trees that are the same on every rank: each param its
    ``fsdp_param_specs`` shard under ``fsdp``, else whole; each moment
    its ``opt_state_specs`` shard under ``zero``, else whole."""
    return _pieces(cfg, params, opt_state, mesh, options,
                   lambda lay, x, dim: lay.shard(x, dim).clone())


def gather_train_state(cfg: ModelConfig, params, opt_state, mesh,
                       options: StepOptions = StepOptions()):
    """Whole params and AdamW state from every rank's pieces (the
    inverse of :func:`shard_train_state`; a collective)."""
    return _pieces(cfg, params, opt_state, mesh, options,
                   lambda lay, x, dim: lay.gather(x, dim))


def _data_parallel_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                        options: StepOptions, mesh):
    """The train step over a data-parallel mesh: every rank calls it
    with its pieces of params and moments and the global batch."""
    if options.compress_grads:
        raise NotImplementedError(
            "compress_grads is not ported to a data-parallel mesh")
    lay = _Layout(cfg, options, mesh)
    dist = torch.distributed
    nm = options.n_microbatches

    def reduce(path, g):
        """The gradient averaged over the DP ranks: this rank's shard of
        it where ``scattered``, else whole."""
        if lay.pod_group is not None:
            dist.all_reduce(g, group=lay.pod_group)
        dim = lay.param_dim[path]
        if lay.scattered(path):
            out = torch.empty_like(lay.shard(g, dim))
            dist.reduce_scatter(out, [c.contiguous() for c in
                                      g.chunk(lay.n_data, dim)],
                                group=lay.data_group)
            g = out
        else:
            dist.all_reduce(g, group=lay.data_group)
        return g / lay.n_dp

    def grad_norm(grads: dict):
        """The global norm of gradients some of which are shards."""
        parts = {True: [], False: []}
        for path, g in grads.items():
            parts[lay.scattered(path)].append(
                torch.sum(torch.square(g.to(torch.float32))))
        zero = torch.zeros((), dtype=torch.float32,
                           device=next(iter(grads.values())).device)
        shards = sum(parts[True], zero)
        dist.all_reduce(shards, group=lay.data_group)
        return torch.sqrt(shards + sum(parts[False], zero))

    def step(params, opt_state, batch):
        if not options.donate:
            params, opt_state = _copied(params, opt_state)
        held = _flat(params)
        full = {p: lay.gather(x, lay.param_dim[p]) for p, x in held.items()}
        loss, grads = _grad_of(shd.unflatten_like(params, full), cfg,
                               lay.local_batch(batch, 0 if nm <= 1 else 1),
                               nm)
        grads = {p: reduce(p, g) for p, g in _flat(grads).items()}
        # the update's leaves: each the piece its moments cover
        upd_p, upd_g = {}, {}
        for path, p in held.items():
            pd, md = lay.param_dim[path], lay.moment_dim[path]
            if pd is None:              # whole param: its moments' piece
                upd_p[path] = lay.shard(p, md)
                upd_g[path] = lay.shard(grads[path], md)
            else:                       # fsdp: the shard, or whole
                upd_p[path] = p if md is not None else full[path]
                upd_g[path] = grads[path]
        norm = (grad_norm(grads) if any(map(lay.scattered, grads))
                else adamw.global_norm(shd.unflatten_like(params, grads)))
        _, opt_state, metrics = adamw.apply_updates(
            opt_cfg, shd.unflatten_like(params, upd_p),
            shd.unflatten_like(params, upd_g), opt_state, grad_norm=norm)
        with torch.no_grad():
            for path, p in held.items():
                pd, md = lay.param_dim[path], lay.moment_dim[path]
                if pd is None and md is not None:     # ZeRO: re-gather
                    p.copy_(lay.gather(lay.shard(p, md), md))
                elif pd is not None and md is None:   # fsdp, whole moments
                    p.copy_(lay.shard(full[path], pd))
        loss = loss.clone()
        for group in (lay.pod_group, lay.data_group):
            if group is not None:
                dist.all_reduce(loss, group=group)
        metrics["loss"] = loss / lay.n_dp
        return params, opt_state, metrics

    return step


def _add(acc, grads, nm: int):
    """acc + grads / nm, leaf by leaf, in fp32."""
    if isinstance(acc, dict):
        return {k: _add(acc[k], grads[k], nm) for k in acc}
    return acc + grads.to(torch.float32) / nm


def value_and_grad_step(cfg: ModelConfig):
    """The reference's un-sharded train step for smoke use: AdamW at lr
    1e-3, 2 warmup steps of 100."""
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(params, cfg, batch)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def _serving_place(cfg: ModelConfig, mesh):
    """None where the serving steps run the one-device code (no mesh, or
    'model' 1), else this rank's place on the mesh and its 'model'
    group."""
    if mesh is None or mesh_axes(mesh).get("model", 1) == 1:
        return None
    return _Place(mesh), axis_group(mesh)


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """fn(params, batch, cache) -> (last-token logits, cache); the
    batch's ``vision_embeds`` or ``frames``, where it has them, are the
    prefill's context.  Over a mesh with 'model' > 1 it is tensor-parallel
    (module docstring)."""
    split = _serving_place(cfg, mesh)

    def step(params, batch, cache):
        ctx = batch.get("vision_embeds", batch.get("frames"))
        return tf.prefill(params, cfg, batch["tokens"], cache, context=ctx)

    if split is None:
        return step
    place, group = split

    def tp_step(params, batch, cache):
        rows = batch["tokens"].shape[0]
        with tensor_parallel.using(group, place.row_groups(rows)):
            logits, cache = step(params, place.local_batch(batch, 0), cache)
        return place.gather_rows(logits, rows), cache

    return tp_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """fn(params, token, cache) -> (logits, cache): one new token per row
    against the cache.  Over a mesh with 'model' > 1 it is
    tensor-parallel (module docstring)."""
    split = _serving_place(cfg, mesh)

    def step(params, token, cache):
        return tf.decode_step(params, cfg, token, cache)

    if split is None:
        return step
    place, group = split

    def tp_step(params, token, cache):
        local = place.local_batch({"token": token}, 0)["token"]
        with tensor_parallel.using(group, place.row_groups(token.shape[0])):
            logits, cache = step(params, local, cache)
        return place.gather_rows(logits, token.shape[0]), cache

    return tp_step
