"""Step factories: train / prefill / decode, with the JAX package's names
(``repro.runtime.steps``), for one device.

The reference returns jitted functions with their shardings; the port
runs eagerly on one device, so each factory returns the step function
alone, and only the options that mean something on one device are
kept: ``compress_grads``, ``donate`` and ``n_microbatches``
(``zero`` and ``fsdp`` are sharding, ROADMAP.md section 1, item 8).
Gradients come from ``torch.autograd.grad`` over the param leaves, each
set to require a gradient; on the card the model's attention and
RMSNorm run through their backward kernels.  The optimizer updates
params and moments in place (``optim.apply_updates``), so a step
returns the trees it was given; that is what ``donate`` means here.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class StepOptions:
    compress_grads: bool = False      # bf16 gradients + fp32 error feedback
    donate: bool = True               # params and moments updated in place
    n_microbatches: int = 1           # gradient accumulation (memory)


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


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    options: StepOptions = StepOptions()):
    """fn(params, opt_state, batch) -> (params, opt_state, metrics).

    With ``n_microbatches`` > 1 the batch arrives pre-split
    (:func:`microbatch_split`); each microbatch's loss and gradient are
    divided by ``n_microbatches`` and the gradients summed in fp32, as
    the reference does.  With ``donate`` False the step first copies
    params and moments, so the caller's trees are left as they were."""
    nm = options.n_microbatches

    def grad_of(params, batch):
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

    def step(params, opt_state, batch):
        if not options.donate:
            params = tree_map(torch.clone, params)
            opt_state = opt_state._replace(
                mu=tree_map(torch.clone, opt_state.mu),
                nu=tree_map(torch.clone, opt_state.nu))
        loss, grads = grad_of(params, batch)
        if options.compress_grads and opt_state.error is not None:
            grads, new_err = adamw.compress_grads(grads, opt_state.error)
            opt_state = opt_state._replace(error=new_err)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
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


def make_prefill_step(cfg: ModelConfig):
    """fn(params, batch, cache) -> (last-token logits, cache); the
    batch's ``vision_embeds`` or ``frames``, where it has them, are the
    prefill's context."""

    def step(params, batch, cache):
        ctx = batch.get("vision_embeds", batch.get("frames"))
        return tf.prefill(params, cfg, batch["tokens"], cache, context=ctx)

    return step


def make_decode_step(cfg: ModelConfig):
    """fn(params, token, cache) -> (logits, cache): one new token per row
    against the cache."""

    def step(params, token, cache):
        return tf.decode_step(params, cfg, token, cache)

    return step
