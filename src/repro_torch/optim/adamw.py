"""AdamW with gradient clipping, the warmup-cosine schedule and bf16
gradient compression, with the JAX package's names and arithmetic
(``repro.optim.adamw``), as plain functions over nested dicts of
tensors.

The arithmetic is the reference's, operation for operation: moments in
fp32 (or bf16 when ``moment_dtype`` says so, each update computed in
fp32 and cast), clipped gradients cast back to the gradient's own type
before the update, bias corrections in fp32, weight decay on every leaf
whose path holds none of the no-decay tokens.  One difference: the JAX
package returns new trees, while :func:`apply_updates` here writes the
new params and moments into the tensors it was given (under
``torch.no_grad()``) and returns those same trees, so an update at 2.5 B
parameters needs no second copy of them; the fp32 temporaries live one
leaf at a time.  ``torch.optim.AdamW`` is not used: its update differs
from the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" for a smaller footprint


class AdamWState(NamedTuple):
    step: torch.Tensor                # int32 scalar, on the params' device
    mu: dict                          # first moment, a tree like params
    nu: dict                          # second moment
    error: Optional[dict] = None      # compression error feedback (fp32)


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def init_state(cfg: AdamWConfig, params,
               with_error_feedback: bool = False) -> AdamWState:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros(dtype):
        return _map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)

    device = _leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=zeros(dt), nu=zeros(dt),
        error=zeros(torch.float32) if with_error_feedback else None)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``; fp32."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    total = None
    for x in _leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Returns (grads scaled to at most ``max_norm`` in global norm, each
    cast back to its own type, and the norm before clipping).  ``norm``
    (None: computed from ``grads``) is the global norm when ``grads``
    hold only a rank's shards of the gradients."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                grads), norm


def compress_grads(grads, error):
    """bf16 compression with fp32 error feedback: returns (bf16 grads,
    new error), ``g32 = g + e``, ``c = bf16(g32)``, ``e' = g32 - c``."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        c = g32.to(torch.bfloat16)
        return c, g32 - c.to(torch.float32)

    pairs = _map(one, grads, error)
    return (_map(lambda pair: pair[0], pairs),
            _map(lambda pair: pair[1], pairs))


_NO_DECAY_TOKENS = ("norm", "bias", "scale", "a_log", "dt_bias",
                    "decay_base", "mix_base", "bonus", "gate")


def _decay_mask(path: str) -> bool:
    p = path.lower()
    return not any(tok in p for tok in _NO_DECAY_TOKENS)


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_paths(v, f"{prefix}/{k}") for k, v in tree.items()}
    return prefix


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState,
                  grad_norm=None):
    """One AdamW step, in place: params, ``state.mu`` and ``state.nu``
    are overwritten (a leaf may be a view into a larger param, which is
    then written through).  ``grad_norm`` (None: computed from
    ``grads``) is the clip's global norm, given where ``grads`` are a
    rank's shards.  Returns (params, new state, metrics {lr,
    grad_norm})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    s32 = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=s32.device), s32)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=s32.device), s32)
    paths = _tree_paths(params)

    def upd(p, g, m, v, path):
        g32 = g.to(torch.float32)
        m32 = m.to(torch.float32) * b1
        m32 += g32 * (1 - b1)
        v32 = v.to(torch.float32) * b2
        t = g32 * (1 - b2)
        t *= g32
        v32 += t
        del g32, t
        delta = m32 / bc1
        denom = v32 / bc2
        denom.sqrt_()
        denom += cfg.eps
        delta /= denom
        del denom
        if _decay_mask(path):
            delta += p.to(torch.float32) * cfg.weight_decay
        delta *= lr
        p.copy_(p.to(torch.float32) - delta)
        m.copy_(m32)
        v.copy_(v32)

    _map(upd, params, grads, state.mu, state.nu, paths)
    new_state = AdamWState(step=step, mu=state.mu, nu=state.nu,
                           error=state.error)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
