"""Shared model building blocks in PyTorch, with the JAX package's names
(``repro.models.common``).

Every block is a pair of functions: ``<block>_init(gen, ..., device) ->
params`` and ``<block>_apply(params, x, ...) -> y``.  Params are plain
nested dicts of tensors with the JAX package's key names, so a JAX
parameter tree converts leaf by leaf (``models/convert.py``).  Weights
are drawn from an explicit ``torch.Generator`` on the target device; on
the ``meta`` device nothing is drawn or allocated (shapes only).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.runtime import tensor_parallel as tp

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# ------------------------------ init ---------------------------------

def _normal(gen, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std**2) in fp32, cast to ``dtype``; empty on ``meta``."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    """U(lo, hi) in fp32; empty on ``meta``."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    x = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return lo + (hi - lo) * x


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), scale / math.sqrt(d_in), dtype,
                   device)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype, device)


# ------------------------------ norms --------------------------------

def norm_init(d: int, kind: str, dtype, device,
              use_bias: bool = False) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm" and use_bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """RMSNorm through the kernel wrapper in the JAX package's cast order
    (``kernels.rmsnorm.rmsnorm(..., cast_first=True)``: the normalized x
    cast to x's type first, then multiplied by the scale in that type, one
    launch on the card; ``ops.rmsnorm`` keeps the Pallas kernel's order);
    layernorm in torch, cast before the scale as the JAX package does."""
    if kind == "rmsnorm":
        y = _rmsnorm.rmsnorm(x, p["scale"], eps, cast_first=True)
    else:
        x32 = x.to(torch.float32)
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y


# ------------------------------ rope ---------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim/2),
    in fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., L, H, D) or (..., L, D); cos/sin: (..., L, D/2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    if x.ndim == cos.ndim + 1:     # (..., L, H, D) vs (..., L, D/2)
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)


# --------------------------- activations ------------------------------

def act_fn(name: str) -> Callable:
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults
    to (``torch.nn.functional.gelu`` defaults to the exact form)."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu,
            "relu2": lambda x: torch.square(F.relu(x))}[name]


# ------------------------------ MLP ----------------------------------

def glu_mlp_init(gen, d_model: int, d_ff: int, dtype, device,
                 use_bias: bool = False) -> dict:
    p = {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
         "w_up": dense_init(gen, d_model, d_ff, dtype, device),
         "w_down": dense_init(gen, d_ff, d_model, dtype, device)}
    if use_bias:
        p["b_gate"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_up"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_down"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def glu_mlp_apply(p, x, act: str = "silu"):
    """The GLU feed-forward; under tensor parallelism ``w_gate`` and
    ``w_up`` hold a rank's columns and ``w_down`` its rows, whose partial
    products are summed over 'model' before ``b_down`` is added."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    if "b_gate" in p:
        g = g + p["b_gate"]
        u = u + p["b_up"]
    y = act_fn(act)(g) * u
    y = tp.reduce(y @ p["w_down"])
    if "b_down" in p:
        y = y + p["b_down"]
    return y


def mlp_init(gen, d_model: int, d_ff: int, dtype, device,
             use_bias: bool = True) -> dict:
    """Plain two-layer feed-forward (whisper's)."""
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype, device),
         "w_out": dense_init(gen, d_ff, d_model, dtype, device)}
    if use_bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def mlp_apply(p, x, act: str = "gelu"):
    """The plain feed-forward; under tensor parallelism ``w_in`` and
    ``b_in`` hold a rank's columns and ``w_out`` its rows, whose partial
    products are summed over 'model' before ``b_out`` is added."""
    y = x @ p["w_in"]
    if "b_in" in p:
        y = y + p["b_in"]
    y = act_fn(act)(y)
    y = tp.reduce(y @ p["w_out"])
    if "b_out" in p:
        y = y + p["b_out"]
    return y


# ------------------------------ loss ----------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32.  logits (..., V), labels
    (...) integer."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# --------------------------- param trees ------------------------------

def tree_map(fn, tree):
    """``fn`` over the tensor leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stack_layers(gen, n: int, init_fn) -> dict:
    """Initialize n structurally-identical layers and stack each leaf on
    a leading layer axis, the JAX package's layout."""
    layers = [init_fn(gen) for _ in range(n)]

    def stack(*leaves):
        return torch.stack(leaves, dim=0)

    def zip_map(trees):
        if isinstance(trees[0], dict):
            return {k: zip_map([t[k] for t in trees]) for k in trees[0]}
        return stack(*trees)

    return zip_map(layers)


def params_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def params_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
