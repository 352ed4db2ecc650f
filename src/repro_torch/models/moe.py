"""Mixture-of-Experts feed-forward with fixed-capacity dispatch, with the
JAX package's names (``repro.models.moe``).

Tokens are written into an (E, capacity, d) buffer, the experts' GLU runs
as batched matrix products over the expert axis, and each token's
outputs are gathered back with its router gate values.  Tokens past an
expert's capacity contribute nothing (the residual carries them): the
Switch / GShard semantics of the reference, which has no Pallas kernel
either, so this is batched PyTorch throughout.

* Routing: softmax of the router logits (the logits in the input's type,
  then fp32), the top k by a stable descending sort (ties to the lower
  expert index, as ``jax.lax.top_k``), gate values renormalized over the
  k and cast to the input's type.
* Slots: a (token, choice) pair's position in its expert's buffer is the
  count of earlier pairs, in token-major order, that chose the expert
  (the reference's one-hot cumsum, here by a stable sort of the pairs by
  expert); capacity ``max(int(cf * k * T / E), k)``.
* The buffer is built by index writes of the kept pairs only; the
  combine adds each token's k gated outputs in a fixed order, choice 0
  first (never an ``index_add_``, whose atomics on the card add in any
  order), in the input's type.
* ``dispatch_slices`` = n > 1 routes n equal slices of the token stream
  apart, each with its own capacity, in one batched dispatch (an
  expert's buffer holds each slice's slots in turn; one slice when T
  does not divide).  ``dispatch_axes`` names mesh axes
  for the slice axis in the reference; one card has no mesh, so it is
  accepted and not read.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import _normal, act_fn, dense_init


def moe_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    p = {
        "router": dense_init(gen, d, m.n_experts, dtype, device, scale=0.1),
        "expert_gate": _experts(gen, m.n_experts, d, m.d_expert, dtype,
                                device),
        "expert_up": _experts(gen, m.n_experts, d, m.d_expert, dtype,
                              device),
        "expert_down": _experts(gen, m.n_experts, m.d_expert, d, dtype,
                                device),
    }
    if m.n_shared:
        width = m.n_shared * m.d_expert
        p["shared_gate"] = dense_init(gen, d, width, dtype, device)
        p["shared_up"] = dense_init(gen, d, width, dtype, device)
        p["shared_down"] = dense_init(gen, width, d, dtype, device)
    return p


def _experts(gen, e: int, d_in: int, d_out: int, dtype, device):
    return _normal(gen, (e, d_in, d_out), 1.0 / math.sqrt(d_in), dtype,
                   device)


def _route(p, m: MoEConfig, xs):
    """Router of token slices xs (S, T, d) -> (probs (S, T, E) fp32, gate
    values (S, T, k) in xs's type, expert indices (S, T, k))."""
    probs = torch.softmax((xs @ p["router"]).to(torch.float32), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[..., :m.top_k], idx[..., :m.top_k]
    gate = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
    return probs, gate.to(xs.dtype), idx


def _positions(expert_of, e: int):
    """Each (token, choice) pair's position in its expert's buffer: the
    count of earlier pairs (S, T*k) that chose the same expert, the
    reference's one-hot cumsum, computed by a stable sort of the pairs by
    expert (integer exact; no (S, T*k, E) one-hot)."""
    s, n = expert_of.shape
    order = torch.argsort(expert_of, dim=1, stable=True)
    counts = torch.zeros((s, e), dtype=torch.long, device=expert_of.device)
    counts.scatter_add_(1, expert_of, torch.ones_like(expert_of))
    starts = torch.cumsum(counts, dim=1) - counts         # (S, E)
    rank = (torch.arange(n, device=expert_of.device)[None, :]
            - starts.gather(1, expert_of.gather(1, order)))
    return torch.empty_like(expert_of).scatter_(1, order, rank)


def _dispatch(p, m: MoEConfig, xs, act: str, capacity: int):
    """Route S slices of tokens xs (S, T, d), each with its own capacity
    -> (y (S, T, d), probs (S, T, E), indices (S, T, k))."""
    s, t, d = xs.shape
    e, k = m.n_experts, m.top_k
    probs, gate, idx = _route(p, m, xs)
    expert_of = idx.reshape(s, t * k)
    pos_in_e = _positions(expert_of, e)
    keep = pos_in_e < capacity
    # the kept pairs' tokens written into their slots of (E, S*C, d): an
    # expert's buffer holds every slice's slots, slice by slice
    slot = (expert_of * (s * capacity)
            + torch.arange(s, device=xs.device)[:, None] * capacity
            + torch.clamp(pos_in_e, max=capacity - 1))
    token = torch.arange(s * t, device=xs.device).reshape(s, t)
    token = token.repeat_interleave(k, dim=1)             # (S, T*k)
    buf = xs.new_zeros((e * s * capacity, d))
    buf = buf.index_put((slot[keep],), xs.reshape(s * t, d)[token[keep]])
    buf = buf.reshape(e, s * capacity, d)

    # the experts' GLU, batched over the expert axis
    g = torch.bmm(buf, p["expert_gate"])
    u = torch.bmm(buf, p["expert_up"])
    out = torch.bmm(act_fn(act)(g) * u, p["expert_down"])
    out = out.reshape(e * s * capacity, d)

    # each token's k gated outputs, added in choice order
    gates = torch.where(keep, gate.reshape(s, t * k),
                        torch.zeros((), dtype=gate.dtype, device=xs.device))
    contrib = (out[slot] * gates[..., None].to(out.dtype)).reshape(s, t, k,
                                                                  d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y, probs, idx


def _dispatch_one_slice(p, m: MoEConfig, xt, act: str, capacity: int):
    """Route one dispatch slice of tokens (T_loc, d) -> (y, probs (T, E),
    selection one-hot (T, k, E)), as the reference's function of that
    name returns."""
    y, probs, idx = _dispatch(p, m, xt[None], act, capacity)
    sel = torch.nn.functional.one_hot(idx[0], m.n_experts).to(torch.int32)
    return y[0], probs[0], sel


def moe_apply(p, cfg: ModelConfig, x, act: str = "silu"):
    """x: (B, S, d) -> (y (B, S, d), the Switch load-balance aux loss
    (fp32 scalar, weighted by ``router_aux_weight``))."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    n_slices = max(1, m.dispatch_slices)
    if t % n_slices:
        n_slices = 1
    t_loc = t // n_slices
    capacity = max(int(m.capacity_factor * m.top_k * t_loc / m.n_experts),
                   m.top_k)
    y, probs, idx = _dispatch(p, m, xt.reshape(n_slices, t_loc, d), act,
                              capacity)
    y = y.reshape(t, d)
    if m.n_shared:
        sg = xt @ p["shared_gate"]
        su = xt @ p["shared_up"]
        y = y + (act_fn(act)(sg) * su) @ p["shared_down"]

    # Switch-style load-balance aux loss: the mean router probability of
    # each expert times the share of tokens that chose it
    me = probs.reshape(t, m.n_experts).mean(dim=0)
    chose = torch.zeros((t, m.n_experts), dtype=torch.float32,
                        device=x.device)
    chose.scatter_(1, idx.reshape(t, m.top_k), 1.0)
    ce = chose.mean(dim=0)
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_weight
    return y.reshape(b, s, d), aux


__all__ = ["moe_init", "moe_apply"]
