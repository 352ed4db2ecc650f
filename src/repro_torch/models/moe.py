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
* Under tensor parallelism (``runtime.tensor_parallel``, expert
  parallelism over 'model') the router is whole and each rank routes
  its rows as one device does, capacity and slot positions those of the
  global batch (with rows split over 'data', the ranks' expert choices
  gathered); a rank builds and runs only its experts' buffers and its
  block of the shared experts, and the routed and shared partial sums
  are added over 'model' once.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import _normal, act_fn, dense_init
from repro_torch.runtime import tensor_parallel as tp


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


def _dispatch_rows(p, m: MoEConfig, xt, act: str, capacity: int,
                   n_slices: int, span: tuple):
    """Route tokens xt (T, d), this rank's rows of a global batch
    (``span``: the global token count and this rank's first; all of it
    on one device), in ``n_slices`` slices of the global token stream,
    each with its own capacity, as the reference routes the whole batch:
    each pair's slot position counted over the earlier pairs of its
    slice on every rank, whose expert choices are gathered over the DP
    axes -> (y (T, d), probs (1, T, E), indices (1, T, k))."""
    t, k = xt.shape[0], m.top_k
    t_all, first = span
    per_slice = t_all // n_slices
    probs, gate, idx = _route(p, m, xt[None])
    every = tp.gather_rows(idx[0])                        # (T_all, k)
    pos_in_e = _positions(every.reshape(n_slices, per_slice * k),
                          m.n_experts).reshape(t_all, k)[first:first + t]
    slice_of = (first + torch.arange(t, device=xt.device)) // per_slice
    y = _run_experts(p, m, xt, gate[0], idx[0], pos_in_e, slice_of,
                     n_slices, capacity, act)
    return y, probs, idx


def _run_experts(p, m: MoEConfig, xt, gate, idx, pos_in_e, slice_of,
                 n_slices: int, capacity: int, act: str):
    """The routed output of tokens xt (T, d): their (T, k) gate values,
    experts and slot positions in their slice (``slice_of``, (T,)) of
    ``n_slices``; pairs past ``capacity`` dropped.  The experts held are
    the leaves' (all of them on one device, a rank's block under tensor
    parallelism, where the output is its partial sum)."""
    t, d = xt.shape
    k = idx.shape[1]
    e = p["expert_gate"].shape[0]
    e0 = tp.block_start(e)
    keep = (pos_in_e < capacity) & (idx >= e0) & (idx < e0 + e)
    # the kept pairs' tokens written into their slots of (E, S*C, d): an
    # expert's buffer holds every slice's slots, slice by slice
    slot = (((idx - e0).clamp(0, e - 1) * n_slices + slice_of[:, None])
            * capacity + torch.clamp(pos_in_e, max=capacity - 1))
    token = torch.arange(t, device=xt.device)[:, None].expand(t, k)
    buf = xt.new_zeros((e * n_slices * capacity, d))
    buf = buf.index_put((slot[keep],), xt[token[keep]])
    buf = buf.reshape(e, n_slices * capacity, d)

    # the experts' GLU, batched over the expert axis
    g = torch.bmm(buf, p["expert_gate"])
    u = torch.bmm(buf, p["expert_up"])
    out = torch.bmm(act_fn(act)(g) * u, p["expert_down"])
    out = out.reshape(e * n_slices * capacity, d)

    # each token's k gated outputs, added in choice order
    gates = torch.where(keep, gate,
                        torch.zeros((), dtype=gate.dtype, device=xt.device))
    contrib = out[slot] * gates[..., None].to(out.dtype)    # (T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _dispatch_one_slice(p, m: MoEConfig, xt, act: str, capacity: int):
    """Route one dispatch slice of tokens (T_loc, d) -> (y, probs (T, E),
    selection one-hot (T, k, E)), as the reference's function of that
    name returns."""
    y, probs, idx = _dispatch_rows(p, m, xt, act, capacity, 1,
                                   (xt.shape[0], 0))
    sel = torch.nn.functional.one_hot(idx[0], m.n_experts).to(torch.int32)
    return y, probs[0], sel


def moe_apply(p, cfg: ModelConfig, x, act: str = "silu"):
    """x: (B, S, d) -> (y (B, S, d), the Switch load-balance aux loss
    (fp32 scalar, weighted by ``router_aux_weight``))."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    n_slices = max(1, m.dispatch_slices)
    span = tp.row_span(t)
    t_all = span[0]
    if t_all % n_slices:
        n_slices = 1
    t_loc = t_all // n_slices
    capacity = max(int(m.capacity_factor * m.top_k * t_loc / m.n_experts),
                   m.top_k)
    y, probs, idx = _dispatch_rows(p, m, xt, act, capacity, n_slices, span)
    if m.n_shared:
        sg = xt @ p["shared_gate"]
        su = xt @ p["shared_up"]
        y = y + (act_fn(act)(sg) * su) @ p["shared_down"]
    y = tp.reduce(y)            # the experts' and shared partials

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
