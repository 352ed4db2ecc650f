"""Plain PyTorch versions of the model kernels: RMSNorm, flash attention
(prefill), flash decode and the RWKV6 WKV recurrence, and of the three
backward kernels: RMSNorm's and attention's, which are autograd of the
forward versions here, and the WKV recurrence's, an explicit reverse
recurrence (:func:`rwkv6_scan_bwd_plain`).

Each is the function its CUDA kernel computes, in fp32 whatever the
input type, written for clarity: the kernel wrappers run them for
tensors on the CPU, and the tests and ``chip_smoke.py`` hold the
kernels to them.  They follow the JAX package's ``repro.kernels.ref``
oracles, with one deliberate difference: :func:`rmsnorm_plain`
multiplies by the weight in fp32 and then casts, as the TPU kernel
(``rmsnorm_pallas``) does, where ``ref.rmsnorm_ref`` casts first;
:func:`rmsnorm_cast_first_plain` is the cast-first twin, the order of
the JAX package's model (``repro.models.common.norm_apply``).
"""

from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * weight`` over the last axis, in
    fp32, cast to ``x.dtype`` at the end."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * weight.to(torch.float32)).to(x.dtype)


def rmsnorm_cast_first_plain(x: torch.Tensor, weight: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps)`` in fp32, cast to ``x.dtype``, then
    multiplied by ``weight`` in that type: the JAX package's model
    (``repro.models.common.norm_apply``), bit for bit on the CPU."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA softmax attention in fp32.

    q: (B, Hq, Lq, D); k: (B, Hkv, Lk, D); v: (B, Hkv, Lk, Dv) (any Dv)
    with Hq % Hkv == 0; query head ``h`` reads kv head
    ``h // (Hq // Hkv)``.  Causal rows are the last Lq positions of the
    Lk-long sequence (Lq <= Lk); ``scale`` defaults to D ** -0.5.
    Returns (B, Hq, Lq, Dv) in q's dtype."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    q32 = q.to(torch.float32) * scale
    kg = torch.repeat_interleave(k.to(torch.float32), group, dim=1)
    vg = torch.repeat_interleave(v.to(torch.float32), group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q32, kg)
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vg).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The natural log-sum-exp over keys of each row's scaled logits, fp32
    (B, Hq, Lq): what the forward kernel writes for its backward."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kg = torch.repeat_interleave(k.to(torch.float32), hq // hkv, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale, kg)
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    return torch.logsumexp(logits, dim=-1)


def _grads(fn, inputs, dout):
    """Autograd of ``fn(*inputs)`` against ``dout``: one gradient per
    input, each in its input's type."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, dout)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`attention_plain` against the output's
    gradient ``dout``, by autograd (fp32 inside, each cast to its
    input's type)."""
    return _grads(lambda a, b_, c: attention_plain(a, b_, c, causal, scale),
                  (q, k, v), dout)


def rmsnorm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                      dy: torch.Tensor, eps: float = 1e-6,
                      cast_first: bool = False):
    """(dx, dweight) of :func:`rmsnorm_plain` (``cast_first``: of
    :func:`rmsnorm_cast_first_plain`) against the output's gradient
    ``dy``, by autograd."""
    fn = rmsnorm_cast_first_plain if cast_first else rmsnorm_plain
    return _grads(lambda a, w: fn(a, w, eps), (x, weight), dy)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           kv_len: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One-token GQA decode in fp32.

    q: (B, Hq, D); caches: keys (B, Hkv, L, D), values (B, Hkv, L, Dv)
    (any Dv); kv_len: (B,) valid lengths (None: all L; a row of length 0
    is NaN, the softmax of no key, as in
    ``repro.kernels.ref.decode_attention_ref``).  Returns (B, Hq, Dv) in
    q's dtype."""
    b, hq, d = q.shape
    hkv, lmax = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    q32 = q.to(torch.float32) * scale
    kg = torch.repeat_interleave(k_cache.to(torch.float32), group, dim=1)
    vg = torch.repeat_interleave(v_cache.to(torch.float32), group, dim=1)
    logits = torch.einsum("bhd,bhkd->bhk", q32, kg)
    if kv_len is not None:
        kpos = torch.arange(lmax, device=q.device)[None, None, :]
        logits = logits.masked_fill(kpos >= kv_len.to(q.device)[:, None,
                                                                 None],
                                    float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs, vg).to(q.dtype)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, bonus: torch.Tensor,
                     initial_state: Optional[torch.Tensor] = None):
    """The RWKV6 WKV recurrence, one step at a time.

    r/k/v/w: (B, T, H, dh); bonus (H, dh); initial_state (B, H, dh, dh)
    fp32 or None (zeros).  Per step, in the JAX oracle's order
    (``repro.kernels.ref.rwkv6_scan_ref``), each a torch op of its own::

        kv = k_t (x) v_t
        y_t = sum_k r_t * (S + u * kv)
        S = w_t * S
        S = S + kv

    so the state rounds after every product and sum, where the kernel
    rounds.  Returns (y (B, T, H, dh) in r's type, final state fp32)."""
    b, t, h, dh = r.shape
    r32, k32, v32, w32 = (x.to(torch.float32) for x in (r, k, v, w))
    u = bonus.to(torch.float32)[..., None]                 # (H, dh, 1)
    state = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=r.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for i in range(t):
        kv = k32[:, i, :, :, None] * v32[:, i, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r32[:, i], state + u * kv))
        state = w32[:, i, :, :, None] * state
        state = state + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


def rwkv6_scan_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, bonus: torch.Tensor,
                         initial_state: Optional[torch.Tensor],
                         dy: torch.Tensor,
                         dstate: Optional[torch.Tensor] = None):
    """The gradients of :func:`rwkv6_scan_plain` as an explicit reverse
    recurrence, in fp32.

    With P_t the state before step t (P_0 the initial state), y_t its
    output and G_t the gradient of the state after step t (G_T =
    ``dstate``, or zeros), for t = T .. 1 in the reverse order::

        dr_t = P_t dy_t + u * k_t (v_t . dy_t)
        dk_t = G_t v_t + u * r_t (v_t . dy_t)
        dv_t = G_t^T k_t + (sum_j r_t u k_t) dy_t
        dw_t = sum_i G_t[:, i] * P_t[:, i]
        G_{t-1} = w_t * G_t + r_t (x) dy_t
        du += r_t * k_t (v_t . dy_t)

    summed over the batch for du.  Returns (dr, dk, dv, dw (B, T, H, dh)
    in r's type, dbonus (H, dh) fp32, the initial state's gradient
    (B, H, dh, dh) fp32).  It keeps every state of the forward, so it is
    the kernel's reference, not a route of the model."""
    b, t, h, dh = r.shape
    r32, k32, v32, w32, dy32 = (x.to(torch.float32)
                                for x in (r, k, v, w, dy))
    u = bonus.to(torch.float32)
    state = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=r.device)
             if initial_state is None else initial_state.to(torch.float32))
    states = []                      # P_t, the forward's own roundings
    for i in range(t):
        states.append(state)
        kv = k32[:, i, :, :, None] * v32[:, i, :, None, :]
        state = w32[:, i, :, :, None] * state
        state = state + kv
    g = (torch.zeros_like(state) if dstate is None
         else dstate.to(torch.float32).clone())
    grads = {name: torch.empty((b, t, h, dh), dtype=torch.float32,
                               device=r.device)
             for name in ("r", "k", "v", "w")}
    du = torch.zeros((h, dh), dtype=torch.float32, device=r.device)
    for i in reversed(range(t)):
        r_t, k_t, v_t, w_t, dy_t = (x[:, i] for x in (r32, k32, v32, w32,
                                                       dy32))
        p_t = states[i]
        vd = (v_t * dy_t).sum(-1, keepdim=True)              # (B, H, 1)
        c = (r_t * u * k_t).sum(-1, keepdim=True)
        grads["r"][:, i] = (torch.einsum("bhji,bhi->bhj", p_t, dy_t)
                            + u * k_t * vd)
        grads["k"][:, i] = (torch.einsum("bhji,bhi->bhj", g, v_t)
                            + u * r_t * vd)
        grads["v"][:, i] = torch.einsum("bhji,bhj->bhi", g, k_t) + c * dy_t
        grads["w"][:, i] = (g * p_t).sum(-1)
        du += (r_t * k_t * vd).sum(0)
        g = w_t[..., :, None] * g + r_t[..., :, None] * dy_t[..., None, :]
    return (grads["r"].to(r.dtype), grads["k"].to(r.dtype),
            grads["v"].to(r.dtype), grads["w"].to(r.dtype), du, g)
