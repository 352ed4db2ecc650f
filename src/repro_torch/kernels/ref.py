"""Plain PyTorch versions of the model kernels: RMSNorm, flash attention
(prefill), flash decode, the RWKV6 WKV recurrence, and Mamba's causal
conv and selective scan, and of their backward kernels: RMSNorm's and
attention's, which are autograd of the forward versions here, and the
WKV recurrence's, the causal conv's and the selective scan's, explicit
reverse passes (:func:`rwkv6_scan_bwd_plain`,
:func:`causal_conv1d_bwd_plain`, :func:`selective_scan_bwd_plain`).

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
import torch.nn.functional as F


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


def _attention_mask(lq: int, lk: int, causal: bool, q_offset, kv_len,
                    device):
    """The keys each query row may not see, broadcastable over
    (B, Hq, Lq, Lk), or None where every key is seen.  Causal rows sit at
    ``q_offset[b] + r`` (None: at ``Lk - Lq + r``, the last Lq positions);
    keys at ``>= kv_len[b]`` are masked whatever ``causal`` says."""
    masked = None
    if causal:
        kpos = torch.arange(lk, device=device)[None, :]
        qpos = torch.arange(lq, device=device)[:, None]
        if q_offset is None:
            masked = kpos > qpos + (lk - lq)
        else:
            masked = kpos > q_offset[:, None, None, None] + qpos
    if kv_len is not None:
        beyond = (torch.arange(lk, device=device)
                  >= kv_len[:, None, None, None])
        masked = beyond if masked is None else masked | beyond
    return masked


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA softmax attention in fp32.

    q: (B, Hq, Lq, D); k: (B, Hkv, Lk, D); v: (B, Hkv, Lk, Dv) (any Dv)
    with Hq % Hkv == 0; query head ``h`` reads kv head
    ``h // (Hq // Hkv)``.  Causal rows are the last Lq positions of the
    Lk-long sequence (Lq <= Lk), or, with ``q_offset`` (B,) int32, row
    ``r`` of batch row ``b`` sits at position ``q_offset[b] + r`` (a
    cached prefill, as ``repro``'s ``_sdpa_block``); ``kv_len`` (B,)
    int32 masks the keys at ``>= kv_len[b]``.  ``scale`` defaults to
    D ** -0.5.  Returns (B, Hq, Lq, Dv) in q's dtype."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    q32 = q.to(torch.float32) * scale
    kg = torch.repeat_interleave(k.to(torch.float32), group, dim=1)
    vg = torch.repeat_interleave(v.to(torch.float32), group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q32, kg)
    masked = _attention_mask(lq, lk, causal, q_offset, kv_len, q.device)
    if masked is not None:
        logits = logits.masked_fill(masked, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vg).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None,
                        q_offset: Optional[torch.Tensor] = None,
                        kv_len: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The natural log-sum-exp over keys of each row's scaled logits, fp32
    (B, Hq, Lq): what the forward kernel writes for its backward; rows
    placed and keys masked as in :func:`attention_plain`."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kg = torch.repeat_interleave(k.to(torch.float32), hq // hkv, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale, kg)
    masked = _attention_mask(lq, lk, causal, q_offset, kv_len, q.device)
    if masked is not None:
        logits = logits.masked_fill(masked, float("-inf"))
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


def _conv_pad(x: torch.Tensor, width: int,
              state: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, T, D) behind its ``width - 1`` preceding rows: the conv
    state, or zeros without one (B, T + width - 1, D) in x's type."""
    pad = (torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    return torch.cat([pad, x], dim=1)


def _conv_pre(xp: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              t: int) -> torch.Tensor:
    """The conv's pre-activation, each product and sum a torch op in the
    input type: ``((xp_0 w_0 + xp_1 w_1) + ...) + bias``."""
    y = xp[:, 0:t] * weight[0]
    for i in range(1, weight.shape[0]):
        y = y + xp[:, i:i + t] * weight[i]
    return y + bias


def causal_conv1d_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor,
                        state: Optional[torch.Tensor] = None):
    """Mamba's depthwise causal conv over time, then SiLU.

    x: (B, T, D), any strides; weight (K, D) (K taps, the last one on the
    current step); bias (D); state (B, K - 1, D), the K - 1 inputs before
    x, or None (zeros).  As the JAX package's ``_conv1d_causal``: the
    shifted products and their sum in x's type, op by op, the bias, then
    ``F.silu``.  Returns (out (B, T, D) in x's type, the new state (B, K - 1,
    D): the last K - 1 rows of the state followed by x)."""
    k, t = weight.shape[0], x.shape[1]
    xp = _conv_pad(x, k, state)
    return F.silu(_conv_pre(xp, weight, bias, t)), xp[:, t:].contiguous()


def causal_conv1d_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor,
                            state: Optional[torch.Tensor],
                            dout: torch.Tensor,
                            dstate_out: Optional[torch.Tensor] = None):
    """The gradients of :func:`causal_conv1d_plain` against the output's
    gradient ``dout`` and the new state's ``dstate_out`` (None: zeros), in
    fp32.  With xp the padded input and g = dout * silu'(pre-activation)
    (the pre-activation in the forward's own rounding)::

        dxp[p] = sum_i w_i g[p - i]  (0 <= p - i < T), plus dstate_out
                 on the last K - 1 rows
        dw_i = sum_{b, t} xp[t + i] g[t],   dbias = sum_{b, t} g[t]

    Returns (dx (B, T, D) in x's type, dweight, dbias in theirs, the
    state's gradient (B, K - 1, D) in x's type)."""
    k, t = weight.shape[0], x.shape[1]
    xp = _conv_pad(x, k, state)
    u = _conv_pre(xp, weight, bias, t).float()
    s = torch.sigmoid(u)
    g = dout.float() * (s * (1 + u * (1 - s)))
    w32, xp32 = weight.float(), xp.float()
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        dxp[:, i:i + t] += w32[i] * g
    if dstate_out is not None:
        dxp[:, t:] += dstate_out.float()
    dw = torch.stack([(xp32[:, i:i + t] * g).sum((0, 1)) for i in range(k)])
    return (dxp[:, k - 1:].to(x.dtype), dw.to(weight.dtype),
            g.sum((0, 1)).to(bias.dtype), dxp[:, :k - 1].to(x.dtype))


def selective_scan_plain(dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, x: torch.Tensor,
                         d_skip: torch.Tensor,
                         initial_state: Optional[torch.Tensor] = None):
    """Mamba's selective scan, one step at a time, in fp32.

    dt, x: (B, T, D); a (D, N); b, c (B, T, N); d_skip (D); initial_state
    (B, D, N) or None (zeros).  Per step, in the JAX package's order
    (``repro.models.mamba._ssm_step``), each a torch op of its own::

        h = exp(dt_t a) * h + (dt_t b_t) x_t
        y_t = sum_n h c_t

    then ``y + x * d_skip``.  Returns (y (B, T, D), final state (B, D, N)),
    both fp32."""
    f32 = torch.float32
    dt32, x32, b32, c32 = (v.to(f32) for v in (dt, x, b, c))
    a32 = a.to(f32)
    h = (torch.zeros((dt.shape[0], dt.shape[2], a.shape[1]), dtype=f32,
                     device=dt.device)
         if initial_state is None else initial_state.to(f32))
    ys = []
    for i in range(dt.shape[1]):
        dt_i = dt32[:, i, :, None]
        h = (torch.exp(dt_i * a32) * h
             + dt_i * b32[:, i, None, :] * x32[:, i, :, None])
        ys.append(torch.einsum("bdn,bn->bd", h, c32[:, i]))
    return torch.stack(ys, dim=1) + x32 * d_skip.to(f32), h


def selective_scan_gated_plain(dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                               a: torch.Tensor, b: torch.Tensor,
                               c: torch.Tensor, x: torch.Tensor,
                               z: torch.Tensor, d_skip: torch.Tensor,
                               initial_state: Optional[torch.Tensor] = None):
    """The selective scan between its projections, as the JAX package's
    ``mamba_apply`` runs it, each a torch op of its own: dt =
    ``F.softplus(dt_raw in fp32 + dt_bias)``, :func:`selective_scan_plain`
    on x in fp32, then ``y`` cast to x's type times ``F.silu(z)``.  Returns
    (the gated output in x's type, final state (B, D, N) fp32)."""
    dt = F.softplus(dt_raw.to(torch.float32) + dt_bias)
    y, h = selective_scan_plain(dt, a, b, c, x.to(torch.float32), d_skip,
                                initial_state)
    return y.to(x.dtype) * F.silu(z), h


def selective_scan_bwd_plain(dt: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, c: torch.Tensor,
                             x: torch.Tensor, d_skip: torch.Tensor,
                             initial_state: Optional[torch.Tensor],
                             dy: torch.Tensor,
                             dstate: Optional[torch.Tensor] = None):
    """The gradients of :func:`selective_scan_plain` as an explicit
    reverse recurrence, in fp32.

    With P_t the state before step t (P_0 the initial state), E_t =
    exp(dt_t a), h_t = E_t P_t + (dt_t b_t) x_t and G the gradient of the
    state after step t (``dstate``, or zeros, after the last), for t = T
    .. 1 in the reverse order::

        G_t = G + dy_t c_t,   L_t = G_t P_t E_t
        ddt_t = sum_n (L_t a + G_t b_t x_t),  dx_t = sum_n G_t dt_t b_t
                + dy_t d_skip
        db_t = sum_d G_t dt_t x_t,   dc_t = sum_d dy_t h_t
        da += L_t dt_t,   dd_skip += dy_t x_t,   G = G_t E_t

    da and dd_skip summed over the batch too.  Returns (ddt, da (D, N),
    db, dc, dx, dd_skip (D), the initial state's gradient (B, D, N)).  It
    keeps every state of the forward, so it is the kernel's reference,
    not a route of the model."""
    f32 = torch.float32
    dt32, x32, b32, c32, dy32 = (v.to(f32) for v in (dt, x, b, c, dy))
    a32, ds32 = a.to(f32), d_skip.to(f32)
    bsz, t, d = dt.shape
    h = (torch.zeros((bsz, d, a.shape[1]), dtype=f32, device=dt.device)
         if initial_state is None else initial_state.to(f32))
    states = []                      # P_t, the forward's own roundings
    for i in range(t):
        states.append(h)
        dt_i = dt32[:, i, :, None]
        h = (torch.exp(dt_i * a32) * h
             + dt_i * b32[:, i, None, :] * x32[:, i, :, None])
    g = (torch.zeros_like(h) if dstate is None
         else dstate.to(f32).clone())
    ddt, dx = torch.empty_like(dt32), torch.empty_like(dt32)
    db, dc = torch.empty_like(b32), torch.empty_like(b32)
    da = torch.zeros_like(a32)
    for i in reversed(range(t)):
        dt_i, x_i, dy_i = (v[:, i, :, None] for v in (dt32, x32, dy32))
        b_i, c_i = b32[:, i, None, :], c32[:, i, None, :]
        p = states[i]
        e = torch.exp(dt_i * a32)
        dtb = dt_i * b_i
        h_i = e * p + dtb * x_i
        gt = g + dy_i * c_i
        lg = gt * p * e
        dc[:, i] = (dy_i * h_i).sum(1)
        db[:, i] = (gt * (dt_i * x_i)).sum(1)
        ddt[:, i] = (lg * a32).sum(-1) + (gt * b_i).sum(-1) * x_i[..., 0]
        dx[:, i] = (gt * dtb).sum(-1) + dy_i[..., 0] * ds32
        da += (lg * dt_i).sum(0)
        g = gt * e
    return ddt, da, db, dc, dx, (dy32 * x32).sum((0, 1)), g
