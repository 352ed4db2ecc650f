"""Mamba-1 selective SSM block (Jamba's sequence mixer) in PyTorch, with
the JAX package's names (``repro.models.mamba``).

Per layer: the input projection to x and the gate z (each d_inner =
expand * d_model wide); a depthwise causal conv of x over time (d_conv
taps) and SiLU; the data-dependent step dt (softplus of a rank-dt_rank
projection plus a bias), b and c (d_state each); the selective scan
``h = exp(dt a) h + dt b x``, ``y = sum_n h c + x d_skip`` with a =
-exp(a_log); then ``(y * silu(z)) @ w_out``.

The conv runs through ``kernels.ops.causal_conv1d``, a hand-written
kernel on the card.  The scan runs through
``kernels.ops.selective_scan_gated`` when no input needs a gradient
(prefill and decode): one launch that also takes dt's softplus and the
SiLU gate, reading and writing the model type.  Under autograd it runs
the JAX package's chain: dt's softplus, ``kernels.ops.selective_scan``
on fp32 inputs (its backward a kernel too), the cast and the gate as
torch ops; the two give the same bits.  :func:`_ssm_step` is the plain
recurrence step the tests hold them to.  The casts follow the JAX
package: the conv in the model type, dt, b, c and the scan in fp32
(``dt_bias``, ``a_log`` and ``d_skip`` are fp32 leaves of a bf16 model),
y cast back before the gate.  A prompt longer
than the config's ``chunk`` must be a multiple of it, as the JAX model's
chunked scan requires; decode carries the conv state (the last d_conv -
1 inputs, model type) and the fp32 scan state, O(1) a token.

Under tensor parallelism (``runtime.tensor_parallel``) a rank holds
inner channels of x and the same channels of z (its ``w_in`` block
[x_r | z_r], whose width gives the rank's d_inner), the conv, dt and
scan leaves of those channels and ``w_x_dbc``'s and ``w_out``'s rows;
the partial products of both are summed over 'model', ``w_x_dbc``'s
before dt, b and c are taken from it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import _normal, _uniform, dense_init
from repro_torch.runtime import tensor_parallel as tp


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv - 1, d_inner), the model type
    ssm: torch.Tensor    # (B, d_inner, d_state) fp32


def _dims(cfg: ModelConfig):
    m: MambaConfig = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or max(1, math.ceil(cfg.d_model / 16))
    return m, d_inner, dt_rank


def mamba_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    m, d_inner, dt_rank = _dims(cfg)
    d = cfg.d_model
    f32 = torch.float32
    # dt's bias: the inverse softplus of U(1e-3, 1e-1)
    dt0 = torch.clamp(_uniform(gen, (d_inner,), 1e-3, 1e-1, device),
                      min=1e-4)
    return {
        "w_in": dense_init(gen, d, 2 * d_inner, dtype, device),
        "conv_w": _normal(gen, (m.d_conv, d_inner), 0.1, dtype, device),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "w_x_dbc": dense_init(gen, d_inner, dt_rank + 2 * m.d_state, dtype,
                              device),
        "w_dt": dense_init(gen, dt_rank, d_inner, dtype, device),
        "dt_bias": torch.log(torch.expm1(dt0)),
        # S4D-real init: A = -(1..d_state), log-parameterized
        "a_log": torch.log(torch.arange(
            1, m.d_state + 1, dtype=f32, device=device)).expand(
                d_inner, m.d_state).contiguous(),
        "d_skip": torch.ones((d_inner,), dtype=f32, device=device),
        "w_out": dense_init(gen, d_inner, d, dtype, device),
    }


def _conv1d_causal(p, cfg: ModelConfig, x, conv_state=None):
    """Depthwise causal conv over time and SiLU; returns (y, new
    state)."""
    return ops.causal_conv1d(x, p["conv_w"], p["conv_b"], conv_state)


def _projections(p, cfg: ModelConfig, xc):
    """xc: (B, T, d_inner) post-conv -> (dt's projection (B, T, d_inner)
    in xc's type, b_t, c_t fp32)."""
    m, _, dt_rank = _dims(cfg)
    f32 = torch.float32
    dbc = tp.reduce(xc @ p["w_x_dbc"])     # a rank's channels' partial
    b_t = dbc[..., dt_rank:dt_rank + m.d_state].to(f32).contiguous()
    c_t = dbc[..., dt_rank + m.d_state:].to(f32).contiguous()
    return dbc[..., :dt_rank] @ p["w_dt"], b_t, c_t


def _selective_params(p, cfg: ModelConfig, xc):
    """xc: (B, T, d_inner) post-conv -> (dt, b_t, c_t), fp32."""
    dt_raw, b_t, c_t = _projections(p, cfg, xc)
    return (F.softplus(dt_raw.to(torch.float32) + p["dt_bias"]), b_t,
            c_t)


def _ssm_step(a, h, dt_t, b_t, c_t, x_t):
    """The plain recurrence step.  h: (B, D, N); dt/x: (B, D); b/c:
    (B, N).  Returns (h', y_t (B, D))."""
    da = torch.exp(dt_t[..., None] * a)
    dbx = dt_t[..., None] * b_t[:, None, :] * x_t[..., None]
    h = da * h + dbx
    return h, torch.einsum("bdn,bn->bd", h, c_t)


def mamba_apply(p, cfg: ModelConfig, x, state: MambaState | None = None):
    """x: (B, T, d_model) -> (y, new state).  A prompt longer than the
    config's ``chunk`` must be a multiple of it; otherwise
    ``ValueError``."""
    m = cfg.mamba
    d_inner = p["d_skip"].shape[0]          # a rank's channels under TP
    t = x.shape[1]
    chunk = min(m.chunk, t)
    if t % chunk:
        raise ValueError(f"a prompt of {t} tokens: the mamba model takes "
                         f"up to {m.chunk} or a multiple of {m.chunk}")
    a = -torch.exp(p["a_log"])                           # (D, N)
    xz = x @ p["w_in"]
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    xc, new_conv = _conv1d_causal(p, cfg, xs,
                                  None if state is None else state.conv)
    ssm = () if state is None else (state.ssm,)
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x, *p.values(), *(state or ()))):
        dt, b_t, c_t = _selective_params(p, cfg, xc)
        y, h = ops.selective_scan(dt, a, b_t, c_t, xc.to(torch.float32),
                                  p["d_skip"], *ssm)
        y = y.to(x.dtype) * F.silu(z)
    else:
        dt_raw, b_t, c_t = _projections(p, cfg, xc)
        y, h = ops.selective_scan_gated(dt_raw, p["dt_bias"], a, b_t, c_t,
                                        xc, z, p["d_skip"], *ssm)
    return tp.reduce(y @ p["w_out"]), MambaState(conv=new_conv, ssm=h)


def mamba_state_init(cfg: ModelConfig, batch: int, dtype,
                     device) -> MambaState:
    m, d_inner, _ = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, m.d_conv - 1, d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, d_inner, m.d_state), dtype=torch.float32,
                        device=device))


__all__ = ["MambaState", "mamba_init", "mamba_apply", "mamba_state_init"]
