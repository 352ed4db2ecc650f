"""RWKV-6 "Finch" block in PyTorch, with the JAX package's names
(``repro.models.rwkv6``): attention-free time-mix with data-dependent
decay (arXiv:2404.05892) and a squared-ReLU channel-mix.

Per layer:
  time-mix: token-shift ddlerp (a low-rank data-dependent interpolation
  between x_t and x_{t-1}) makes r, k, v, w and g; the WKV recurrence
  carries a per-head (head_dim x head_dim) fp32 state with per-channel
  decay w_t and a bonus u for the current token.
  channel-mix: token-shift lerp, relu^2 key, receptance-gated value.

The WKV of prefill and of decode (T = 1) runs through the hand-written
kernel (``kernels.ops.rwkv6_scan``); :func:`_wkv_step` is the plain
per-step recurrence the tests hold it to.  The casts follow the JAX
package: the fp32 leaves (``mix_base``, ``decay_base``, ``bonus``,
``mix_k``, ``mix_r``) stay fp32 in a bf16 model; r/k/v are cast to fp32
after the projections and the decay is computed in fp32.

Under tensor parallelism (``runtime.tensor_parallel``) a rank holds the
time mix's heads (``w_r``, ``w_k``, ``w_v``, ``w_g`` columns, ``bonus``,
``w_o`` rows) and takes its heads' channels of the whole decay;
``ln_x`` norms all d channels, so it runs on every rank's heads gathered
and each rank keeps its own; the channel mix holds ``w_k``'s d_ff
columns and ``w_v``'s d_ff rows, ``w_r`` whole, and its value's partial
products are summed over 'model'.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RWKVConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (_normal, _uniform, dense_init,
                                       norm_apply, norm_init)
from repro_torch.runtime import tensor_parallel as tp


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor   # (B, d) last token seen by time-mix
    cm_shift: torch.Tensor   # (B, d) last token seen by channel-mix
    wkv: torch.Tensor        # (B, H, dh, dh) fp32 recurrence state


def _dims(cfg: ModelConfig):
    r: RWKVConfig = cfg.rwkv
    n_heads = cfg.d_model // r.head_size
    return r, n_heads, r.head_size


def rwkv_time_mix_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    r, h, dh = _dims(cfg)
    d = cfg.d_model
    f32 = torch.float32
    return {
        # ddlerp base mixing coefficients (5 streams: r, k, v, w, g)
        "mix_base": _uniform(gen, (5, d), 0.0, 1.0, device),
        "mix_lora_a": dense_init(gen, d, 5 * r.mix_lora, dtype, device),
        "mix_lora_b": _normal(gen, (5, r.mix_lora, d), 0.01, dtype, device),
        "w_r": dense_init(gen, d, d, dtype, device),
        "w_k": dense_init(gen, d, d, dtype, device),
        "w_v": dense_init(gen, d, d, dtype, device),
        "w_g": dense_init(gen, d, d, dtype, device),
        "w_o": dense_init(gen, d, d, dtype, device),
        # data-dependent decay: w_t = exp(-exp(decay_base + lora(x)))
        "decay_base": _uniform(gen, (d,), -8.0, -5.0, device),
        "decay_lora_a": dense_init(gen, d, r.decay_lora, dtype, device),
        "decay_lora_b": _normal(gen, (r.decay_lora, d), 0.01, dtype,
                                device),
        "bonus": _normal(gen, (h, dh), 0.1, f32, device),
        "ln_x": norm_init(d, "rmsnorm", dtype, device),  # group-norm stand-in
    }


def rwkv_channel_mix_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "mix_k": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "mix_r": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "w_k": dense_init(gen, d, dff, dtype, device),
        "w_v": dense_init(gen, dff, d, dtype, device),
        "w_r": dense_init(gen, d, d, dtype, device),
    }


def _token_shift(x, last):
    """x: (B, T, d); last: (B, d) -> the x_{t-1} stream and the new
    last token."""
    prev = torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)
    return prev, x[:, -1, :]


def _wkv_step(h, r_t, k_t, v_t, w_t, bonus):
    """The plain recurrence step.  h: (B, H, dh, dh); r/k/v/w: (B, H,
    dh).  Returns (h', y_t (B, H, dh))."""
    kv = k_t[..., :, None] * v_t[..., None, :]          # (B, H, dh, dh)
    y = torch.einsum("bhk,bhkv->bhv", r_t, h + bonus[..., :, None] * kv)
    h = w_t[..., :, None] * h + kv
    return h, y


def rwkv_time_mix_apply(p, cfg: ModelConfig, x, tm_shift=None,
                        wkv_state=None):
    """x (B, T, d) -> (y, new tm_shift, new WKV state).  A prompt longer
    than the config's ``chunk`` must be a multiple of it, as the JAX
    model's chunked scan requires; otherwise ``ValueError``."""
    r, _, dh = _dims(cfg)
    n_h = p["bonus"].shape[0]               # a rank's heads under TP
    b, t, d = x.shape
    chunk = min(r.chunk, t)
    if t % chunk:
        raise ValueError(f"a prompt of {t} tokens: the rwkv6 model takes "
                         f"up to {r.chunk} or a multiple of {r.chunk}")
    if tm_shift is None:
        tm_shift = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    prev, new_shift = _token_shift(x, tm_shift)

    # ddlerp: data-dependent interpolation between x_t and x_{t-1}
    delta = prev - x
    lora = torch.tanh(x @ p["mix_lora_a"]).reshape(b, t, 5, r.mix_lora)
    dyn = torch.einsum("btsr,srd->btsd", lora,
                       p["mix_lora_b"].to(x.dtype))
    mix = torch.sigmoid(p["mix_base"].to(x.dtype) + dyn)    # (b, t, 5, d)
    xr, xk, xv, xw, xg = [x + delta * mix[:, :, i] for i in range(5)]

    f32 = torch.float32
    r_s = (xr @ p["w_r"]).reshape(b, t, n_h, dh).to(f32)
    k_s = (xk @ p["w_k"]).reshape(b, t, n_h, dh).to(f32)
    v_s = (xv @ p["w_v"]).reshape(b, t, n_h, dh).to(f32)
    g_s = F.silu(xg @ p["w_g"])

    decay = (tp.own(p["decay_base"], 0).to(f32)
             + (torch.tanh(xw @ p["decay_lora_a"])
                @ tp.own(p["decay_lora_b"], 1)).to(f32))
    w_s = torch.exp(-torch.exp(decay)).reshape(b, t, n_h, dh)  # (0, 1)

    ys, h = ops.rwkv6_scan(r_s, k_s, v_s, w_s, p["bonus"].to(f32),
                           wkv_state)
    y = ys.reshape(b, t, n_h * dh).to(x.dtype)
    # ln_x norms all d channels: under TP over every rank's heads
    y = tp.own(norm_apply(p["ln_x"], tp.gather_heads(y)), -1) * g_s
    return tp.reduce(y @ p["w_o"]), new_shift, h


def rwkv_channel_mix_apply(p, cfg: ModelConfig, x, cm_shift=None):
    b, t, d = x.shape
    if cm_shift is None:
        cm_shift = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    prev, new_shift = _token_shift(x, cm_shift)
    xk = x + (prev - x) * p["mix_k"].to(x.dtype)
    xr = x + (prev - x) * p["mix_r"].to(x.dtype)
    k = torch.square(F.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * tp.reduce(k @ p["w_v"]), new_shift


def rwkv_state_init(cfg: ModelConfig, batch: int, dtype,
                    device) -> RWKVState:
    _, n_h, dh = _dims(cfg)
    return RWKVState(
        tm_shift=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        cm_shift=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        wkv=torch.zeros((batch, n_h, dh, dh), dtype=torch.float32,
                        device=device))


__all__ = ["RWKVState", "rwkv_time_mix_init", "rwkv_channel_mix_init",
           "rwkv_time_mix_apply", "rwkv_channel_mix_apply",
           "rwkv_state_init"]
