"""Mamba's depthwise causal conv and its backward: the CUDA kernels and
their plain versions.

:func:`causal_conv1d` launches the kernel of ``csrc/causal_conv1d.cu``
(a thread per (batch row, 16 bytes of channels, tile of steps), the
three inputs before its tile in registers, the products, sums, bias and
SiLU in the plain version's rounding order) for CUDA tensors and runs
:func:`causal_conv1d_plain` for CPU tensors.  It replaces the JAX
package's ``repro.models.mamba._conv1d_causal``, which no Pallas kernel
covers: in plain PyTorch the conv is four or more passes over the
(B, T, d_inner) activations.  x may be a view with a row stride (the x
half of the input projection).

Under autograd on the card its backward launches
``csrc/causal_conv1d_bwd.cu`` (:func:`causal_conv1d_bwd`): a thread per
(batch row, 4 bytes of channels, tile of :data:`BWD_TILE` steps) walks
its tile backwards with its rows of x and dout streaming through a ring
in shared memory, recomputes the pre-activation as the forward does,
writes dx and the state's gradient, and leaves the weight's and bias's
gradients as per-tile partials that a second kernel sums in a fixed
order (no atomics).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.backend import (aligned, float_code, launch,
                                         use_kernel)
from repro_torch.kernels.ref import (causal_conv1d_bwd_plain,
                                     causal_conv1d_plain)

#: the conv widths the kernels are built for (``MambaConfig.d_conv``)
WIDTHS = (4,)
#: steps of a thread's tile in the backward: each tile leaves one fp32
#: partial of the four weight rows and the bias per channel
BWD_TILE = 128

__all__ = ["causal_conv1d", "causal_conv1d_plain", "causal_conv1d_bwd",
           "causal_conv1d_bwd_plain", "bwd_scratch_floats", "WIDTHS",
           "BWD_TILE"]


def _check(x, weight, bias, state) -> int:
    """Raise unless the kernels take these tensors; returns the float type
    code.  x (B, T, D) needs a unit channel stride and, like every other
    tensor, 16-byte alignment of its rows; the rest contiguous."""
    if x.ndim != 3 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, T, D) with B, T >= 1, got "
                         f"{tuple(x.shape)}")
    b, t, d = x.shape
    k = weight.shape[0]
    if k not in WIDTHS or weight.shape != (k, d) or bias.shape != (d,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)}: the kernel takes ({WIDTHS}, "
                         f"{d}) and ({d},)")
    code = float_code(weight, bias)
    if x.dtype != weight.dtype:
        raise TypeError(f"x is {x.dtype}, weight {weight.dtype}")
    vec = 16 // x.element_size()
    if (d % vec or x.stride(2) != 1 or x.stride(1) % vec
            or x.stride(0) % vec or x.stride(0) >= 2 ** 31
            or x.data_ptr() % 16 or weight.data_ptr() % 16
            or bias.data_ptr() % 16):
        raise ValueError(f"the conv kernels take d_inner a multiple of {vec} "
                         f"and 16-byte aligned rows, got {d}, strides "
                         f"{x.stride()}")
    if state is not None:
        if state.shape != (b, k - 1, d):
            raise ValueError(f"state has shape {tuple(state.shape)}, "
                             f"expected ({b}, {k - 1}, {d})")
        float_code(state, weight)
        if state.data_ptr() % 16:
            raise ValueError("the conv state must be 16-byte aligned")
    return code


def _forward(x, weight, bias, state):
    code = _check(x, weight, bias, state)
    b, t, d = x.shape
    out = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    new_state = torch.empty((b, weight.shape[0] - 1, d), dtype=x.dtype,
                            device=x.device)
    launch("causal_conv1d", x.get_device(), x.data_ptr(), weight.data_ptr(),
           bias.data_ptr(), None if state is None else state.data_ptr(),
           out.data_ptr(), new_state.data_ptr(), b, t, d, x.stride(0),
           x.stride(1), code)
    causal_conv1d.launches += 1
    return out, new_state


class _CausalConv(torch.autograd.Function):
    """The conv under autograd: the forward launch, then
    :func:`causal_conv1d_bwd`.  Both route by device."""

    @staticmethod
    def forward(ctx, x, weight, bias, state):
        state_in = () if state is None else (state,)
        out, new_state = (_forward if use_kernel(x, weight, bias, *state_in)
                          else causal_conv1d_plain)(x, weight, bias, state)
        ctx.save_for_backward(x, weight, bias, state)
        ctx.set_materialize_grads(False)
        return out, new_state

    @staticmethod
    def backward(ctx, dout, dstate_out):
        x, weight, bias, state = ctx.saved_tensors
        dout = torch.zeros_like(x) if dout is None else aligned(dout)
        if dstate_out is not None:
            dstate_out = aligned(dstate_out)
        dx, dw, db, dstate = causal_conv1d_bwd(x, weight, bias, state, dout,
                                               dstate_out)
        return dx, dw, db, None if state is None else dstate


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """The depthwise causal conv of x (B, T, D) with weight (4, D) and bias
    (D), then SiLU, after the conv state (B, 3, D) (None: zeros).  Returns
    (out (B, T, D), new state (B, 3, D)), both in x's type.  CUDA tensors
    (fp32 or bf16, one type; x with a unit channel stride and 16-byte
    aligned rows) launch the kernel and add one to
    ``causal_conv1d.launches``; under grad mode with an input that
    requires a gradient the result carries one, which
    :func:`causal_conv1d_bwd` computes.  CPU tensors run
    :func:`causal_conv1d_plain`, which autograd differentiates."""
    state_in = () if state is None else (state,)
    if not use_kernel(x, weight, bias, *state_in):
        return causal_conv1d_plain(x, weight, bias, state)
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x, weight, bias) + state_in):
        return _CausalConv.apply(x, weight, bias, state)
    return _forward(x, weight, bias, state)


def bwd_scratch_floats(b: int, t: int, d: int, k: int = 4) -> int:
    """The backward's device scratch, in floats: one partial of the k
    weight rows and the bias per (batch row, tile of :data:`BWD_TILE`
    steps, channel), (k + 1) / BWD_TILE floats per element of x."""
    return b * -(-t // BWD_TILE) * (k + 1) * d


def causal_conv1d_bwd(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, state: Optional[torch.Tensor],
                      dout: torch.Tensor,
                      dstate_out: Optional[torch.Tensor] = None):
    """The gradients of :func:`causal_conv1d` against the output's gradient
    ``dout`` and the new state's ``dstate_out`` (None: zeros).  Returns
    (dx (B, T, D) in x's type, dweight, dbias in theirs, the state's
    gradient (B, 3, D) in x's type: that of the zeros read without a
    state).  CUDA tensors
    launch the backward kernel (two kernels: the tiles, then the fixed
    order sum of the weight's and bias's partials) and add one to
    ``causal_conv1d_bwd.launches``; CPU tensors run
    :func:`causal_conv1d_bwd_plain`."""
    extra = tuple(v for v in (state, dstate_out) if v is not None)
    if not use_kernel(x, weight, bias, dout, *extra):
        return causal_conv1d_bwd_plain(x, weight, bias, state, dout,
                                       dstate_out)
    code = _check(x, weight, bias, state)
    b, t, d = x.shape
    k = weight.shape[0]
    if dout.shape != (b, t, d) or float_code(dout, weight) != code:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype}, expected "
                         f"{(b, t, d)} {x.dtype}")
    if dstate_out is not None and (dstate_out.shape != (b, k - 1, d)
                                   or float_code(dstate_out) != code):
        raise ValueError(f"dstate_out {tuple(dstate_out.shape)}, expected "
                         f"({b}, {k - 1}, {d})")
    if any(v.data_ptr() % 16 for v in (dout,) + extra):
        raise ValueError("the conv backward reads 16-byte aligned tensors")
    dx = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    dstate = torch.empty((b, k - 1, d), dtype=x.dtype, device=x.device)
    dw = torch.empty((k, d), dtype=torch.float32, device=x.device)
    db = torch.empty((d,), dtype=torch.float32, device=x.device)
    scratch = torch.empty(bwd_scratch_floats(b, t, d, k),
                          dtype=torch.float32, device=x.device)
    launch("causal_conv1d_bwd", x.get_device(), x.data_ptr(),
           weight.data_ptr(), bias.data_ptr(),
           None if state is None else state.data_ptr(), dout.data_ptr(),
           None if dstate_out is None else dstate_out.data_ptr(),
           dx.data_ptr(), dw.data_ptr(), db.data_ptr(), dstate.data_ptr(),
           scratch.data_ptr(), b, t, d, x.stride(0), x.stride(1), code)
    causal_conv1d_bwd.launches += 1
    return dx, dw.to(weight.dtype), db.to(bias.dtype), dstate


#: kernel launches since the count was last set to 0
causal_conv1d.launches = 0
causal_conv1d_bwd.launches = 0
