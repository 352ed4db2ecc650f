"""Flash attention (prefill, GQA) and its backward: the CUDA kernels and
their plain versions.

The head dims are a pair: q and k share one, v and the output have their
own.  The GQA models run equal dims; MLA (deepseek-v2-lite) runs a key
of 192 (128 + 64 rope) and a value of 128 (:data:`HEAD_DIMS`).

:func:`flash_attention` launches a kernel of ``csrc/flash_attention.cu``
for CUDA tensors, which replaces the TPU kernel of the JAX package
(``flash_attention_pallas``), and runs :func:`attention_plain` for CPU
tensors.  The input type chooses the kernel: bf16 runs on the tensor
cores (wgmma on 128-row q tiles, K/V fed by TMA through a ring in shared
memory, online fp32 softmax, P fed as two bf16 terms so the product
keeps fp32-grade P), fp32 on the CUDA cores (FA-2 schedule, 64-row q
tiles), since a tensor-core fp32 product is TF32.  Both skip causal
tiles past the diagonal and mask ragged lengths.  A cached prefill at an
offset passes ``q_offset`` and ``kv_len`` (each int32 (B,) on the
device): row ``r`` of batch row ``b`` then sits at ``q_offset[b] + r``
and keys at ``>= kv_len[b]`` are masked, read by the kernel from device
memory (no host read), over K / V as long as the whole cache.

When grad mode is on and an input requires a gradient, the CUDA route
goes through an autograd function: its forward launches the same kernel
with a buffer for each row's log-sum-exp, and its backward launches
:func:`flash_attention_bwd` (``csrc/flash_attention_bwd.cu``: dQ, dK,
dV in deterministic passes; bf16 on ``wgmma`` with TMA-fed rings, the
dK/dV pass's query group split over blocks by :func:`bwd_plan` where
its grid would not fill the card), which replaces ``jax.grad`` of the
JAX package's attention.  CPU tensors differentiate the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.backend import (FLOAT_CODES, float_code, launch,
                                         use_kernel)
# a module name of its own: a card test and chip_smoke.py patch it to
# force the head split on and off
from repro_torch.kernels.backend import sm_count as _sm_count
from repro_torch.kernels.ref import attention_bwd_plain, attention_plain

#: the (q and k, v) head-dim pairs the kernels are built for
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))

#: keys of a dK/dV block and rows of a q tile in the bf16 backward
BWD_TILE = 64
#: the waves of blocks under which the dK/dV pass splits its query groups
BWD_MIN_WAVES = 2

__all__ = ["flash_attention", "flash_attention_bwd", "attention_plain",
           "attention_bwd_plain", "bwd_plan", "BwdPlan", "HEAD_DIMS"]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class BwdPlan(NamedTuple):
    """The bf16 backward's launch plan (``bwd_plan``): what the launch
    takes besides the shape.

    ``head_splits``: S_h, the blocks that share one (batch, kv head, key
    tile) of the dK/dV pass, each over ``group // S_h`` consecutive query
    heads; ``scratch_floats``: the fp32 scratch the launch takes, each
    row's lse log2 e and D padded to 64 rows (2 B Hq Lq_pad) and, when
    S_h > 1, the splits' partial dK and dV (2 S_h B Hkv Lk_pad D)."""
    head_splits: int
    scratch_floats: int


def bwd_plan(b: int, hq: int, hkv: int, lq: int, lk: int, d: int,
             sms: int) -> BwdPlan:
    """The bf16 backward's plan at a shape, on a card of ``sms`` SMs.

    The dK/dV pass runs a block per (batch, kv head, 64 keys); where that
    grid holds fewer than ``BWD_MIN_WAVES`` blocks an SM (gemma-2b: 4 x 1
    x 32 = 128 on 132 SMs) each query group of 4 or more heads is split
    over S_h blocks, doubling S_h while the grid is short and each block
    keeps two heads or more (gemma-2b: S_h = 4, 512 blocks).  Groups of 1
    and 2 never split: a block of one head would send its whole dK and
    dV through memory to save no more than one head's walk."""
    group = hq // hkv
    n_kt = _ceil(lk, BWD_TILE)
    head_splits = 1
    while (b * hkv * n_kt * head_splits < BWD_MIN_WAVES * sms
           and group % (2 * head_splits) == 0
           and group // (2 * head_splits) >= 2):
        head_splits *= 2
    floats = 2 * b * hq * _ceil(lq, BWD_TILE) * BWD_TILE
    if head_splits > 1:
        floats += 2 * head_splits * b * hkv * n_kt * BWD_TILE * d
    return BwdPlan(head_splits, floats)


def _check(q, k, v) -> int:
    """Raise unless the kernels take q, k, v; returns their type code."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError("q must be (B, Hq, Lq, D), k (B, Hkv, Lk, D) and "
                         "v (B, Hkv, Lk, Dv)")
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"differ in batch or head dim, or Hq % Hkv != 0")
    if (d, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (D, Dv) = {(d, v.shape[3])}; the "
                         f"kernel is built for {HEAD_DIMS}")
    return float_code(q, k, v)


def _row_pointer(name: str, t, q) -> Optional[int]:
    """The device pointer of a per-row ``q_offset`` or ``kv_len`` (None
    stays None); raises unless it is a contiguous int32 (B,) tensor on
    q's device."""
    if t is None:
        return None
    b = q.shape[0]
    if (t.dtype != torch.int32 or tuple(t.shape) != (b,)
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"{name} must be a contiguous int32 ({b},) tensor "
                         f"on {q.device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")
    return t.data_ptr()


def _forward(q, k, v, causal: bool, scale, with_lse: bool, q_offset=None,
             kv_len=None):
    """One launch of the forward kernel: the output and, ``with_lse``,
    each row's fp32 log-sum-exp (B, Hq, Lq) (else None)."""
    code = _check(q, k, v)
    b, hq, lq, d = q.shape
    hkv, lk, d_v = k.shape[1], k.shape[2], v.shape[3]
    if causal and lq > lk:
        raise ValueError("causal attention needs Lq <= Lk")
    if q_offset is not None and lq > lk:
        raise ValueError("per-row query offsets need Lq <= Lk")
    offsets = _row_pointer("q_offset", q_offset, q)
    lengths = _row_pointer("kv_len", kv_len, q)
    out = q.new_empty((b, hq, lq, d_v))
    if code == FLOAT_CODES[torch.bfloat16] and any(
            t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("bf16 attention reads its inputs by TMA, which "
                         "needs 16-byte aligned tensors")
    lse = (torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    scale = d ** -0.5 if scale is None else float(scale)
    launch("flash_attention", q.get_device(), q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(),
           None if lse is None else lse.data_ptr(), offsets, lengths, b, hq,
           hkv, lq, lk, d, d_v, int(causal), scale, code)
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The CUDA route under autograd: forward kernel with row statistics,
    backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:       # the kernel reads 16-byte rows
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention of q (B, Hq, Lq, D) over k (B, Hkv, Lk, D) and
    v (B, Hkv, Lk, Dv), query head ``h`` reading kv head
    ``h // (Hq // Hkv)``; causal rows are the last Lq of Lk positions,
    or, with ``q_offset`` (B,), row ``r`` of batch row ``b`` sits at
    ``q_offset[b] + r`` (a cached prefill over a cache of Lk positions);
    ``kv_len`` (B,) masks the keys at ``>= kv_len[b]`` (their rows of the
    cache must be finite: they enter as P = 0); ``scale`` defaults to
    D ** -0.5.  Returns (B, Hq, Lq, Dv) in q's type.  CUDA tensors
    (contiguous, one type of fp32 / bf16, (D, Dv) in :data:`HEAD_DIMS`,
    any Lq <= Lk; ``q_offset`` and ``kv_len`` contiguous int32 on q's
    device, read by the kernel) launch the kernel and add one to
    ``flash_attention.launches``; under grad mode with an input that
    requires a gradient the result carries one, which
    :func:`flash_attention_bwd` computes, and with per-row offsets or
    lengths the call raises ``NotImplementedError`` (the backward kernel
    takes neither: no path trains through a cache).  CPU tensors run
    :func:`attention_plain`."""
    rows = tuple(t for t in (q_offset, kv_len) if t is not None)
    if not use_kernel(q, k, v, *rows):
        return attention_plain(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, kv_len=kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if rows:
            raise NotImplementedError(
                "flash_attention with per-row offsets or lengths has no "
                "backward kernel: training runs the cache-free prefill "
                "(ROADMAP.md section 2)")
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, with_lse=False,
                    q_offset=q_offset, kv_len=kv_len)[0]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention` at q, k, v, whose rows'
    log-sum-exp the forward gave as ``lse`` (fp32 (B, Hq, Lq)), against
    the output's gradient ``dout`` (B, Hq, Lq, Dv); each in its input's
    type and shape.
    CUDA tensors (as the forward takes them, all 16-byte aligned, ``dout``
    contiguous and of q's type) launch the backward kernel (dQ and each
    row's sum of P o dP in one pass, dK and dV in a second) and add one
    to ``flash_attention_bwd.launches``; CPU tensors differentiate
    :func:`attention_plain` (``lse`` unused).  The bf16 dK/dV pass splits
    each query group as :func:`bwd_plan` says for the card's SM count."""
    if not use_kernel(q, k, v, dout):
        return attention_bwd_plain(q, k, v, dout, causal, scale)
    code = _check(q, k, v)
    b, hq, lq, d = q.shape
    hkv, lk, d_v = k.shape[1], k.shape[2], v.shape[3]
    if causal and lq > lk:
        raise ValueError("causal attention needs Lq <= Lk")
    float_code(q, dout)
    if dout.shape != (b, hq, lq, d_v):
        raise ValueError(f"dout has shape {tuple(dout.shape)}, expected "
                         f"the output's {(b, hq, lq, d_v)}")
    if (lse.shape != (b, hq, lq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be the forward's contiguous fp32 "
                         f"({b}, {hq}, {lq}) row statistics")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v, dout, dq, dk, dv)):
        raise ValueError("the attention backward reads and writes 16-byte "
                         "rows, which needs 16-byte aligned tensors")
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    index = q.get_device()
    delta = scratch = None
    splits = 1
    if code == FLOAT_CODES[torch.float32]:
        delta = torch.empty((b, hq, lq), dtype=torch.float32,
                            device=q.device)
    else:
        plan = bwd_plan(b, hq, hkv, lq, lk, d, _sm_count(index))
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                              device=q.device)
        splits = plan.head_splits
    launch("flash_attention_bwd", index, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           None if delta is None else delta.data_ptr(),
           None if scratch is None else scratch.data_ptr(), dq.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), b, hq, hkv, lq, lk, d, d_v,
           int(causal), d ** -0.5 if scale is None else float(scale), splits,
           code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
flash_attention_bwd.launches = 0
