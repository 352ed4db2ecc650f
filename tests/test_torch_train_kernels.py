"""Gradients of the port's attention and RMSNorm on the CPU (their plain
versions under autograd, the route every CPU tensor takes, and the
backward wrappers' plain route) against ``jax.grad`` of the JAX
package's functions: ``repro.kernels.ref.attention_ref`` and
``repro.models.attention._sdpa`` for attention, ``repro.models.common
.norm_apply`` for RMSNorm.  Causal inputs with GQA groups 1, 2 and 4,
S = 37 and 64, D = 32, fp32; tolerance atol and rtol 1e-5 (the same
function in fp32, summed in other orders).  The CUDA kernels are held to
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.ref import attention_ref  # noqa: E402
from repro.models.attention import _sdpa  # noqa: E402
from repro.models.common import norm_apply as j_norm_apply  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.ref import attention_lse_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.models.common import norm_apply  # noqa: E402

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-5, rtol=1e-5)
D = 32


def _attention_inputs(hq, hkv, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, hq, s, D)).astype(np.float32)
    k = rng.standard_normal((2, hkv, s, D)).astype(np.float32)
    v = rng.standard_normal((2, hkv, s, D)).astype(np.float32)
    dout = rng.standard_normal((2, hq, s, D)).astype(np.float32)
    return q, k, v, dout


def _jax_vjp(fn, inputs, dout):
    """The gradients of ``fn`` at ``inputs`` against ``dout``, jitted
    (one compile; op-by-op tracing of the vjp is slower)."""
    grads = jax.jit(lambda *a: jax.vjp(fn, *a[:-1])[1](a[-1]))(
        *inputs, dout)
    return [np.asarray(g) for g in grads]


def _torch_grads(fn, inputs, dout):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(dout))


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (4, 1)])
@pytest.mark.parametrize("s", [37, 64])
def test_attention_grads_match_jax(hq, hkv, s):
    q, k, v, dout = _attention_inputs(hq, hkv, s, seed=10 * s + hq + hkv)
    # the Pallas kernel's oracle, head-major as the port's kernels
    want = _jax_vjp(lambda a, b, c: attention_ref(a, b, c, causal=True),
                    (q, k, v), dout)
    # the model's attention, (B, S, H, D), what the JAX package trains
    seq = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa
    want_sdpa = [g.transpose(0, 2, 1, 3) for g in _jax_vjp(
        lambda a, b, c: _sdpa(a, b, c, causal=True),
        (seq(q), seq(k), seq(v)), seq(dout))]

    launches = flash_attention.launches, flash_attention_bwd.launches
    out, got = _torch_grads(lambda a, b, c: ops.flash_attention(a, b, c),
                            (q, k, v), dout)
    tq, tk, tv, tdout = (torch.from_numpy(x) for x in (q, k, v, dout))
    direct = flash_attention_bwd(tq, tk, tv, tdout,
                                 attention_lse_plain(tq, tk))
    assert (flash_attention.launches,
            flash_attention_bwd.launches) == launches
    assert_allclose(out.detach().numpy(), np.asarray(
        attention_ref(q, k, v, causal=True)), **TOL)
    for name, g, d, w, w2 in zip("qkv", got, direct, want, want_sdpa):
        assert g.shape == w.shape, name
        assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name} vs ref")
        assert_allclose(g.numpy(), w2, **TOL, err_msg=f"d{name} vs _sdpa")
        assert_allclose(d.numpy(), g.numpy(), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("lq,lk", [(37, 37), (20, 64)])
def test_attention_lse_matches_jax(lq, lk):
    """The row statistics the forward kernel writes for its backward: the
    natural log-sum-exp of each row's scaled, causally masked logits."""
    rng = np.random.default_rng(lq)
    q = rng.standard_normal((2, 4, lq, D)).astype(np.float32)
    k = rng.standard_normal((2, 2, lk, D)).astype(np.float32)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q * D ** -0.5,
                        jnp.repeat(k, 2, axis=1))
    qpos = jnp.arange(lq)[:, None] + (lk - lq)
    logits = jnp.where(jnp.arange(lk)[None, :] <= qpos, logits, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    got = attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k))
    assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 37, 64), (2, 37, 4, 32), (5, 128)])
def test_rmsnorm_grads_match_jax(shape):
    """dx and dweight of the port's norm (the model's ``norm_apply``, the
    rmsnorm wrapper under autograd, and the backward wrapper's plain
    route) against ``jax.grad`` of the JAX package's ``norm_apply``; the
    4-d shape is qk-norm's (a row per token and head)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    want = _jax_vjp(lambda a, s: j_norm_apply({"scale": s}, a), (x, w), dy)

    launches = rmsnorm.launches, rmsnorm_bwd.launches
    _, got = _torch_grads(lambda a, s: norm_apply({"scale": s}, a),
                          (x, w), dy)
    _, wrapped = _torch_grads(rmsnorm, (x, w), dy)
    direct = rmsnorm_bwd(*(torch.from_numpy(t) for t in (x, w, dy)))
    assert (rmsnorm.launches, rmsnorm_bwd.launches) == launches
    for name, g, g2, d, e in zip(("dx", "dw"), got, wrapped, direct, want):
        assert_allclose(g.numpy(), e, **TOL, err_msg=name)
        assert_allclose(g2.numpy(), e, **TOL, err_msg=name)
        assert_allclose(d.numpy(), e, **TOL, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 37, 64), (2, 37, 4, 32), (5, 128)])
def test_rmsnorm_cast_first_grads_match_jax(shape):
    """The cast-first twin (``rmsnorm(..., cast_first=True)``, the order
    the model runs) under autograd and the backward wrapper's plain route
    in that order against ``jax.grad`` of the JAX package's
    ``norm_apply``, fp32; in bf16 the wrapper's autograd and
    ``rmsnorm_bwd(..., cast_first=True)`` agree bit for bit."""
    rng = np.random.default_rng(sum(shape) + 1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    want = _jax_vjp(lambda a, s: j_norm_apply({"scale": s}, a), (x, w), dy)
    launches = rmsnorm.launches, rmsnorm_bwd.launches
    _, wrapped = _torch_grads(
        lambda a, s: rmsnorm(a, s, cast_first=True), (x, w), dy)
    direct = rmsnorm_bwd(*(torch.from_numpy(t) for t in (x, w, dy)),
                         cast_first=True)
    for name, g, d, e in zip(("dx", "dw"), wrapped, direct, want):
        assert_allclose(g.numpy(), e, **TOL, err_msg=name)
        assert_allclose(d.numpy(), e, **TOL, err_msg=name)
    xb, wb, dyb = (torch.from_numpy(t).bfloat16() for t in (x, w, dy))
    leaves = [xb.clone().requires_grad_(True), wb.clone().requires_grad_(True)]
    got = torch.autograd.grad(rmsnorm(*leaves, cast_first=True), leaves, dyb)
    for g, d in zip(got, rmsnorm_bwd(xb, wb, dyb, cast_first=True)):
        assert g.dtype == torch.bfloat16 and torch.equal(g, d)
    assert (rmsnorm.launches, rmsnorm_bwd.launches) == launches
