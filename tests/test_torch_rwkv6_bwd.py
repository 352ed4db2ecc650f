"""The WKV recurrence's backward on the CPU: the plain reverse recurrence
(``kernels.ref.rwkv6_scan_bwd_plain``, the CUDA backward kernel's
reference on the card) against autograd of the plain forward
(``rwkv6_scan_plain``) at rtol 1e-5 / atol 1e-6 in fp32, with ragged
lengths, lengths that are no multiple of the checkpoint spacing, an
initial state and a final state's gradient; against ``jax.vjp`` of the
JAX package's chunked time-mix scan (``repro.models.rwkv6._wkv_step``
under ``jax.checkpoint`` chunks, as ``rwkv_time_mix_apply`` scans it) at
the same tolerances; the checkpoints of the forward as training writes
them; and one rwkv6 smoke ``forward_train`` whose WKV runs through the
autograd function's CPU route (the checkpointing forward and this plain
backward) against ``jax.value_and_grad`` of ``repro``'s loss, at the
training tolerances of ``test_torch_train.py`` (loss rtol 1e-5, leaves
atol 1e-5 / rtol 1e-4).  Inputs are numpy draws from fixed seeds."""

import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (rwkv6_scan_bwd_plain,  # noqa: E402
                                     rwkv6_scan_plain)
from repro_torch.runtime import steps as tsteps  # noqa: E402

pytestmark = pytest.mark.torch

# the module (``repro_torch.kernels`` exports its function of that name)
wkv = importlib.import_module("repro_torch.kernels.rwkv6_scan")

TOL = dict(rtol=1e-5, atol=1e-6)
LEAF_TOL = dict(atol=1e-5, rtol=1e-4)
NAMES = ("dr", "dk", "dv", "dw", "dbonus", "dstate0")


def _inputs(b, t, h, dh, seed):
    """r, k, v (N(0, 0.25)), the model's decay range exp(-exp(U(-3, 0)))
    widened so the state carries far, bonus, initial state, y's and the
    final state's gradients: fp32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    w = np.exp(-np.exp(rng.uniform(-3.0, 0.0, (b, t, h, dh))))
    return dict(r=n(b, t, h, dh, s=0.5), k=n(b, t, h, dh, s=0.5),
                v=n(b, t, h, dh, s=0.5), w=w.astype(np.float32),
                u=n(h, dh, s=0.3), s0=n(b, h, dh, dh, s=0.5),
                dy=n(b, t, h, dh), ds=n(b, h, dh, dh, s=0.5))


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


CASES = [  # b, t, h, dh, initial state, final state's gradient
    (1, 1, 1, 8, False, False),
    (2, 37, 3, 8, True, True),       # ragged T
    (1, 70, 2, 16, False, True),     # past one checkpoint, not a multiple
    (2, 130, 1, 32, True, False),
]


@pytest.mark.parametrize("b,t,h,dh,state,dstate", CASES)
def test_plain_backward_equals_autograd(b, t, h, dh, state, dstate):
    """Every gradient, the initial state's too (of zeros where none is
    given, which the forward reads as the same arithmetic)."""
    a = _torch(_inputs(b, t, h, dh, seed=t))
    s0 = a["s0"] if state else torch.zeros((b, h, dh, dh))
    leaves = [a[n].clone().requires_grad_(True) for n in "rkvwu"]
    leaves.append(s0.clone().requires_grad_(True))
    y, s = rwkv6_scan_plain(*leaves)
    outs, grads = ((y, s), (a["dy"], a["ds"])) if dstate else \
        ((y,), (a["dy"],))
    exp = torch.autograd.grad(outs, leaves, grads, allow_unused=True,
                              materialize_grads=True)
    got = rwkv6_scan_bwd_plain(a["r"], a["k"], a["v"], a["w"], a["u"],
                               a["s0"] if state else None, a["dy"],
                               a["ds"] if dstate else None)
    assert all(g.dtype == torch.float32 for g in got)
    for name, g, e in zip(NAMES, got, exp):
        assert g.shape == e.shape
        assert_allclose(g.numpy(), e.numpy(), **TOL, err_msg=name)


def _jax_scan_vjp(a, chunk, state, dstate):
    """``jax.vjp`` of repro's chunked scan of ``_wkv_step`` (each chunk
    under ``jax.checkpoint``, as ``rwkv_time_mix_apply`` runs it): the
    gradients of r, k, v, w, the bonus and the initial state."""
    b, t, h, dh = a["r"].shape
    nc = t // chunk

    def scan(r, k, v, w, u, s0):
        def chunk_body(hs, inp):
            def step(hs, x):
                return jrwkv._wkv_step(hs, *x, u)
            return jax.lax.scan(step, hs, inp)

        def tm_(x):
            return x.swapaxes(0, 1).reshape(nc, chunk, b, h, dh)

        hs, ys = jax.lax.scan(jax.checkpoint(chunk_body), s0,
                              (tm_(r), tm_(k), tm_(v), tm_(w)))
        return ys.reshape(t, b, h, dh).swapaxes(0, 1), hs

    s0 = a["s0"] if state else np.zeros((b, h, dh, dh), np.float32)
    _, vjp = jax.vjp(scan, *(jnp.asarray(a[n]) for n in "rkvwu"),
                     jnp.asarray(s0))
    ds = a["ds"] if dstate else np.zeros_like(s0)
    return [np.asarray(g) for g in vjp((jnp.asarray(a["dy"]),
                                        jnp.asarray(ds)))]


@pytest.mark.parametrize("b,t,h,dh,chunk,state,dstate", [
    (2, 48, 2, 16, 16, True, True),    # three checkpointed chunks
    (1, 37, 3, 8, 37, False, True),    # one ragged chunk
    (2, 64, 2, 32, 16, False, False),  # the smoke config's chunk and head
])
def test_plain_backward_equals_jax_grad_of_the_chunked_scan(
        b, t, h, dh, chunk, state, dstate):
    a = _inputs(b, t, h, dh, seed=100 + t)
    exp = _jax_scan_vjp(a, chunk, state, dstate)
    ta = _torch(a)
    got = rwkv6_scan_bwd_plain(ta["r"], ta["k"], ta["v"], ta["w"], ta["u"],
                               ta["s0"] if state else None, ta["dy"],
                               ta["ds"] if dstate else None)
    for name, g, e in zip(NAMES, got, exp):
        assert_allclose(g.numpy(), e, **TOL, err_msg=name)


def test_checkpoints_are_the_forward_states_and_route_to_the_plain_backward():
    """On the CPU, ``rwkv6_scan_checkpoints`` keeps the state before every
    ``every``-th step (the plain forward's own, bit for bit), and
    ``rwkv6_scan_bwd`` is the plain backward from the first of them."""
    a = _torch(_inputs(2, 100, 2, 16, seed=7))
    y, s, ck = wkv.rwkv6_scan_checkpoints(a["r"], a["k"], a["v"], a["w"],
                                          a["u"], a["s0"], every=32)
    ey, es = rwkv6_scan_plain(a["r"], a["k"], a["v"], a["w"], a["u"],
                              a["s0"])
    assert ck.shape == (2, 2, 4, 16, 16)
    assert torch.equal(s, es) and torch.equal(y, ey)
    assert torch.equal(ck[:, :, 0], a["s0"])
    for c in (1, 2, 3):
        cut = 32 * c
        _, sc = rwkv6_scan_plain(a["r"][:, :cut], a["k"][:, :cut],
                                 a["v"][:, :cut], a["w"][:, :cut], a["u"],
                                 a["s0"])
        assert torch.equal(ck[:, :, c], sc)
    got = wkv.rwkv6_scan_bwd(a["r"], a["k"], a["v"], a["w"], a["u"], ck,
                             a["dy"], a["ds"], every=32)
    exp = rwkv6_scan_bwd_plain(a["r"], a["k"], a["v"], a["w"], a["u"],
                               a["s0"], a["dy"], a["ds"])
    assert all(torch.equal(g, e) for g, e in zip(got, exp))


def test_rwkv6_forward_train_through_the_autograd_function(monkeypatch):
    """rwkv6's smoke ``forward_train`` at T = 80 (five 16-step chunks, two
    checkpoints of 64) with its WKV through ``_WKVScan`` - the
    checkpointing forward and the explicit reverse recurrence, as on the
    card - against ``jax.value_and_grad`` of ``repro``'s loss: the loss
    and every gradient leaf."""
    calls = []

    def through_function(r, k, v, w, bonus, initial_state=None, chunk=64):
        calls.append(r.shape)
        return wkv._WKVScan.apply(r, k, v, w, bonus, initial_state)

    bwd_calls = []
    real_bwd = wkv.rwkv6_scan_bwd

    def counted_bwd(*args, **kw):
        bwd_calls.append(1)
        return real_bwd(*args, **kw)

    monkeypatch.setattr(ops, "rwkv6_scan", through_function)
    monkeypatch.setattr(wkv, "rwkv6_scan_bwd", counted_bwd)
    jc, tc = j_smoke("rwkv6-1.6b"), t_smoke("rwkv6-1.6b")
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 80)).astype(np.int32)
    labels = np.roll(toks, -3, axis=1)
    jl, jg = jax.jit(jax.value_and_grad(jsteps.loss_fn), static_argnums=1)(
        jp, jc, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tl, tg = tsteps.value_and_grad(tp, tc, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    # each layer's WKV twice (the forward and the checkpoint's
    # recompute), its backward once
    assert len(calls) == 2 * tc.n_layers and len(bwd_calls) == tc.n_layers
    assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = jax.tree.map(np.asarray, jg)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k, sub in tree.items()
                    for p, v in flat(sub, f"{prefix}/{k}").items()}
        return {prefix: tree}

    got, want = flat(tg), flat(want)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert_allclose(g.numpy(), want[path], **LEAF_TOL, err_msg=path)


@pytest.mark.parametrize("b,h,dh", [(4, 32, 64), (3, 5, 32), (1, 1, 64)])
def test_backward_scratch_is_du_partials_only(b, h, dh):
    """The backward kernel's device scratch holds du's partial of each
    (batch, head) and nothing proportional to T: dv is summed across a
    head's row groups inside the cluster, not through device memory."""
    assert wkv.bwd_scratch_floats(b, h, dh) == b * h * dh
    assert "t" not in inspect.signature(wkv.bwd_scratch_floats).parameters
