"""The port's Mamba (``repro_torch.models.mamba``) and its kernels' plain
twins on the CPU, against the JAX package's Mamba
(``repro.models.mamba``) on jamba-1.5-large-398b's smoke config (8
layers, d_inner 256, d_state 8, chunk 16; fp32), the JAX parameters
carried across by ``params_from_numpy`` with ``conv_b`` drawn as
0.1 N(0, 1) and ``d_skip`` as 1 + 0.3 N(0, 1) (their init, 0 and 1,
would hide a kernel that drops the bias or the skip):

* ``mamba_apply`` with and without a state, both states compared, and
  decode steps chained after a prefill against one longer prefill, at
  rtol 1e-5 / atol 1e-6 (the sums run in other orders);
* the plain conv and scan (``kernels.ref``) against the reference's
  pieces, their plain backward passes against autograd of the plain
  forwards and against ``jax.vjp`` of the reference's pieces, and the
  layer's gradients through the kernels' autograd functions (their CPU
  route: the checkpointing forward and the plain backward) against
  ``jax.vjp`` of ``mamba_apply``, all at rtol 1e-5 / atol 1e-6;
* the whole smoke model: prefill and greedy decode logits at 1e-4 (as
  ``test_torch_models.py``), and ``forward_train``'s loss (rtol 1e-5)
  and every gradient leaf (atol 1e-5 / rtol 1e-4) against
  ``jax.value_and_grad`` of the reference's loss;
* the reference's refusal of a prompt that is no multiple of the chunk.

Inputs are numpy draws from fixed seeds."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import causal_conv1d as conv_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import selective_scan as scan_mod  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    causal_conv1d_bwd_plain, causal_conv1d_plain, selective_scan_bwd_plain,
    selective_scan_gated_plain, selective_scan_plain)
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

pytestmark = pytest.mark.torch

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LEAF_TOL = dict(atol=1e-5, rtol=1e-4)
#: gradients of the scan: sums over the states and over time that cancel,
#: so an element's rounding is a share of its terms' size, not of its own:
#: atol 1e-6 of the tensor's largest magnitude (at least 1e-6)
def _grad_close(got, exp, name):
    exp = np.asarray(exp)
    assert_allclose(got, exp, rtol=1e-5,
                    atol=1e-6 * max(1.0, float(np.abs(exp).max())),
                    err_msg=name)


#: the reference's layer, compiled once per shape
_jmamba_apply = jax.jit(jmamba.mamba_apply, static_argnums=1)

LEAVES = ("w_in", "conv_w", "conv_b", "w_x_dbc", "w_dt", "dt_bias", "a_log",
          "d_skip", "w_out")


def _awake(tree, rng):
    """The tree with every ``conv_b`` drawn as 0.1 N(0, 1) and every
    ``d_skip`` as 1 + 0.3 N(0, 1) (numpy leaves)."""
    if isinstance(tree, dict):
        return {k: (_awake(v, rng) if isinstance(v, dict) else
                    (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                    if k == "conv_b" else
                    (1 + 0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
                    if k == "d_skip" else v)
                for k, v in tree.items()}
    return tree


def _layer(seed=1):
    """One Mamba layer's params: the reference's draw (numpy) and the
    port's copy."""
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jax.tree.map(np.asarray, jmamba.mamba_init(
        jax.random.PRNGKey(seed), jc, jnp.float32))
    jp = _awake(jp, np.random.default_rng(seed))
    return jc, tc, jp, tm.params_from_numpy(jp, tc, "cpu")


def _normal(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _state(rng, b, d_inner, n):
    return _normal(rng, b, 3, d_inner), _normal(rng, b, d_inner, n, s=0.5)


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_matches_reference(t, with_state):
    jc, tc, jp, tp = _layer()
    _, d_inner, _ = tmamba._dims(tc)
    rng = np.random.default_rng(t)
    x = _normal(rng, 2, t, tc.d_model)
    st = _state(rng, 2, d_inner, tc.mamba.d_state) if with_state else None
    jy, jst = _jmamba_apply(
        jax.tree.map(jnp.asarray, jp), jc, jnp.asarray(x),
        None if st is None else jmamba.MambaState(*map(jnp.asarray, st)))
    ty, tst = tmamba.mamba_apply(
        tp, tc, torch.from_numpy(x),
        None if st is None else tmamba.MambaState(*map(torch.from_numpy,
                                                       st)))
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert tst.conv.dtype == torch.float32 and tst.ssm.dtype == torch.float32
    assert_allclose(tst.conv.numpy(), np.asarray(jst.conv), **TOL)
    assert_allclose(tst.ssm.numpy(), np.asarray(jst.ssm), **TOL)


def test_decode_steps_after_a_prefill_equal_one_longer_prefill():
    """A 16-token prefill then 16 one-token steps, each from the states
    the last left, against one 32-token prefill (and the reference's same
    chain): every output and both final states."""
    jc, tc, jp, tp = _layer(seed=2)
    x = _normal(np.random.default_rng(3), 2, 32, tc.d_model)
    xt = torch.from_numpy(x)
    whole, whole_st = tmamba.mamba_apply(tp, tc, xt)
    y, st = tmamba.mamba_apply(tp, tc, xt[:, :16])
    ys = [y]
    jpj = jax.tree.map(jnp.asarray, jp)
    jy, jst = _jmamba_apply(jpj, jc, jnp.asarray(x[:, :16]))
    jys = [jy]
    for i in range(16, 32):
        y, st = tmamba.mamba_apply(tp, tc, xt[:, i:i + 1], st)
        ys.append(y)
        jy, jst = _jmamba_apply(jpj, jc, jnp.asarray(x[:, i:i + 1]),
                                     jst)
        jys.append(jy)
    chained = torch.cat(ys, dim=1)
    assert_allclose(chained.numpy(), whole.numpy(), **TOL)
    assert_allclose(st.conv.numpy(), whole_st.conv.numpy(), **TOL)
    assert_allclose(st.ssm.numpy(), whole_st.ssm.numpy(), **TOL)
    assert_allclose(chained.numpy(), np.asarray(jnp.concatenate(jys, 1)),
                    **TOL)
    assert_allclose(st.ssm.numpy(), np.asarray(jst.ssm), **TOL)


def test_pieces_match_reference():
    """``_dims``, ``_selective_params``, the plain step ``_ssm_step`` and
    ``mamba_state_init`` against the reference's."""
    jc, tc, jp, tp = _layer(seed=3)
    assert tmamba._dims(tc)[1:] == jmamba._dims(jc)[1:] == (256, 8)
    rng = np.random.default_rng(8)
    xc = _normal(rng, 2, 5, 256)
    got = tmamba._selective_params(tp, tc, torch.from_numpy(xc))
    want = jmamba._selective_params(jax.tree.map(jnp.asarray, jp), jc,
                                    jnp.asarray(xc))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **TOL)
    a = -np.exp(jp["a_log"])
    h = _normal(rng, 2, 256, 8)
    dt, x = np.abs(_normal(rng, 2, 256)) * 0.1, _normal(rng, 2, 256)
    b, c = _normal(rng, 2, 8), _normal(rng, 2, 8)
    got = tmamba._ssm_step(*(torch.from_numpy(v) for v in (a, h, dt, b, c,
                                                            x)))
    want = jmamba._ssm_step(*(jnp.asarray(v) for v in (a, h, dt, b, c, x)))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **TOL)
    st = tmamba.mamba_state_init(tc, 3, torch.float32, "cpu")
    jst = jmamba.mamba_state_init(jc, 3)
    assert st.conv.shape == jst.conv.shape and st.ssm.shape == jst.ssm.shape
    assert st.ssm.dtype == torch.float32 and not st.ssm.any()


def test_prompt_not_a_multiple_of_the_chunk_raises():
    _, tc, _, tp = _layer()
    with pytest.raises(ValueError, match="multiple of 16"):
        tmamba.mamba_apply(tp, tc, torch.zeros((1, 24, tc.d_model)))
    # up to one chunk any length runs, as in the reference
    y, _ = tmamba.mamba_apply(tp, tc, torch.zeros((1, 11, tc.d_model)))
    assert y.shape == (1, 11, tc.d_model)


# ------------------------------------------------------- the plain twins

def _conv_inputs(b, t, d, seed, state):
    rng = np.random.default_rng(seed)
    return dict(x=_normal(rng, b, t, d), w=_normal(rng, 4, d, s=0.3),
                bias=_normal(rng, d, s=0.1),
                state=_normal(rng, b, 3, d) if state else None,
                dout=_normal(rng, b, t, d), dnew=_normal(rng, b, 3, d))


def _jconv(x, w, bias, state, cfg):
    return jmamba._conv1d_causal({"conv_w": w, "conv_b": bias}, cfg, x,
                                 state)


CONV_CASES = [(2, 16, 256, False), (2, 37, 256, True), (3, 1, 256, True),
              (1, 2, 256, True)]


@pytest.mark.parametrize("b,t,d,state", CONV_CASES)
def test_conv_plain_matches_reference(b, t, d, state):
    """The output and the new state (T = 1 and 2: the state's rows kept
    in it)."""
    a = _conv_inputs(b, t, d, t, state)
    jc = j_smoke(ARCH)
    jy, js = _jconv(jnp.asarray(a["x"]), jnp.asarray(a["w"]),
                    jnp.asarray(a["bias"]),
                    None if a["state"] is None else jnp.asarray(a["state"]),
                    jc)
    ty, ts = causal_conv1d_plain(
        torch.from_numpy(a["x"]), torch.from_numpy(a["w"]),
        torch.from_numpy(a["bias"]),
        None if a["state"] is None else torch.from_numpy(a["state"]))
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("b,t,d,state", CONV_CASES)
def test_conv_plain_backward_matches_autograd_and_jax(b, t, d, state):
    """dx, dweight, dbias and the state's gradient (of the zeros read
    without one), with the new state's gradient, against autograd of the
    plain forward and ``jax.vjp`` of the reference's conv."""
    a = _conv_inputs(b, t, d, 50 + t, state)
    s0 = a["state"] if state else np.zeros((b, 3, d), np.float32)
    ta = {k: torch.from_numpy(v) for k, v in a.items() if v is not None}
    got = causal_conv1d_bwd_plain(ta["x"], ta["w"], ta["bias"],
                                  ta.get("state"), ta["dout"], ta["dnew"])
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (a["x"], a["w"], a["bias"], s0)]
    out = causal_conv1d_plain(*leaves)
    exp = torch.autograd.grad(out, leaves, (ta["dout"], ta["dnew"]))
    jc = j_smoke(ARCH)
    _, vjp = jax.vjp(lambda *v: _jconv(*v, jc),
                     *(jnp.asarray(v) for v in (a["x"], a["w"], a["bias"],
                                                s0)))
    want = vjp((jnp.asarray(a["dout"]), jnp.asarray(a["dnew"])))
    for name, g, e, j in zip(("dx", "dw", "db", "dstate"), got, exp, want):
        assert g.shape == e.shape, name
        assert_allclose(g.numpy(), e.numpy(), **TOL, err_msg=name)
        assert_allclose(g.numpy(), np.asarray(j), **TOL, err_msg=name)


def _scan_inputs(b, t, d, n, seed):
    """dt as the model makes it (softplus of a value around its bias's
    init, about 0.05: U(1e-3, 1e-1) after the softplus), a = -(1..n)
    scaled by exp(0.3 N(0, 1)), b/c/x N(0, 1), d_skip around 1, an
    initial state, y's and the final state's gradients: fp32 numpy
    arrays."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(_normal(rng, b, t, d) - 3.0)).astype(np.float32)
    a = -np.exp(_normal(rng, d, n, s=0.3)
                + np.log(np.arange(1, n + 1, dtype=np.float32)))
    return dict(dt=dt, a=a.astype(np.float32), b=_normal(rng, b, t, n),
                c=_normal(rng, b, t, n), x=_normal(rng, b, t, d),
                d_skip=1 + _normal(rng, d, s=0.3),
                s0=_normal(rng, b, d, n, s=0.5), dy=_normal(rng, b, t, d),
                ds=_normal(rng, b, d, n, s=0.5))


def _jscan(dt, a, b, c, x, d_skip, h0, chunk):
    """The reference's scan (``mamba_apply``'s chunked ``lax.scan`` of
    ``_ssm_step``, each chunk under ``jax.checkpoint``) and its skip."""
    bsz, t, d = dt.shape
    if t == 1:
        h, y = jmamba._ssm_step(a, h0, dt[:, 0], b[:, 0], c[:, 0], x[:, 0])
        return y[:, None] + x * d_skip, h
    nc = t // chunk

    def chunk_body(h, inp):
        return jax.lax.scan(lambda h, s: jmamba._ssm_step(a, h, *s), h, inp)

    def tm_(v):
        return v.swapaxes(0, 1).reshape(nc, chunk, bsz, -1)

    h, ys = jax.lax.scan(jax.checkpoint(chunk_body), h0,
                         (tm_(dt), tm_(b), tm_(c), tm_(x)))
    return ys.reshape(t, bsz, d).swapaxes(0, 1) + x * d_skip, h


SCAN_CASES = [(2, 48, 256, 8, 16), (1, 37, 128, 16, 37), (3, 1, 128, 8, 1)]
NAMES = ("ddt", "da", "db", "dc", "dx", "dd_skip", "dstate0")


@pytest.mark.parametrize("b,t,d,n,chunk", SCAN_CASES)
def test_scan_plain_matches_reference(b, t, d, n, chunk):
    a = _scan_inputs(b, t, d, n, seed=t)
    order = ("dt", "a", "b", "c", "x", "d_skip", "s0")
    jy, jh = _jscan(*(jnp.asarray(a[k]) for k in order), chunk)
    ty, th = selective_scan_plain(*(torch.from_numpy(a[k]) for k in order))
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("b,t,d,n,chunk", SCAN_CASES)
def test_scan_plain_backward_matches_autograd_and_jax(b, t, d, n, chunk):
    a = _scan_inputs(b, t, d, n, seed=100 + t)
    order = ("dt", "a", "b", "c", "x", "d_skip", "s0")
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    got = selective_scan_bwd_plain(*(ta[k] for k in order), ta["dy"],
                                   ta["ds"])
    leaves = [ta[k].clone().requires_grad_(True) for k in order]
    exp = torch.autograd.grad(selective_scan_plain(*leaves),
                              leaves, (ta["dy"], ta["ds"]))
    _, vjp = jax.vjp(lambda *v: _jscan(*v, chunk),
                     *(jnp.asarray(a[k]) for k in order))
    want = vjp((jnp.asarray(a["dy"]), jnp.asarray(a["ds"])))
    # autograd and vjp order: dt, a, b, c, x, d_skip, state
    for name, g, e, j in zip(NAMES, got,
                             [exp[i] for i in (0, 1, 2, 3, 4, 5, 6)],
                             [want[i] for i in (0, 1, 2, 3, 4, 5, 6)]):
        assert g.shape == e.shape, name
        _grad_close(g.numpy(), e.numpy(), name)
        _grad_close(g.numpy(), j, name)


def test_scan_checkpoints_are_the_forward_states():
    """On the CPU ``selective_scan_checkpoints`` keeps the state before
    every ``CKPT``-th step (the plain forward's own, bit for bit), and
    ``selective_scan_bwd`` is the plain backward from the first."""
    a = {k: torch.from_numpy(v)
         for k, v in _scan_inputs(2, 21, 128, 8, seed=9).items()}
    order = ("dt", "a", "b", "c", "x", "d_skip", "s0")
    y, s, ck = scan_mod.selective_scan_checkpoints(*(a[k] for k in order))
    ey, es = selective_scan_plain(*(a[k] for k in order))
    every = scan_mod.CKPT
    assert ck.shape == (2, -(-21 // every), 128, 8)
    assert torch.equal(s, es) and torch.equal(y, ey)
    for i in range(ck.shape[1]):
        cut = {k: (v[:, :i * every] if k in ("dt", "b", "c", "x") else v)
               for k, v in a.items()}
        if i:
            _, sc = selective_scan_plain(*(cut[k] for k in order))
        else:
            sc = a["s0"]
        assert torch.equal(ck[:, i], sc), i
    got = scan_mod.selective_scan_bwd(*(a[k] for k in order[:6]), ck,
                                      a["dy"], a["ds"])
    exp = selective_scan_bwd_plain(*(a[k] for k in order), a["dy"], a["ds"])
    assert all(torch.equal(g, e) for g, e in zip(got, exp))


@pytest.mark.parametrize("b,t,d,n", [(4, 2048, 16384, 16), (2, 333, 384, 8)])
def test_backward_scratch_sizes(b, t, d, n):
    """The stated scratch of the two backward kernels: the scan's block
    partials of db and dc and batch partials of da and dd_skip; the
    conv's tile partials of its four weight rows and bias."""
    assert scan_mod.bwd_scratch_floats(b, t, d, n) == (
        d // 128 * b * t * 2 * n + b * d * (n + 1))
    assert conv_mod.bwd_scratch_floats(b, t, d) == b * -(-t // 128) * 5 * d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_gated_plain_is_the_chain_it_replaces(dtype, with_state):
    """``selective_scan_gated_plain`` on the layer's own projections equals
    the chain ``mamba_apply`` ran before it took the gated entry
    (``_selective_params``, the fp32 scan, the cast and the SiLU gate) bit
    for bit, and ``mamba_apply`` without a gradient equals the layer
    built from that chain."""
    _, tc, _, tp = _layer(seed=7)
    tp = {k: v.to(dtype) if k not in ("dt_bias", "a_log", "d_skip") else v
          for k, v in tp.items()}
    _, d_inner, _ = tmamba._dims(tc)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_normal(rng, 2, 16, tc.d_model)).to(dtype)
    st = (tmamba.MambaState(*(torch.from_numpy(v) for v in _state(
        rng, 2, d_inner, tc.mamba.d_state))) if with_state else None)
    if st is not None:
        st = tmamba.MambaState(st.conv.to(dtype), st.ssm)
    a = -torch.exp(tp["a_log"])
    xz = x @ tp["w_in"]
    xc, new_conv = tmamba._conv1d_causal(tp, tc, xz[..., :d_inner],
                                         None if st is None else st.conv)
    z = xz[..., d_inner:]
    ssm = () if st is None else (st.ssm,)
    dt, b_t, c_t = tmamba._selective_params(tp, tc, xc)
    y, h = selective_scan_plain(dt, a, b_t, c_t, xc.to(torch.float32),
                                tp["d_skip"], *ssm)
    chain = y.to(dtype) * torch.nn.functional.silu(z)
    dt_raw, b2, c2 = tmamba._projections(tp, tc, xc)
    got, gh = selective_scan_gated_plain(dt_raw, tp["dt_bias"], a, b2, c2,
                                         xc, z, tp["d_skip"], *ssm)
    assert got.dtype == dtype
    assert torch.equal(got, chain) and torch.equal(gh, h)
    out, new = tmamba.mamba_apply(tp, tc, x, st)
    assert torch.equal(out, chain @ tp["w_out"])
    assert torch.equal(new.ssm, h) and torch.equal(new.conv, new_conv)


def _count_scan_routes(monkeypatch):
    """Count ``mamba_apply``'s calls of the fp32 scan and the gated one,
    each running as before."""
    calls = {"scan": 0, "gated": 0}

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "selective_scan",
                        counted("scan", ops.selective_scan))
    monkeypatch.setattr(ops, "selective_scan_gated",
                        counted("gated", ops.selective_scan_gated))
    return calls


@pytest.mark.parametrize("needs", ["nothing", "a leaf, under no_grad",
                                   "a leaf", "x", "the scan state"])
def test_mamba_apply_takes_the_gated_scan_unless_a_gradient_is_needed(
        monkeypatch, needs):
    """The gated entry whenever no input needs a gradient (serving, a
    leaf that requires one under ``torch.no_grad``); the fp32 scan under
    autograd, whichever input requires it."""
    calls = _count_scan_routes(monkeypatch)
    _, tc, _, tp = _layer(seed=2)
    _, d_inner, _ = tmamba._dims(tc)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_normal(rng, 2, 16, tc.d_model))
    st = tmamba.MambaState(*(torch.from_numpy(v) for v in _state(
        rng, 2, d_inner, tc.mamba.d_state)))
    if needs in ("a leaf", "a leaf, under no_grad"):
        tp = dict(tp, dt_bias=tp["dt_bias"].clone().requires_grad_(True))
    if needs == "x":
        x.requires_grad_(True)
    if needs == "the scan state":
        st = tmamba.MambaState(st.conv, st.ssm.clone().requires_grad_(True))
    if needs == "a leaf, under no_grad":
        with torch.no_grad():
            y, _ = tmamba.mamba_apply(tp, tc, x, st)
    else:
        y, _ = tmamba.mamba_apply(tp, tc, x, st)
    gated = needs in ("nothing", "a leaf, under no_grad")
    assert calls == {"scan": int(not gated), "gated": int(gated)}
    assert y.requires_grad == (not gated)


@pytest.mark.parametrize("b,d,sms,lanes", [
    (4, 16384, 132, 1),   # jamba's batched prefill and decode: 3.9 warps
    (2, 16384, 132, 2),
    (1, 16384, 132, 4),   # one agent's prefill: four lanes a channel
    (2, 256, 132, 4),     # the smoke config: as many as there are
    (1, 512, 1, 1)])
def test_lane_plan(b, d, sms, lanes):
    assert scan_mod.plan(b, d, sms) == lanes


def test_gated_scan_checks_refuse_what_the_kernel_does_not_take():
    """The gated mode's input checks, which a CUDA tensor meets before
    its launch: dt_raw of another type than x, z off 16 bytes, d_state
    12 and a dt_bias of another width raise."""
    rng = np.random.default_rng(4)
    b, t, d, n = 1, 5, 128, 8

    def f(*shape):
        return torch.from_numpy(_normal(rng, *shape))

    bf = torch.bfloat16
    xz = f(b, t, 2 * d + 8).to(bf)
    args = dict(dt_raw=f(b, t, d).to(bf), dt_bias=f(d), a=-f(d, n).abs(),
                b=f(b, t, n), c=f(b, t, n), x=f(b, t, d).to(bf),
                z=xz[..., d:2 * d], d_skip=f(d), initial_state=None)
    assert scan_mod._check_gated(**args) == 1
    for change, error in ((dict(dt_raw=args["dt_raw"].float()), TypeError),
                          (dict(z=xz[..., d + 1:2 * d + 1]), ValueError),
                          (dict(a=-f(d, 12).abs()), ValueError),
                          (dict(dt_bias=f(d + 8)), ValueError)):
        with pytest.raises(error):
            scan_mod._check_gated(**dict(args, **change))


def _through_functions(monkeypatch):
    """Route the model's conv and scan through the kernels' autograd
    functions (on the CPU: the plain forward, the checkpointing forward
    and the plain backward passes), counting their backward calls."""
    calls = {"conv": 0, "scan": 0, "conv_bwd": 0, "scan_bwd": 0}

    def conv(x, weight, bias, state=None):
        calls["conv"] += 1
        return conv_mod._CausalConv.apply(x, weight, bias, state)

    def scan(dt, a, b, c, x, d_skip, initial_state=None):
        calls["scan"] += 1
        return scan_mod._SelectiveScan.apply(dt, a, b, c, x, d_skip,
                                             initial_state)

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "causal_conv1d", conv)
    monkeypatch.setattr(ops, "selective_scan", scan)
    monkeypatch.setattr(conv_mod, "causal_conv1d_bwd",
                        counted("conv_bwd", conv_mod.causal_conv1d_bwd))
    monkeypatch.setattr(scan_mod, "selective_scan_bwd",
                        counted("scan_bwd", scan_mod.selective_scan_bwd))
    return calls


@pytest.mark.parametrize("with_state", [False, True])
def test_layer_gradients_through_the_kernels_functions(monkeypatch,
                                                       with_state):
    """Every leaf's, x's and the states' gradients of ``mamba_apply``
    (T = 32, two chunks), the kernels' autograd functions on their CPU
    route, against ``jax.vjp`` of the reference's."""
    calls = _through_functions(monkeypatch)
    jc, tc, jp, tp = _layer(seed=4)
    _, d_inner, _ = tmamba._dims(tc)
    rng = np.random.default_rng(5)
    x = _normal(rng, 2, 32, tc.d_model)
    st = _state(rng, 2, d_inner, tc.mamba.d_state) if with_state else None
    dy = _normal(rng, 2, 32, tc.d_model)
    dconv, dssm = _state(rng, 2, d_inner, tc.mamba.d_state)

    def jfn(p, x, *state):
        y, s = jmamba.mamba_apply(p, jc, x, jmamba.MambaState(*state)
                                  if state else None)
        return y, s.conv, s.ssm

    jargs = [jax.tree.map(jnp.asarray, jp), jnp.asarray(x)] + (
        [jnp.asarray(v) for v in st] if st else [])
    want = jax.jit(lambda args, ct: jax.vjp(jfn, *args)[1](ct))(
        jargs, (jnp.asarray(dy), jnp.asarray(dconv), jnp.asarray(dssm)))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tst = ([torch.from_numpy(v).requires_grad_(True) for v in st]
           if st else [])
    y, s = tmamba.mamba_apply(leaves, tc, tx,
                              tmamba.MambaState(*tst) if tst else None)
    inputs = [leaves[k] for k in LEAVES] + [tx] + tst
    got = torch.autograd.grad(
        (y, s.conv, s.ssm), inputs,
        (torch.from_numpy(dy), torch.from_numpy(dconv),
         torch.from_numpy(dssm)))
    assert calls == {"conv": 1, "scan": 1, "conv_bwd": 1, "scan_bwd": 1}
    expect = [want[0][k] for k in LEAVES] + list(want[1:])
    for name, g, e in zip(list(LEAVES) + ["x", "conv", "ssm"], got, expect):
        _grad_close(g.numpy(), e, name)


# ---------------------------------------------------------- whole model

def _model_pair():
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jax.tree.map(np.asarray, jm.init_params(jc, jax.random.PRNGKey(1)))
    jp = _awake(jp, np.random.default_rng(6))
    return jc, tc, jp, tm.params_from_numpy(jp, tc, "cpu")


def test_model_prefill_and_decode_match_reference():
    """Prefill (two chunks), then 6 greedy steps: the logits, the greedy
    tokens and every layer's scan state."""
    jc, tc, jp, tp = _model_pair()
    b, s, steps = 2, 32, 6
    toks = np.random.default_rng(s).integers(
        0, jc.vocab_size, (b, s)).astype(np.int32)
    jpj = jax.tree.map(jnp.asarray, jp)
    jcache = jm.init_cache(jc, b, s + steps)
    tcache = tm.init_cache(tc, b, s + steps, device="cpu")
    prefill = jax.jit(jm.prefill, static_argnums=1)
    decode = jax.jit(jm.decode_step, static_argnums=1)
    jl, jcache = prefill(jpj, jc, jnp.asarray(toks), jcache)
    tl, tcache = tm.prefill(tp, tc, torch.from_numpy(toks).long(), tcache)
    assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for _ in range(steps):
        jt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        tt = torch.argmax(tl[:, -1], dim=-1)
        np.testing.assert_array_equal(jt, tt.numpy())
        jl, jcache = decode(jpj, jc, jnp.asarray(jt)[:, None], jcache)
        tl, tcache = tm.decode_step(tp, tc, tt[:, None], tcache)
        assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for i in range(7):      # the unstacked prefix: layers 0-6
        c, jcc = tcache[f"prefix_{i}"], jcache[f"prefix_{i}"]
        if "ssm" in c:
            assert c["conv"].shape == (b, 3, 256)
            assert_allclose(c["ssm"].numpy(), np.asarray(jcc["ssm"]),
                            atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _reference_step():
    """The tokens, labels, loss and flat gradient leaves of one
    ``jax.value_and_grad`` of the reference's loss at T = 48 (three
    chunks), computed once for both routes."""
    jc, _, jp, _ = _model_pair()
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 48)).astype(np.int32)
    labels = np.roll(toks, -3, axis=1)
    jl, jg = jax.jit(jax.value_and_grad(jsteps.loss_fn), static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jc,
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k, sub in tree.items()
                    for p, v in flat(sub, f"{prefix}/{k}").items()}
        return {prefix: np.asarray(tree)}

    return toks, labels, float(jl), flat(jg)


@pytest.mark.parametrize("route", ["plain autograd", "kernel functions"])
def test_model_forward_train_matches_reference(monkeypatch, route):
    """``forward_train``'s loss and every gradient leaf at T = 48 (three
    chunks), with the conv and scan differentiated by autograd of their
    plain versions (the CPU default) or through the kernels' autograd
    functions (each layer's forward twice: the superblock's recompute)."""
    calls = (_through_functions(monkeypatch)
             if route == "kernel functions" else None)
    jc, tc, jp, tp = _model_pair()
    toks, labels, jl, want = _reference_step()
    tl, tg = tsteps.value_and_grad(tp, tc, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    if calls is not None:
        n_mamba = [s.mixer for s in ttf.layer_specs(tc)].count("mamba")
        assert calls["scan_bwd"] == calls["conv_bwd"] == n_mamba
    assert_allclose(float(tl), float(jl), rtol=1e-5)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k, sub in tree.items()
                    for p, v in flat(sub, f"{prefix}/{k}").items()}
        return {prefix: tree}

    got = flat(tg)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert_allclose(g.numpy(), want[path], **LEAF_TOL, err_msg=path)
