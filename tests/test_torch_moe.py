"""The port's MoE feed-forward (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``) on smoke configs in fp32, the JAX
params carried across by ``params_from_numpy``: ``moe_apply``'s output
and aux loss for olmoe-1b-7b's and deepseek-v2-lite's MoE layers (two
shared experts), the cases of ``tests/test_moe_dispatch.py`` (slice-count
invariance, the non-divisible fallback, capacity drops through the
residual, gradients), olmoe's smoke prefill, decode and ``forward_train``
(loss with the aux loss, every gradient leaf), and the parameter counts.
Tolerance: atol and rtol 1e-5 on an FFN's output (the same fp32
products summed in other orders), the models' at the logits' and
gradients' tolerances of ``test_torch_models.py`` and
``test_torch_train.py``.  Routes are compared as they fall: a near-tie
in the top k that flips a token's experts between the two is a
failure, never a seed to step around."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.configs import n_params_analytic as j_count  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.configs import n_active_params, n_params_analytic  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

pytestmark = pytest.mark.torch

FFN_TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
LEAF_TOL = dict(atol=1e-5, rtol=1e-4)
OLMOE, DEEPSEEK = "olmoe-1b-7b", "deepseek-v2-lite-16b"


def _ffn(arch, seed=0, **moe):
    """A smoke MoE layer's FFN params in both packages, and both
    configs (``moe`` overrides the MoE config)."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    spec = next(s for s in jtf.layer_specs(jc) if s.moe)
    jp = jtf.layer_init(jax.random.PRNGKey(seed), jc, spec,
                        jnp.float32)["ffn"]
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _x(d, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32)


#: the reference's MoE FFN and model entry points, jitted (the config
#: static)
j_moe_apply = jax.jit(jmoe.moe_apply, static_argnums=1)
j_prefill = jax.jit(jm.prefill, static_argnums=1)
j_decode = jax.jit(jm.decode_step, static_argnums=1)


def _both(jc, tc, jp, tp, x):
    jy, jaux = j_moe_apply(jp, jc, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, tc, torch.from_numpy(x))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", [OLMOE, DEEPSEEK])
@pytest.mark.parametrize("shape", [(4, 16), (2, 37), (1, 1)])
def test_moe_apply_matches_reference(arch, shape):
    """y and the aux loss of olmoe's layer (8 experts, top 4) and of
    deepseek-v2-lite's (top 4 and two shared experts)."""
    jc, tc, jp, tp = _ffn(arch)
    assert sorted(tp) == sorted(jp)
    (jy, jaux), (ty, taux) = _both(jc, tc, jp, tp, _x(jc.d_model, shape, 3))
    assert ty.shape == jy.shape
    assert_allclose(ty, jy, **FFN_TOL)
    assert_allclose(taux, jaux, rtol=1e-6)


@given(n_slices=st.sampled_from([1, 2, 4, 8]), seed=st.integers(0, 50))
@settings(max_examples=12, deadline=None)
def test_slice_count_invariance_without_drops(n_slices, seed):
    """With ample capacity ``dispatch_slices`` is a re-layout: the port
    at n slices equals the reference at n slices and the port at one."""
    jc, tc, jp, tp = _ffn(OLMOE, seed % 3, dispatch_slices=n_slices)
    x = _x(jc.d_model, (4, 16), seed)
    (jy, jaux), (ty, taux) = _both(jc, tc, jp, tp, x)
    assert_allclose(ty, jy, **FFN_TOL)
    assert_allclose(taux, jaux, rtol=1e-6)
    one = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, dispatch_slices=1))
    y1, aux1 = tmoe.moe_apply(tp, one, torch.from_numpy(x))
    assert_allclose(ty, y1.numpy(), rtol=1e-6, atol=1e-6)
    assert_allclose(taux, float(aux1), rtol=1e-6)


def test_non_divisible_slices_fall_back():
    """15 tokens over 4 slices: one slice, as the reference."""
    jc, tc, jp, tp = _ffn(OLMOE, dispatch_slices=4)
    x = _x(jc.d_model, (3, 5), 0)
    (jy, _), (ty, _) = _both(jc, tc, jp, tp, x)
    assert_allclose(ty, jy, **FFN_TOL)
    one = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, dispatch_slices=1))
    assert_allclose(ty, tmoe.moe_apply(tp, one, torch.from_numpy(x))[0]
                    .numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("slices", [1, 4])
def test_capacity_drops_pass_through_residual(slices):
    """At capacity factor 0.05 most (token, expert) pairs overflow: the
    port drops the same ones as the reference (equal outputs), and the
    output's norm falls below the unconstrained one's."""
    jc, tc, jp, tp = _ffn(OLMOE, capacity_factor=0.05,
                          dispatch_slices=slices)
    x = _x(jc.d_model, (2, 32), 1)
    (jy, jaux), (ty, taux) = _both(jc, tc, jp, tp, x)
    assert np.isfinite(ty).all()
    assert_allclose(ty, jy, **FFN_TOL)
    assert_allclose(taux, jaux, rtol=1e-6)
    full = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=8.0))
    y_full = tmoe.moe_apply(tp, full, torch.from_numpy(x))[0]
    assert np.linalg.norm(ty) < float(torch.linalg.vector_norm(y_full))
    # a dropped token's routed output is exactly zero
    # (both slice counts give the capacity its floor, top_k = 4)
    xt = torch.from_numpy(x).reshape(-1, tc.d_model)
    routed, _, _ = tmoe._dispatch_rows(tp, tc.moe, xt, "silu", tc.moe.top_k,
                                       slices, (xt.shape[0], 0))
    assert (routed.abs().sum(-1) == 0).any()


def test_dispatch_one_slice_matches_reference():
    """``_dispatch_one_slice`` of one slice at a capacity that drops
    tokens: the routed output, the router probabilities and the one-hot
    selection (T, k, E) of the reference's function of that name."""
    jc, tc, jp, tp = _ffn(OLMOE)
    x = _x(jc.d_model, (24,), 5)
    jy, jprobs, jsel = jmoe._dispatch_one_slice(jp, jc.moe, jnp.asarray(x),
                                                "silu", 6)
    ty, tprobs, tsel = tmoe._dispatch_one_slice(tp, tc.moe,
                                                torch.from_numpy(x), "silu", 6)
    assert_allclose(ty.numpy(), np.asarray(jy), **FFN_TOL)
    assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6,
                    atol=1e-7)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))


@pytest.mark.parametrize("arch,slices", [(OLMOE, 4), (DEEPSEEK, 1)])
def test_gradients_match_reference(arch, slices):
    """Every parameter's and the input's gradient of sum(y^2) + aux
    against ``jax.grad``, through the sliced dispatch and the shared
    experts."""
    jc, tc, jp, tp = _ffn(arch, dispatch_slices=slices)
    x = _x(jc.d_model, (4, 8), 2)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, jc, xx)
        return jnp.sum(jnp.square(y)) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(leaves, tc, tx)
    (y.square().sum() + aux).backward()
    assert float(torch.linalg.vector_norm(leaves["expert_gate"].grad)) > 0
    for k, v in leaves.items():
        assert_allclose(v.grad.numpy(), np.asarray(jg[k]), **LEAF_TOL,
                        err_msg=k)
    assert_allclose(tx.grad.numpy(), np.asarray(jgx), **LEAF_TOL)


def _model_pair():
    jc, tc = j_smoke(OLMOE), t_smoke(OLMOE)
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("b,s", [(2, 37), (1, 64)])
def test_olmoe_prefill_and_decode_match_reference(b, s):
    """The smoke model's prefill logits and 8 greedy decode steps (a
    token at a time through the MoE layers), the greedy tokens equal."""
    jc, tc, jp, tp = _model_pair()
    toks = np.random.default_rng(s).integers(
        0, jc.vocab_size, (b, s)).astype(np.int32)
    steps = 8
    jcache = jm.init_cache(jc, b, s + steps)
    tcache = tm.init_cache(tc, b, s + steps, device="cpu")
    jl, jcache = j_prefill(jp, jc, jnp.asarray(toks), jcache)
    tl, tcache = tm.prefill(tp, tc, torch.from_numpy(toks).long(), tcache)
    assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    for _ in range(steps):
        jt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        tt = torch.argmax(tl[:, -1], dim=-1)
        np.testing.assert_array_equal(jt, tt.numpy())
        jl, jcache = j_decode(jp, jc, jnp.asarray(jt)[:, None], jcache)
        tl, tcache = tm.decode_step(tp, tc, tt[:, None], tcache)
        assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)


def test_olmoe_forward_train_matches_reference():
    """The loss (cross-entropy plus every layer's aux loss) and every
    gradient leaf, router and experts included, against
    ``jax.value_and_grad`` of ``repro.runtime.steps.loss_fn``."""
    jc, tc, jp, tp = _model_pair()
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (2, 29)).astype(np.int32)
    labels = np.roll(toks, -3, axis=1)
    jl, jg = jax.jit(jax.value_and_grad(jsteps.loss_fn), static_argnums=1)(
        jp, jc, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tl, tg = tsteps.value_and_grad(tp, tc, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert_allclose(float(tl), float(jl), rtol=1e-5)
    want, got = _flat(jax.tree.map(np.asarray, jg)), _flat(tg)
    assert sorted(got) == sorted(want)
    assert any(k.endswith("/router") for k in got)
    for path, g in got.items():
        assert_allclose(g.numpy(), want[path], **LEAF_TOL, err_msg=path)


def test_moe_aux_loss_enters_the_training_loss():
    """forward_train adds the layers' aux losses: with the aux weight at
    0 the loss falls by exactly their sum's share."""
    _, tc, _, tp = _model_pair()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab_size, (2, 16)).astype(np.int64))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        loss = float(ttf.forward_train(tp, tc, batch))
        quiet = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, router_aux_weight=0.0))
        plain = float(ttf.forward_train(tp, quiet, batch))
    assert loss > plain > 0


@pytest.mark.parametrize("arch", [OLMOE])
def test_param_counts_match_reference(arch):
    """The registered width's total and active parameter counts, built on
    the meta device, equal the reference's (olmoe-1b-7b: 6.9 B total)."""
    total = n_params_analytic(t_get(arch))
    assert total == j_count(j_get(arch))
    assert 6.8e9 < total < 7.0e9
    m = t_get(arch).moe
    assert n_active_params(t_get(arch)) == total - t_get(arch).n_layers * (
        m.n_experts - m.top_k) * 3 * t_get(arch).d_model * m.d_expert


def test_dense_layer_of_an_moe_model_takes_the_dense_width():
    """deepseek-v2-lite's first layer is dense at ``dense_d_ff`` (its
    smoke config 256), as in the reference."""
    jc, tc = j_smoke(DEEPSEEK), t_smoke(DEEPSEEK)
    spec = jtf.layer_specs(jc)[0]
    assert not spec.moe
    jshape = jax.eval_shape(lambda k: jtf.layer_init(k, jc, spec,
                                                     jnp.float32)["ffn"],
                            jax.random.PRNGKey(0))
    tspec = ttf.LayerSpec(mixer="attn", moe=False, cross=False)
    tp = ttf.layer_init(None, tc, tspec, torch.float32, "meta")["ffn"]
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jshape.items()}
    assert tp["w_gate"].shape[1] == tc.moe.dense_d_ff == 256
