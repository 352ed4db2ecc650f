"""The port's multi-head latent attention (``repro_torch.models.attention``
``mla_init`` / ``mla_apply``) and deepseek-v2-lite-16b against the JAX
package's on the smoke config (fp32: kv rank 32, nope 32, rope 16, v 32;
8 experts top 4 with 2 shared, the first layer dense), the JAX params
carried across by ``params_from_numpy``.

Every norm scale is drawn as 1 + 0.3 N(0, 1) from a numpy seed (at unit
scales the latent's ``kv_norm`` would hide a wrong cast order).
Tolerances: ``mla_apply`` and its caches rtol 1e-5 / atol 1e-6; the
model's logits 1e-5 with the greedy tokens equal; the loss rtol 1e-5 and
every gradient leaf atol 1e-5 / rtol 1e-4 (the same fp32 function summed
in other orders).  On the CPU the kernel wrappers run their plain
versions, so no launch is counted."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.configs import n_params_analytic as j_count  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.configs import n_active_params, n_params_analytic  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import (decode_attention as tda,  # noqa: E402
                                 flash_attention as tfa, ops, rmsnorm as trms)
from repro_torch.kernels.ref import (attention_bwd_plain,  # noqa: E402
                                     attention_plain, decode_attention_plain)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

pytestmark = pytest.mark.torch

DEEPSEEK = "deepseek-v2-lite-16b"
MLA_TOL = dict(rtol=1e-5, atol=1e-6)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
LEAF_TOL = dict(atol=1e-5, rtol=1e-4)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _scales(tree, rng, path=""):
    """The numpy tree with every norm scale drawn as 1 + 0.3 N(0, 1)."""
    if isinstance(tree, dict):
        return {k: _scales(v, rng, f"{path}/{k}") for k, v in tree.items()}
    if path.endswith("scale"):
        return (1 + 0.3 * rng.standard_normal(tree.shape)).astype(tree.dtype)
    return tree


_PAIR = {}


def _pair():
    """(JAX config, port config, JAX params, port params), built once."""
    if not _PAIR:
        jc, tc = j_smoke(DEEPSEEK), t_smoke(DEEPSEEK)
        tree = _scales(jax.tree.map(np.asarray, jm.init_params(
            jc, jax.random.PRNGKey(1))), np.random.default_rng(5))
        _PAIR["v"] = (jc, tc, jax.tree.map(jnp.asarray, tree),
                      tm.params_from_numpy(tree, tc, "cpu"))
    return _PAIR["v"]


def _mixer():
    """The dense first layer's MLA params in both packages."""
    jc, tc, jp, tp = _pair()
    return jc, tc, jp["prefix_0"]["mixer"], tp["prefix_0"]["mixer"]


def _x(jc, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, jc.d_model)).astype(np.float32)


def test_converted_tree_has_the_reference_leaves():
    jc, tc, jp, tp = _pair()
    want = {k: tuple(v.shape) for k, v in _flat(jp).items()}
    got = {k: tuple(v.shape) for k, v in _flat(tp).items()}
    assert got == want
    own = {k: tuple(v.shape) for k, v in _flat(
        tm.init_params(tc, seed=0, device="meta")).items()}
    assert own == want
    mixer = sorted(_flat(tp["prefix_0"]["mixer"]))
    assert mixer == ["/kv_norm/scale", "/w_dkv", "/w_dq", "/w_uk", "/w_uv",
                     "/wo"]


def test_mla_forward_matches_reference():
    """The cache-free causal forward and the latent stream it returns."""
    jc, tc, jl, tl = _mixer()
    x = _x(jc, 2, 19, 3)
    pos = np.arange(19)[None, :]
    jy, (jckv, jkpe) = jattn.mla_apply(jl, jc, jnp.asarray(x),
                                       jnp.asarray(pos))
    ty, (tckv, tkpe) = tattn.mla_apply(tl, tc, torch.from_numpy(x),
                                       torch.from_numpy(pos))
    assert_allclose(ty.numpy(), np.asarray(jy), **MLA_TOL)
    assert_allclose(tckv.numpy(), np.asarray(jckv), **MLA_TOL)
    assert_allclose(tkpe.numpy(), np.asarray(jkpe), **MLA_TOL)


def test_mla_prefill_and_ragged_decode_match_reference():
    """A prefill of 7 into an empty cache, then three decode steps at
    ragged positions (rows at 7, 4 and 6 cached tokens, each step one
    further), the caches' contents held after every call."""
    jc, tc, jl, tl = _mixer()
    m = jc.mla
    b, s, lmax = 3, 7, 12
    jcache = (jnp.zeros((b, lmax, m.kv_lora_rank)),
              jnp.zeros((b, lmax, m.qk_rope_head_dim)))
    tcache = (torch.zeros((b, lmax, m.kv_lora_rank)),
              torch.zeros((b, lmax, m.qk_rope_head_dim)))
    x = _x(jc, b, s, 4)
    pos = np.arange(s)[None, :]
    jy, jcache = jattn.mla_apply(jl, jc, jnp.asarray(x), jnp.asarray(pos),
                                 cache_ckv=jcache,
                                 cache_len=jnp.zeros((b,), jnp.int32))
    ty, tcache = tattn.mla_apply(tl, tc, torch.from_numpy(x),
                                 torch.from_numpy(pos), cache_ckv=tcache,
                                 cache_len=0)
    assert_allclose(ty.numpy(), np.asarray(jy), **MLA_TOL)
    lens = np.array([7, 4, 6], np.int32)
    for step in range(3):
        xs = _x(jc, b, 1, 10 + step)
        jy, jcache = jattn.mla_apply(jl, jc, jnp.asarray(xs),
                                     jnp.asarray(lens[:, None]),
                                     cache_ckv=jcache,
                                     cache_len=jnp.asarray(lens))
        ckv = tcache[0]
        ty, tcache = tattn.mla_apply(tl, tc, torch.from_numpy(xs),
                                     torch.from_numpy(lens[:, None]),
                                     cache_ckv=tcache,
                                     cache_len=torch.from_numpy(lens))
        assert tcache[0] is ckv           # written in place
        assert_allclose(ty.numpy(), np.asarray(jy), **MLA_TOL)
        for got, want in zip(tcache, jcache):
            assert_allclose(got.numpy(), np.asarray(want), **MLA_TOL)
        lens = lens + 1


def test_mla_cached_prefill_at_an_offset_raises():
    """The call that once raised (a 3-token prompt at offset 2 of an
    8-long cache) now runs, as the reference's does: the output and both
    latent caches against ``repro``'s ``mla_apply`` at the same inputs."""
    jc, tc, jl, tl = _mixer()
    m = tc.mla
    rng = np.random.default_rng(8)
    ckv = rng.standard_normal((1, 8, m.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((1, 8, m.qk_rope_head_dim)).astype(np.float32)
    x = _x(jc, 1, 3, 9)
    pos = 2 + np.arange(3)[None]
    jy, jcache = jattn.mla_apply(jl, jc, jnp.asarray(x), jnp.asarray(pos),
                                 cache_ckv=(jnp.asarray(ckv),
                                            jnp.asarray(kpe)),
                                 cache_len=jnp.asarray([2], jnp.int32))
    cache = (torch.from_numpy(ckv.copy()), torch.from_numpy(kpe.copy()))
    ty, got = tattn.mla_apply(tl, tc, torch.from_numpy(x),
                              torch.from_numpy(pos), cache_ckv=cache,
                              cache_len=torch.tensor([2], dtype=torch.int32))
    assert_allclose(ty.numpy(), np.asarray(jy), **MLA_TOL)
    for g, w in zip(got, jcache):
        assert_allclose(g.numpy(), np.asarray(w), **MLA_TOL)


def test_mla_cache_keeps_the_reference_layout():
    _, tc, _, _ = _pair()
    cache = tm.init_cache(tc, 2, 10, device="cpu")
    m = tc.mla
    assert set(cache["prefix_0"]) == {"ckv", "kpe"}
    assert tuple(cache["prefix_0"]["ckv"].shape) == (2, 10, m.kv_lora_rank)
    assert tuple(cache["blocks"]["sub0"]["kpe"].shape) == (
        tc.n_layers - 1, 2, 10, m.qk_rope_head_dim)


_jit_prefill = jax.jit(jm.prefill, static_argnums=1)
_jit_decode = jax.jit(jm.decode_step, static_argnums=1)


@pytest.mark.parametrize("b,s", [(2, 37), (1, 64)])
def test_prefill_and_greedy_decode_match_reference(b, s):
    """The smoke model's prefill and 8 greedy decode steps: every step's
    logits and the greedy tokens."""
    jc, tc, jp, tp = _pair()
    toks = np.random.default_rng(s).integers(
        0, jc.vocab_size, (b, s)).astype(np.int32)
    steps = 8
    jcache = jm.init_cache(jc, b, s + steps)
    tcache = tm.init_cache(tc, b, s + steps, device="cpu")
    jl, jcache = _jit_prefill(jp, jc, jnp.asarray(toks), jcache)
    tl, tcache = tm.prefill(tp, tc, torch.from_numpy(toks).long(), tcache)
    assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    for _ in range(steps):
        jt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        tt = torch.argmax(tl[:, -1], dim=-1)
        np.testing.assert_array_equal(jt, tt.numpy())
        jl, jcache = _jit_decode(jp, jc, jnp.asarray(jt)[:, None], jcache)
        tl, tcache = tm.decode_step(tp, tc, tt[:, None], tcache)
        assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    assert tcache["length"].tolist() == [s + steps] * b
    for got, want in ((tcache["prefix_0"]["ckv"], jcache["prefix_0"]["ckv"]),
                      (tcache["blocks"]["sub0"]["kpe"],
                       jcache["blocks"]["sub0"]["kpe"])):
        assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_forward_train_loss_and_gradients_match_reference():
    """The loss (with the MoE layers' aux losses) and every gradient leaf
    against ``jax.value_and_grad`` of ``repro.runtime.steps.loss_fn``;
    every MLA leaf's gradient is non-zero."""
    jc, tc, jp, tp = _pair()
    rng = np.random.default_rng(21)
    toks = rng.integers(0, jc.vocab_size, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -3, axis=1)
    jl, jg = jax.jit(jax.value_and_grad(jsteps.loss_fn), static_argnums=1)(
        jp, jc, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tl, tg = tsteps.value_and_grad(tp, tc, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert_allclose(float(tl), float(jl), rtol=1e-5)
    want, got = _flat(jax.tree.map(np.asarray, jg)), _flat(tg)
    assert set(got) == set(want)
    mla = [k for k in got if "/mixer/" in k]
    assert len(mla) == 12        # the dense layer's six and the stacked six
    for k in want:
        assert_allclose(got[k].numpy(), want[k], err_msg=k, **LEAF_TOL)
    for k in mla:
        assert np.any(got[k].numpy() != 0), k


def test_launch_counts_stay_zero_on_the_cpu():
    _, tc, _, tp = _pair()

    def counts():
        return (trms.rmsnorm.launches, tfa.flash_attention.launches,
                tfa.flash_attention_bwd.launches,
                tda.decode_attention.launches)

    before = counts()
    cache = tm.init_cache(tc, 1, 10, device="cpu")
    toks = torch.ones((1, 8), dtype=torch.long)
    logits, cache = tm.prefill(tp, tc, toks, cache)
    tm.decode_step(tp, tc, torch.argmax(logits[:, -1], -1)[:, None], cache)
    tsteps.value_and_grad(tp, tc, {"tokens": toks, "labels": toks})
    assert before == counts()


def test_registered_width_counts_match_reference():
    """deepseek-v2-lite-16b at its registered width: 15.71 B parameters
    as the reference counts them, 2.66 B active a token; cut to its dense
    first layer for training, 0.50 B."""
    import dataclasses
    cfg = t_get(DEEPSEEK)
    total = n_params_analytic(cfg)
    assert total == j_count(j_get(DEEPSEEK))
    assert 15.6e9 < total < 15.8e9
    assert 2.6e9 < n_active_params(cfg) < 2.7e9
    one = dataclasses.replace(cfg, n_layers=1)
    assert ttf.layer_specs(one)[0].mixer == "mla"
    assert not ttf.layer_specs(one)[0].moe
    assert 0.49e9 < n_params_analytic(one) < 0.51e9


def _pair_inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_the_pair_matches_the_oracle(causal):
    """The flash kernel's plain version at MLA's (192, 128) pair (the CPU
    route of ``flash_attention``) and its backward against
    ``repro.kernels.ref.attention_ref`` and ``jax.vjp`` of it, Lq < Lk."""
    q, k, v, dout = _pair_inputs([(2, 4, 33, 192), (2, 4, 50, 192),
                                  (2, 4, 50, 128), (2, 4, 33, 128)], 31)
    scale = 192 ** -0.5
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, scale=scale)
    want, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal, scale=scale), *map(jnp.asarray, (q, k, v)))
    assert tuple(got.shape) == (2, 4, 33, 128)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    grads = attention_bwd_plain(*map(torch.from_numpy, (q, k, v, dout)),
                                causal=causal, scale=scale)
    for name, g, w in zip("qkv", grads, vjp(jnp.asarray(dout))):
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                        err_msg=name)


def test_plain_decode_at_the_pair_matches_the_oracle():
    q, kc, vc = _pair_inputs([(3, 16, 192), (3, 16, 40, 192),
                              (3, 16, 40, 128)], 32)
    lens = np.array([1, 23, 40], np.int32)
    got = tda.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                               torch.from_numpy(lens), scale=192 ** -0.5)
    want = jref.decode_attention_ref(*map(jnp.asarray, (q, kc, vc)),
                                     jnp.asarray(lens), scale=192 ** -0.5)
    assert tuple(got.shape) == (3, 16, 128)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_mla_calls_the_kernels_at_the_pair_with_its_scale(monkeypatch):
    """``mla_apply`` hands the kernels head-major q and k of nope + rope,
    v of ``v_head_dim`` and the scale (nope + rope) ** -0.5: prefill
    through ``flash_attention``, a decode step through
    ``decode_attention`` over the whole expanded cache."""
    jc, tc, _, tl = _mixer()
    m = tc.mla
    seen = []

    def flash(q, k, v, causal=True, scale=None, **kw):
        seen.append(("flash", q.shape, k.shape, v.shape, causal, scale))
        return attention_plain(q, k, v, causal, scale)

    def decode(q, kc, vc, kv_len=None, scale=None, **kw):
        seen.append(("decode", q.shape, kc.shape, vc.shape,
                     kv_len.tolist(), scale))
        return decode_attention_plain(q, kc, vc, kv_len, scale)

    monkeypatch.setattr(ops, "flash_attention", flash)
    monkeypatch.setattr(ops, "decode_attention", decode)
    h, dk, dv = tc.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim, \
        m.v_head_dim
    cache = (torch.zeros((2, 9, m.kv_lora_rank)),
             torch.zeros((2, 9, m.qk_rope_head_dim)))
    x = torch.from_numpy(_x(jc, 2, 5, 40))
    tattn.mla_apply(tl, tc, x, torch.arange(5)[None], cache_ckv=cache,
                    cache_len=0)
    tattn.mla_apply(tl, tc, x[:, :1], torch.tensor([[5], [3]]),
                    cache_ckv=cache,
                    cache_len=torch.tensor([5, 3], dtype=torch.int32))
    assert seen == [
        ("flash", (2, h, 5, dk), (2, h, 5, dk), (2, h, 5, dv), True,
         dk ** -0.5),
        ("decode", (2, h, dk), (2, h, 9, dk), (2, h, 9, dv), [6, 4],
         dk ** -0.5)]
