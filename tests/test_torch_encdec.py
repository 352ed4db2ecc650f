"""The port's context families against ``repro.models`` on smoke configs
(fp32): whisper-medium's encoder-decoder and llama-3.2-vision-90b's
cross-attention layers.

Both packages get one numpy parameter tree: the JAX smoke init with every
cross-attention ``gate`` redrawn as N(0, 1), every norm scale as
1 + 0.3 N(0, 1) and every bias as 0.1 N(0, 1), from a numpy seed.  At
the reference's own init the gates are 0 and ``tanh(gate)`` multiplies
the cross output by 0, so the context would have no effect at all and
every encoder gradient would be exactly 0; unit scales and zero biases
would hide faults in the same way.  Tolerances: the forward atol and
rtol 1e-4 (``encode`` atol 1e-4) with greedy tokens equal, the loss
rtol 1e-5, gradient leaves atol 1e-5 and rtol 1e-4 (the same fp32
function summed in other orders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.registry import _ctx_len, _dec_len  # noqa: E402
from repro_torch.kernels import (decode_attention as tda,  # noqa: E402
                                 flash_attention as tfa, rmsnorm as trms)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

pytestmark = pytest.mark.torch

WHISPER = "whisper-medium"
VLM = "llama-3.2-vision-90b"
TOL = dict(atol=1e-4, rtol=1e-4)
LEAF_TOL = dict(atol=1e-5, rtol=1e-4)
BIASES = ("bias", "bq", "bk", "bv", "bo", "b_in", "b_out")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _awake(tree, rng):
    """The numpy tree with gates, norm scales and biases drawn away from
    the reference's init."""
    if isinstance(tree, dict):
        return {k: (_awake(v, rng) if isinstance(v, dict)
                    else _draw(k, np.asarray(v), rng))
                for k, v in tree.items()}
    return tree


def _draw(name, leaf, rng):
    noise = rng.standard_normal(leaf.shape).astype(np.float32)
    if name == "gate":
        return noise
    if name == "scale":
        return (1.0 + 0.3 * noise).astype(leaf.dtype)
    if name in BIASES:
        return (0.1 * noise).astype(leaf.dtype)
    return leaf


_PAIRS = {}


def _pair(arch):
    """(JAX config, port config, JAX params, port params, numpy tree),
    built once per arch."""
    if arch not in _PAIRS:
        jc, tc = j_smoke(arch), t_smoke(arch)
        jp = jm.init_params(jc, jax.random.PRNGKey(1))
        tree = _awake(jax.tree.map(np.asarray, jp),
                      np.random.default_rng(7))
        _PAIRS[arch] = (jc, tc, jax.tree.map(jnp.asarray, tree),
                        tm.params_from_numpy(tree, tc, "cpu"), tree)
    return _PAIRS[arch]


def _context(cfg, b, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _ctx_length(cfg, t):
    return cfg.vision.n_image_tokens if cfg.family == "vlm" else t


def test_awake_tree_moves_every_gate_scale_and_bias():
    _, _, _, _, tree = _pair(WHISPER)
    flat = _flat(tree)
    gates = [v for k, v in flat.items() if k.endswith("/gate")]
    assert gates and all(np.all(g != 0) for g in gates)
    biases = [v for k, v in flat.items() if k.split("/")[-1] in BIASES]
    assert biases and all(np.any(b != 0) for b in biases)
    assert any("/encoder/" in k for k in flat)


def test_encode_matches_reference():
    jc, tc, jp, tp, _ = _pair(WHISPER)
    frames = _context(jc, 2, 24, 3)
    want = np.asarray(jtf.encode(jp, jc, jnp.asarray(frames)))
    got = ttf.encode(tp, tc, torch.from_numpy(frames))
    assert tuple(got.shape) == (2, 24, jc.d_model)
    assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_sinusoid_matches_reference():
    pos = np.arange(37)
    assert_allclose(ttf._sinusoid(torch.from_numpy(pos), 64).numpy(),
                    np.asarray(jtf._sinusoid(jnp.asarray(pos), 64)),
                    atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch,path", [(VLM, "prefix_3/mixer"),
                                       (WHISPER, "blocks/sub0/cross")])
def test_cross_attn_prefill_and_cached_paths_match_reference(arch, path):
    """The context path (a prompt of 5, non-causal flash), then the
    cached path with one token (decode over the whole cross cache) and
    with a prompt of 3 (flash over the cache)."""
    jc, tc, jp, tp, _ = _pair(arch)
    jl, tl = jp, tp
    for key in path.split("/"):
        jl, tl = jl[key], tl[key]
    if path.startswith("blocks"):      # the first of the stacked layers
        jl = jax.tree.map(lambda a: a[0], jl)
        tl = tree_map(lambda a: a[0], tl)
    rng = np.random.default_rng(11)
    ctx = _context(jc, 2, 13, 12)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    jy, (jk, jv) = jattn.cross_attn_apply(jl, jc, jnp.asarray(x),
                                          jnp.asarray(ctx))
    ty, (tk, tv) = tattn.cross_attn_apply(tl, tc, torch.from_numpy(x),
                                          torch.from_numpy(ctx))
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert_allclose(tk.transpose(1, 2).numpy(), np.asarray(jk), **TOL)
    assert_allclose(tv.transpose(1, 2).numpy(), np.asarray(jv), **TOL)
    for s in (1, 3):
        xs = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
        jy, _ = jattn.cross_attn_apply(jl, jc, jnp.asarray(xs), None,
                                       cached_kv=(jk, jv))
        ty, kv = tattn.cross_attn_apply(tl, tc, torch.from_numpy(xs), None,
                                        cached_kv=(tk, tv))
        assert kv[1] is tv
        assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_cross_attn_qk_norm_renormalizes_a_cached_k():
    """With qk-norm the reference normalizes a cached k again; the port
    follows it (a smoke config with qk-norm added)."""
    import dataclasses
    jc = dataclasses.replace(j_smoke(VLM), use_qk_norm=True)
    tc = dataclasses.replace(t_smoke(VLM), use_qk_norm=True)
    jl = jattn.cross_attn_init(jax.random.PRNGKey(4), jc, jnp.float32)
    tree = _awake(jax.tree.map(np.asarray, jl), np.random.default_rng(5))
    jl = jax.tree.map(jnp.asarray, tree)
    tl = tm.params_from_numpy(tree, tc, "cpu")
    ctx = _context(jc, 2, 9, 6)
    x = np.random.default_rng(8).standard_normal(
        (2, 4, jc.d_model)).astype(np.float32)
    jy, (jk, jv) = jattn.cross_attn_apply(jl, jc, jnp.asarray(x),
                                          jnp.asarray(ctx))
    ty, (tk, tv) = tattn.cross_attn_apply(tl, tc, torch.from_numpy(x),
                                          torch.from_numpy(ctx))
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    jy, _ = jattn.cross_attn_apply(jl, jc, jnp.asarray(x[:, :1]), None,
                                   cached_kv=(jk, jv))
    ty, _ = tattn.cross_attn_apply(tl, tc, torch.from_numpy(x[:, :1]),
                                   None, cached_kv=(tk, tv))
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


_jit_prefill = jax.jit(jm.prefill, static_argnums=1)
_jit_decode = jax.jit(jm.decode_step, static_argnums=1)


def _serve(arch, b, s, ctx, steps=8):
    """Prefill with the context, then ``steps`` greedy steps in both
    packages, every logit held; returns the two prefills' logits."""
    jc, tc, jp, tp, _ = _pair(arch)
    toks = np.random.default_rng(s).integers(
        0, jc.vocab_size, (b, s)).astype(np.int32)
    t = ctx.shape[1]
    jcache = jm.init_cache(jc, b, s + steps, ctx_len=t)
    tcache = tm.init_cache(tc, b, s + steps, ctx_len=t, device="cpu")
    jl, jcache = _jit_prefill(jp, jc, jnp.asarray(toks), jcache,
                              jnp.asarray(ctx))
    tl, tcache = tm.prefill(tp, tc, torch.from_numpy(toks).long(), tcache,
                            context=torch.from_numpy(ctx))
    first = (tl.numpy(), np.asarray(jl))
    assert_allclose(*first, **TOL)
    for _ in range(steps):
        jt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        tt = torch.argmax(tl[:, -1], dim=-1)
        np.testing.assert_array_equal(jt, tt.numpy())
        jl, jcache = _jit_decode(jp, jc, jnp.asarray(jt)[:, None], jcache)
        tl, tcache = tm.decode_step(tp, tc, tt[:, None], tcache)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["length"].tolist() == [s + steps] * b
    return first


@pytest.mark.parametrize("arch", [WHISPER, VLM])
@pytest.mark.parametrize("b,s,t", [(2, 37, 24), (1, 64, 40)])
def test_prefill_and_decode_with_context_match_reference(arch, b, s, t):
    jc = _pair(arch)[0]
    _serve(arch, b, s, _context(jc, b, _ctx_length(jc, t), s))


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_other_context_moves_the_logits(arch):
    """The control: a context of another seed moves the prefill's logits
    by more than 1e-2 (relative L2) in both packages."""
    jc = _pair(arch)[0]
    t = _ctx_length(jc, 24)
    a = _serve(arch, 2, 20, _context(jc, 2, t, 1), steps=0)
    b = _serve(arch, 2, 20, _context(jc, 2, t, 2), steps=0)
    for got, other in zip(a, b):
        assert np.linalg.norm(got - other) / np.linalg.norm(got) > 1e-2


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_forward_train_loss_and_gradients_match_reference(arch):
    jc, tc, jp, tp, _ = _pair(arch)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, jc.vocab_size, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -3, axis=1)
    ctx = _context(jc, 2, _ctx_length(jc, 40), 22)
    key = "frames" if jc.encoder_layers else "vision_embeds"
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              key: jnp.asarray(ctx)}
    jl, jg = jax.jit(jax.value_and_grad(jsteps.loss_fn), static_argnums=1)(
        jp, jc, jbatch)
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels),
              key: torch.from_numpy(ctx)}
    tl, tg = tsteps.value_and_grad(tp, tc, tbatch)
    assert_allclose(float(tl), float(jl), rtol=1e-5)
    want, got = _flat(jax.tree.map(np.asarray, jg)), _flat(tg)
    assert set(got) == set(want)
    for k in want:
        assert_allclose(got[k].numpy(), want[k], err_msg=k, **LEAF_TOL)
        if "/encoder/" in k or "/cross/" in k or "/prefix_3/mixer/" in k:
            assert np.any(got[k].numpy() != 0), k


def test_microbatched_whisper_step_carries_the_frames():
    """Two microbatches of the frames-carrying batch give the whole
    batch's loss and gradients."""
    _, tc, _, tp, _ = _pair(WHISPER)
    rng = np.random.default_rng(31)
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1),
             "frames": torch.from_numpy(_context(tc, 2, 20, 32))}
    split = tsteps.microbatch_split(batch, 2)
    assert tuple(split["frames"].shape) == (2, 1, 20, tc.d_model)
    whole, g_whole = tsteps.value_and_grad(tp, tc, batch)
    parts = [tsteps.value_and_grad(tp, tc, {k: v[i] for k, v in
                                            split.items()})
             for i in range(2)]
    assert_allclose(float(sum(p[0] for p in parts) / 2), float(whole),
                    rtol=1e-5)
    enc = "/encoder/blocks/mixer/wq"
    mean = (_flat(parts[0][1])[enc] + _flat(parts[1][1])[enc]) / 2
    assert_allclose(mean.numpy(), _flat(g_whole)[enc].numpy(), **LEAF_TOL)


def test_prefill_step_passes_the_frames():
    jc, tc, _, tp, _ = _pair(WHISPER)
    toks = torch.from_numpy(np.random.default_rng(41).integers(
        0, tc.vocab_size, (2, 10)))
    frames = torch.from_numpy(_context(tc, 2, 16, 42))
    step = tsteps.make_prefill_step(tc)
    got, _ = step(tp, {"tokens": toks, "frames": frames},
                  tm.init_cache(tc, 2, 12, ctx_len=16, device="cpu"))
    want, _ = tm.prefill(tp, tc, toks,
                         tm.init_cache(tc, 2, 12, ctx_len=16, device="cpu"),
                         context=frames)
    assert torch.equal(got, want)


def test_context_lengths_follow_the_reference_registry():
    from repro.configs import registry as jreg
    for arch in (WHISPER, VLM, "gemma-2b"):
        jc, tc = j_smoke(arch), t_smoke(arch)
        for s in (64, 4096, 32768):
            assert _dec_len(tc, s) == jreg._dec_len(jc, s)
            assert _ctx_len(tc, s) == jreg._ctx_len(jc, s)


def test_cross_caches_are_head_major_and_written_once():
    jc, tc, _, tp, _ = _pair(WHISPER)
    cache = tm.init_cache(tc, 2, 12, ctx_len=16, device="cpu")
    blk = cache["blocks"]["sub0"]
    assert tuple(blk["enc_k"].shape) == (tc.n_layers, 2, tc.n_kv_heads, 16,
                                         tc.kv_head_dim())
    enc_k = blk["enc_k"]
    toks = torch.ones((2, 6), dtype=torch.long)
    logits, cache = tm.prefill(tp, tc, toks, cache, context=torch.from_numpy(
        _context(tc, 2, 16, 51)))
    assert cache["blocks"]["sub0"]["enc_k"] is enc_k
    before = enc_k.clone()
    tm.decode_step(tp, tc, torch.argmax(logits[:, -1], -1)[:, None], cache)
    assert torch.equal(enc_k, before) and bool(enc_k.abs().sum() > 0)
    vc = t_smoke(VLM)
    vcache = tm.init_cache(vc, 1, 8, ctx_len=16, device="cpu")
    assert set(vcache["prefix_3"]) == {"xk", "xv"}
    assert set(vcache["prefix_0"]) == {"k", "v"}


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_launch_counts_stay_zero_on_the_cpu(arch):
    _, tc, _, tp, _ = _pair(arch)

    def counts():
        return (trms.rmsnorm.launches, tfa.flash_attention.launches,
                tfa.flash_attention_bwd.launches,
                tda.decode_attention.launches)

    before = counts()
    ctx = torch.from_numpy(_context(tc, 1, _ctx_length(tc, 8), 61))
    cache = tm.init_cache(tc, 1, 10, ctx_len=ctx.shape[1], device="cpu")
    toks = torch.ones((1, 8), dtype=torch.long)
    logits, cache = tm.prefill(tp, tc, toks, cache, context=ctx)
    tm.decode_step(tp, tc, torch.ones((1, 1), dtype=torch.long), cache)
    key = "frames" if tc.encoder_layers else "vision_embeds"
    tsteps.value_and_grad(tp, tc, {"tokens": toks, "labels": toks,
                                   key: ctx})
    assert before == counts()
