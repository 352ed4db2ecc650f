"""The port's models (dense and rwkv6) against ``repro.models`` on smoke
configs (fp32): the JAX params carried across by ``params_from_numpy``,
then prefill logits and 8 greedy decode steps.  Tolerance: atol and
rtol 1e-4 on the logits (fp32; the sums run in other orders, through
another attention algorithm or the WKV route), and the greedy tokens
must be equal.  qwen3's smoke config adds qk-norm, which runs through
the rmsnorm route.  rwkv6 prompts are a multiple of its smoke chunk
(16), as the JAX model's chunked scan requires.  In bf16 every leaf
keeps the JAX tree's float type (rwkv6 keeps five in fp32)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import (decode_attention as tda,  # noqa: E402
                                 flash_attention as tfa, rmsnorm as trms)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as twkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["gemma-2b", "qwen3-1.7b", "command-r-35b", "yi-9b"]
RWKV = "rwkv6-1.6b"
#: the context families: an encoder-decoder and cross-attention layers
CONTEXT = ["whisper-medium", "llama-3.2-vision-90b"]
#: the rwkv6 leaves the JAX tree keeps in fp32 inside a bf16 model
RWKV_FP32_LEAVES = ("mix_base", "decay_base", "bonus", "mix_k", "mix_r")


def _pair(arch):
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s", [(2, 37), (1, 64)])
def test_prefill_and_decode_match_reference(arch, b, s):
    _prefill_and_decode(arch, b, s)


@pytest.mark.parametrize("b,s", [(2, 32), (1, 64)])
def test_rwkv6_prefill_and_decode_match_reference(b, s):
    _prefill_and_decode(RWKV, b, s)


def _prefill_and_decode(arch, b, s):
    jc, tc, jp, tp = _pair(arch)
    toks = np.random.default_rng(s).integers(
        0, jc.vocab_size, (b, s)).astype(np.int32)
    steps = 8
    jcache = jm.init_cache(jc, b, s + steps)
    tcache = tm.init_cache(tc, b, s + steps, device="cpu")
    jl, jcache = jm.prefill(jp, jc, jnp.asarray(toks), jcache)
    tl, tcache = tm.prefill(tp, tc, torch.from_numpy(toks).long(), tcache)
    assert tuple(tl.shape) == (b, 1, jc.vocab_size)
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["length"].tolist() == [s] * b
    for _ in range(steps):
        jt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        tt = torch.argmax(tl[:, -1], dim=-1)
        np.testing.assert_array_equal(jt, tt.numpy())
        jl, jcache = jm.decode_step(jp, jc, jnp.asarray(jt)[:, None], jcache)
        tl, tcache = tm.decode_step(tp, tc, tt[:, None], tcache)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["length"].tolist() == [s + steps] * b


@pytest.mark.parametrize("arch", ARCHS + [RWKV] + CONTEXT
                         + ["jamba-1.5-large-398b"])
def test_param_tree_matches_reference(arch):
    """Same key names and leaf shapes; the meta device allocates
    nothing."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    jshapes = jax.eval_shape(lambda k: jm.init_params(jc, k),
                             jax.random.PRNGKey(0))
    tp = ttf.init_params(tc, device="meta")

    def shapes(tree):
        return {k: tuple(v.shape) for k, v in _flat(tree).items()}

    assert shapes(tp) == shapes(jshapes)
    assert tcommon.params_count(tp) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))


def test_bf16_rwkv6_leaves_keep_the_reference_float_types():
    """A bf16 rwkv6 tree: the port's own init and a JAX tree carried by
    ``params_from_numpy`` each give every leaf the JAX leaf's shape and
    float type - the five mixing / decay / bonus leaves fp32, the rest
    bf16."""
    jc = dataclasses.replace(j_smoke(RWKV), dtype="bfloat16")
    tc = dataclasses.replace(t_smoke(RWKV), dtype="bfloat16")
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(jp).items()}
    assert {v[1] for v in want.values()} == {"float32", "bfloat16"}
    assert all((v[1] == "float32") == k.endswith(RWKV_FP32_LEAVES)
               for k, v in want.items())
    for tp in (tm.init_params(tc, seed=0, device="cpu"),
               tm.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                    "cpu")):
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in _flat(tp).items()}
        assert got == want


@pytest.mark.parametrize("arch", CONTEXT)
def test_bf16_cross_gate_stays_fp32(arch):
    """A bf16 model with cross-attention: the 0-d ``gate`` of each cross
    layer stays fp32 (stacked, one a layer), in the port's own init and
    through ``params_from_numpy``, as in the JAX tree; every other leaf
    is bf16, and each leaf has the JAX leaf's shape."""
    jc = dataclasses.replace(j_smoke(arch), dtype="bfloat16")
    tc = dataclasses.replace(t_smoke(arch), dtype="bfloat16")
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(jp).items()}
    assert any(k.endswith("/gate") for k in want)
    assert all((v[1] == "float32") == k.endswith("/gate")
               for k, v in want.items())
    for tp in (tm.init_params(tc, seed=0, device="cpu"),
               tm.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                    "cpu")):
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in _flat(tp).items()}
        assert got == want


def test_rwkv6_init_draws_the_reference_distributions():
    """Uniform mix_base in (0, 1) and decay_base in (-8, -5); bonus
    N(0, 0.1^2); mix_k and mix_r 0.5."""
    tc = dataclasses.replace(t_smoke(RWKV), d_model=256, n_layers=1)
    p = tm.init_params(tc, seed=3, device="cpu")["blocks"]["sub0"]
    mix, decay = p["mixer"]["mix_base"], p["mixer"]["decay_base"]
    assert 0.0 <= float(mix.min()) and float(mix.max()) < 1.0
    assert -8.0 <= float(decay.min()) and float(decay.max()) < -5.0
    assert abs(float(p["mixer"]["bonus"].std()) - 0.1) < 0.02
    assert bool((p["ffn"]["mix_k"] == 0.5).all())
    assert bool((p["ffn"]["mix_r"] == 0.5).all())


def test_rwkv6_cache_is_state_and_updated_in_place():
    """The rwkv cache holds the token shifts and the fp32 WKV state,
    whatever max_len, and prefill and decode write it in place."""
    tc = t_smoke(RWKV)
    cache = tm.init_cache(tc, 2, 1, device="cpu")
    blk = cache["blocks"]["sub0"]
    n_h, dh = tc.d_model // tc.rwkv.head_size, tc.rwkv.head_size
    assert tuple(blk["wkv"].shape) == (tc.n_layers, 2, n_h, dh, dh)
    assert blk["wkv"].dtype == torch.float32
    assert tuple(blk["tm"].shape) == tuple(blk["cm"].shape) == (
        tc.n_layers, 2, tc.d_model)
    params = tm.init_params(tc, seed=0, device="cpu")
    wkv = blk["wkv"]
    toks = torch.randint(0, tc.vocab_size, (2, 32))
    _, out = tm.prefill(params, tc, toks, cache)
    assert out["blocks"]["sub0"]["wkv"] is wkv
    assert bool(wkv.abs().sum() > 0)
    assert out["length"].tolist() == [32, 32]
    before = wkv.clone()
    _, out = tm.decode_step(params, tc, toks[:, :1], out)
    assert out["blocks"]["sub0"]["wkv"] is wkv
    assert not torch.equal(wkv, before)
    assert out["length"].tolist() == [33, 33]


def test_rwkv6_prompt_length_follows_the_reference_chunk():
    """Prompts of at most ``chunk`` tokens, or a multiple of it, run;
    others raise ValueError where the JAX model's assertion fires."""
    tc = t_smoke(RWKV)
    params = tm.init_params(tc, seed=0, device="cpu")
    for s in (1, 5, 16, 48):
        cache = tm.init_cache(tc, 1, s, device="cpu")
        tm.prefill(params, tc, torch.ones((1, s), dtype=torch.long), cache)
    cache = tm.init_cache(tc, 1, 20, device="cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        tm.prefill(params, tc, torch.ones((1, 20), dtype=torch.long), cache)


def test_cache_is_head_major_and_updated_in_place():
    tc = t_smoke("gemma-2b")
    cache = tm.init_cache(tc, 3, 16, device="cpu")
    k = cache["blocks"]["sub0"]["k"]
    assert tuple(k.shape) == (tc.n_layers, 3, tc.n_kv_heads, 16,
                              tc.kv_head_dim())
    params = tm.init_params(tc, seed=0, device="cpu")
    toks = torch.randint(0, tc.vocab_size, (3, 5))
    _, out = tm.prefill(params, tc, toks, cache)
    assert out["blocks"]["sub0"]["k"] is k
    assert bool(k[:, :, :, :5].abs().sum() > 0)
    assert bool(k[:, :, :, 5:].abs().sum() == 0)


def test_launch_counts_stay_zero_on_the_cpu():
    """37 rmsnorms, 18 flash and 18 decode launches per forward are what
    the card counts for gemma-2b; the CPU route counts none."""
    _no_launches("gemma-2b")


def test_rwkv6_launch_counts_stay_zero_on_the_cpu():
    """73 rmsnorms and 24 rwkv6_scan launches per forward are what the
    card counts for rwkv6-1.6b; the CPU route counts none."""
    _no_launches(RWKV)


def _no_launches(arch):
    tc = t_smoke(arch)
    params = tm.init_params(tc, seed=0, device="cpu")

    def counts():
        return (trms.rmsnorm.launches, tfa.flash_attention.launches,
                tda.decode_attention.launches, twkv.launches)

    before = counts()
    cache = tm.init_cache(tc, 1, 12, device="cpu")
    logits, cache = tm.prefill(params, tc, torch.ones((1, 8), dtype=torch.long),
                               cache)
    tm.decode_step(params, tc, torch.ones((1, 1), dtype=torch.long), cache)
    assert before == counts()


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = tcommon.act_fn("gelu")(torch.from_numpy(x)).numpy()
    assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                    atol=1e-6, rtol=1e-6)


def test_embed_scale_is_cast_to_the_model_type():
    tc = t_smoke("gemma-2b")
    params = {"embed": torch.ones((4, 2048), dtype=torch.bfloat16)}
    cfg = type(tc)(**{**tc.__dict__, "d_model": 2048})
    x = ttf._embed_tokens(params, cfg, torch.tensor([[1]]))
    assert float(x[0, 0, 0]) == 45.25


def test_unported_paths_raise():
    """The cached prefill at an offset that once raised (4 tokens at
    offset 3 of a 16-long cache) now runs: the output and both caches
    against ``repro``'s ``gqa_apply`` at the same inputs.  Then training
    with a context, and the hybrid family's init."""
    tc, jc = t_smoke("gemma-2b"), j_smoke("gemma-2b")
    params = tm.init_params(tc, seed=0, device="cpu")
    cache = tm.init_cache(tc, 1, 16, device="cpu")
    p = tcommon.tree_map(lambda a: a[0], params["blocks"]["sub0"]["mixer"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4, tc.d_model)).astype(np.float32)
    ck, cv = (cache["blocks"]["sub0"][name][0] for name in ("k", "v"))
    ck.copy_(torch.from_numpy(rng.standard_normal(
        tuple(ck.shape)).astype(np.float32)))
    pos = 3 + np.arange(4)[None]
    jy, (jk, jv) = jattn.gqa_apply(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}, jc,
        jnp.asarray(x), jnp.asarray(pos),
        cache_kv=(jnp.asarray(ck.transpose(1, 2).numpy()),
                  jnp.asarray(cv.transpose(1, 2).numpy())),
        cache_len=jnp.asarray([3], jnp.int32))
    ty, (tk, tv) = tattn.gqa_apply(p, tc, torch.from_numpy(x),
                                   torch.from_numpy(pos), cache_kv=(ck, cv),
                                   cache_len=torch.tensor([3],
                                                          dtype=torch.int32))
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert_allclose(tk.transpose(1, 2).numpy(), np.asarray(jk), **TOL)
    assert_allclose(tv.transpose(1, 2).numpy(), np.asarray(jv), **TOL)
    # training with a context runs: a model without cross layers ignores
    # the vision embeddings, as the reference does
    tokens = torch.randint(0, tc.vocab_size, (1, 4))
    plain = tm.forward_train(params, tc, {"tokens": tokens,
                                          "labels": tokens})
    with_ctx = tm.forward_train(params, tc, {
        "tokens": tokens, "labels": tokens,
        "vision_embeds": torch.randn((1, 3, tc.d_model))})
    assert torch.equal(plain, with_ctx)
    # the hybrid family initialises: jamba's smoke config, 7 Mamba layers
    # and its one attention layer (at offset 4 of the period 8)
    jamba = t_smoke("jamba-1.5-large-398b")
    mixers = [spec.mixer for spec in ttf.layer_specs(jamba)]
    assert mixers.count("mamba") == 7 and mixers.count("attn") == 1
    assert mixers.index("attn") == 4
    tp = ttf.init_params(jamba, device="meta")
    assert all(v.device.type == "meta" for v in _flat(tp).values())
