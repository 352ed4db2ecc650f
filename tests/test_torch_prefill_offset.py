"""The cached prefill at a non-zero offset against ``repro`` on the CPU
(fp32 unless a case says bf16): the plain attention with per-row query
offsets and key lengths against the reference's ``_sdpa_block`` /
``_sdpa``, ``gqa_apply`` and ``mla_apply`` writing a prompt into a cache
at per-row offsets, and ``_run_layers`` continued from a cache on seven
families' smoke configs.

Inputs are drawn with numpy and handed to both packages; the JAX params
are carried across by ``params_from_numpy``, with every cross-attention
gate redrawn as N(0, 1), every norm scale as 1 + 0.3 N(0, 1), every bias
and Mamba ``conv_b`` as 0.1 N(0, 1) and ``d_skip`` as 1 + 0.3 N(0, 1)
(at the reference's init a gate of 0 multiplies the context away, and a
conv without its bias would pass).

Tolerances, each the family's own prefill test's: attention rtol 1e-5 /
atol 1e-6 in fp32 (the same fp32 function summed in another order) and
in bf16 two bf16 ulps plus 2^-8 (``BF16_TOL``); MLA rtol
1e-5 / atol 1e-6 (``tests/test_torch_mla.py``); ``gqa_apply`` and the
layer stacks atol and rtol 1e-4 (``tests/test_torch_models.py``,
``test_torch_encdec.py``, ``test_torch_mamba.py``); every cache leaf the
same, the port's head-major K / V caches read back in the reference's
(B, Lmax, Hkv, D) order.  Mamba and RWKV take prompts that are
multiples of their smoke chunk (16), as the reference asserts, so the
layer-stack cases continue with 16 tokens after a 32-token prefill.
"""

import functools

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
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.registry import _ctx_len  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (attention_lse_plain,  # noqa: E402
                                     attention_plain)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402

pytestmark = pytest.mark.torch

ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
#: bf16: two bf16 ulps of the reference's value plus 2^-8 (both round
#: once; the reference also rounds P to bf16 before the product, the port
#: keeps it in fp32; rows of few keys are O(1), so a max-abs limit alone
#: would not fit them)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -8)
MLA_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(atol=1e-4, rtol=1e-4)
#: the port's head-major cache leaves, (…, Hkv, L, D) against the
#: reference's (…, L, Hkv, D)
HEAD_MAJOR = ("k", "v", "xk", "xv", "enc_k", "enc_v")
BIASES = ("bias", "bq", "bk", "bv", "bo", "b_in", "b_out", "conv_b")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _awake(tree, rng, path=""):
    """The numpy tree with the leaves whose init hides a fault drawn off
    it: gates N(0, 1), norm scales and ``d_skip`` 1 + 0.3 N(0, 1),
    biases and ``conv_b`` 0.1 N(0, 1)."""
    if isinstance(tree, dict):
        return {k: _awake(v, rng, f"{path}/{k}") for k, v in tree.items()}
    name = path.rsplit("/", 1)[-1]
    draw = rng.standard_normal(tree.shape)
    if name == "gate":
        return draw.astype(tree.dtype)
    if name in ("scale", "d_skip"):
        return (1 + 0.3 * draw).astype(tree.dtype)
    if name in BIASES:
        return (0.1 * draw).astype(tree.dtype)
    return tree


def _head_major_back(name: str, t: torch.Tensor) -> np.ndarray:
    """A port cache leaf in the reference's layout."""
    leaf = name.rsplit("/", 1)[-1]
    return (t.transpose(-3, -2) if leaf in HEAD_MAJOR else t).numpy()


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------ attention -----------------------------

#: (b, hq, hkv, s, t, d, offsets, causal): offsets past t - s (the clamp
#: case's rows see every key up to t), a row at 0, s = 1024 (the
#: reference's chunked scan, two q chunks of ``CHUNK_Q`` 512), a
#: non-causal one (kv_len alone, as a decode over a cache) and s = 1
SDPA_CASES = [
    (3, 4, 2, 37, 64, 32, (0, 3, 17), True),
    (3, 4, 1, 37, 64, 32, (0, 20, 40), True),
    (2, 2, 2, 1024, 1536, 16, (17, 500), True),
    (2, 4, 2, 37, 64, 32, (5, 20), False),
    (3, 4, 2, 1, 64, 32, (0, 9, 63), False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,offsets,causal", SDPA_CASES)
def test_plain_attention_with_offsets_matches_sdpa(b, hq, hkv, s, t, d,
                                                    offsets, causal, dtype):
    rng = np.random.default_rng(s + t)
    q, k, v = (_normal(rng, b, s, hq, d), _normal(rng, b, t, hkv, d),
               _normal(rng, b, t, hkv, d))
    off = np.asarray(offsets, np.int32)
    lens = off + s
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jattn._sdpa(jnp.asarray(q, jd), jnp.asarray(k, jd),
                       jnp.asarray(v, jd), causal=causal,
                       q_offset=jnp.asarray(off), kv_len=jnp.asarray(lens))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td).transpose(1, 2).contiguous()
                  for a in (q, k, v))
    got = attention_plain(tq, tk, tv, causal=causal,
                          q_offset=torch.from_numpy(off),
                          kv_len=torch.from_numpy(lens)).transpose(1, 2)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert_allclose(got.numpy(), want, **ATTN_TOL)
    else:
        assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_plain_attention_without_offsets_is_unchanged():
    """Both None: bit for bit the rule "the last Lq of Lk positions"."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_normal(rng, 2, 4, 37, 32)),
               torch.from_numpy(_normal(rng, 2, 2, 64, 32)),
               torch.from_numpy(_normal(rng, 2, 2, 64, 32)))
    full = torch.full((2,), 64 - 37, dtype=torch.int32)
    assert torch.equal(attention_plain(q, k, v),
                       attention_plain(q, k, v, q_offset=full))
    assert torch.equal(attention_lse_plain(q, k),
                       attention_lse_plain(q, k, q_offset=full,
                                           kv_len=full + 37))


def test_plain_lse_with_offsets_is_the_logsumexp_of_its_rows():
    rng = np.random.default_rng(1)
    q, k = (torch.from_numpy(_normal(rng, 2, 4, 9, 32)),
            torch.from_numpy(_normal(rng, 2, 2, 40, 32)))
    off = torch.tensor([3, 20], dtype=torch.int32)
    got = attention_lse_plain(q, k, q_offset=off, kv_len=off + 9)
    kg = torch.repeat_interleave(k, 2, dim=1)
    for b in range(2):
        for r in range(9):
            keys = int(off[b]) + r + 1
            logits = torch.einsum("hd,hkd->hk", q[b, :, r],
                                  kg[b, :, :keys])
            assert_allclose(got[b, :, r].numpy(),
                            torch.logsumexp(logits * 32 ** -0.5,
                                            dim=-1).numpy(), **ATTN_TOL)


def test_flash_attention_cpu_route_takes_offsets():
    """On the CPU the wrapper (and ``ops``) run the plain version with the
    offsets; offsets on another device than q are refused."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_normal(rng, 2, 4, 9, 32)),
               torch.from_numpy(_normal(rng, 2, 2, 40, 32)),
               torch.from_numpy(_normal(rng, 2, 2, 40, 32)))
    off = torch.tensor([0, 20], dtype=torch.int32)
    want = attention_plain(q, k, v, q_offset=off, kv_len=off + 9)
    got = ops.flash_attention(q, k, v, q_offset=off, kv_len=off + 9)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="one CUDA device or all on the"):
        ops.flash_attention(q, k, v, q_offset=off.to("meta"))


# ------------------------------ model paths ----------------------------

_PAIRS = {}


def _pair(arch):
    """(JAX config, port config, JAX params, port params), built once."""
    if arch not in _PAIRS:
        jc, tc = j_smoke(arch), t_smoke(arch)
        tree = _awake(jax.tree.map(np.asarray, jax.jit(
            jm.init_params, static_argnums=0)(jc, jax.random.PRNGKey(1))),
            np.random.default_rng(7))
        _PAIRS[arch] = (jc, tc, jax.tree.map(jnp.asarray, tree),
                        tm.params_from_numpy(tree, tc, "cpu"))
    return _PAIRS[arch]


def _first_layer(params, tmap):
    """The first stacked layer's mixer params (``tmap``: the package's
    tree map)."""
    return tmap(lambda a: a[0], params["blocks"]["sub0"]["mixer"])


#: (b, s, lmax, offsets): rows at 0, 3 and 17; then the clamp case, a row
#: whose offset + s passes Lmax (written from Lmax - s, as
#: ``dynamic_update_slice`` clamps), and s = 1 is decode's, not this
OFFSET_CASES = [(3, 7, 32, (0, 3, 17)), (3, 7, 20, (0, 3, 17))]


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-1.7b"])
@pytest.mark.parametrize("b,s,lmax,offsets", OFFSET_CASES)
def test_gqa_apply_at_offsets_matches_reference(arch, b, s, lmax, offsets):
    jc, tc, jp, tp = _pair(arch)
    jl, tl = _first_layer(jp, jax.tree.map), _first_layer(tp, tree_map)
    hkv, hd = jc.n_kv_heads, jc.kv_head_dim()
    rng = np.random.default_rng(lmax)
    ck, cv = (_normal(rng, b, lmax, hkv, hd) for _ in range(2))
    x = _normal(rng, b, s, jc.d_model)
    off = np.asarray(offsets, np.int32)
    pos = off[:, None] + np.arange(s)
    jy, (jk, jv) = jattn.gqa_apply(
        jl, jc, jnp.asarray(x), jnp.asarray(pos),
        cache_kv=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.asarray(off))
    tck, tcv = (torch.from_numpy(a).transpose(1, 2).contiguous()
                for a in (ck, cv))
    ty, (tk, tv) = tattn.gqa_apply(
        tl, tc, torch.from_numpy(x), torch.from_numpy(pos),
        cache_kv=(tck, tcv), cache_len=torch.from_numpy(off))
    assert tk is tck and tv is tcv          # written in place
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert_allclose(tk.transpose(1, 2).numpy(), np.asarray(jk), **TOL)
    assert_allclose(tv.transpose(1, 2).numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("b,s,lmax,offsets", OFFSET_CASES)
def test_mla_apply_at_offsets_matches_reference(b, s, lmax, offsets):
    jc, tc, jp, tp = _pair("deepseek-v2-lite-16b")
    jl, tl = jp["prefix_0"]["mixer"], tp["prefix_0"]["mixer"]
    m = jc.mla
    rng = np.random.default_rng(lmax + 1)
    ckv = _normal(rng, b, lmax, m.kv_lora_rank)
    kpe = _normal(rng, b, lmax, m.qk_rope_head_dim)
    x = _normal(rng, b, s, jc.d_model)
    off = np.asarray(offsets, np.int32)
    pos = off[:, None] + np.arange(s)
    jy, jcache = jattn.mla_apply(
        jl, jc, jnp.asarray(x), jnp.asarray(pos),
        cache_ckv=(jnp.asarray(ckv), jnp.asarray(kpe)),
        cache_len=jnp.asarray(off))
    tcache = (torch.from_numpy(ckv.copy()), torch.from_numpy(kpe.copy()))
    ty, got = tattn.mla_apply(tl, tc, torch.from_numpy(x),
                              torch.from_numpy(pos), cache_ckv=tcache,
                              cache_len=torch.from_numpy(off))
    assert got[0] is tcache[0]               # written in place
    assert_allclose(ty.numpy(), np.asarray(jy), **MLA_TOL)
    for g, w in zip(got, jcache):
        assert_allclose(g.numpy(), np.asarray(w), **MLA_TOL)


#: a decode step whose second row's cache is full (``cache_len`` = Lmax):
#: the reference writes that row's token at Lmax - 1, as
#: ``dynamic_update_slice`` clamps the start, and attends to every key
FULL_B, FULL_LMAX, FULL_LENS = 2, 8, (3, 8)


def _check_full_cache_write(got, want, old, tol):
    """A decode step's cache (B, Lmax, ...) in the reference's layout:
    the token written at row 0's ``cache_len`` and at row 1's clamped
    slot Lmax - 1, within ``tol`` of the reference's projection, and
    every other slot the input's, bit for bit."""
    written = [(0, FULL_LENS[0]), (1, FULL_LMAX - 1)]
    kept = np.ones(got.shape[:2], bool)
    for row, slot in written:
        kept[row, slot] = False
        assert not np.array_equal(got[row, slot], old[row, slot])
        assert_allclose(got[row, slot], want[row, slot], **tol)
    assert np.array_equal(got[kept], old[kept])
    assert np.array_equal(want[kept], old[kept])


def test_gqa_decode_at_a_full_cache_matches_reference():
    jc, tc, jp, tp = _pair("gemma-2b")
    jl, tl = _first_layer(jp, jax.tree.map), _first_layer(tp, tree_map)
    hkv, hd = jc.n_kv_heads, jc.kv_head_dim()
    rng = np.random.default_rng(8)
    ck, cv = (_normal(rng, FULL_B, FULL_LMAX, hkv, hd) for _ in range(2))
    x = _normal(rng, FULL_B, 1, jc.d_model)
    lens = np.asarray(FULL_LENS, np.int32)
    jy, (jk, jv) = jattn.gqa_apply(
        jl, jc, jnp.asarray(x), jnp.asarray(lens[:, None]),
        cache_kv=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.asarray(lens))
    tck, tcv = (torch.from_numpy(a.copy()).transpose(1, 2).contiguous()
                for a in (ck, cv))
    ty, (tk, tv) = tattn.gqa_apply(
        tl, tc, torch.from_numpy(x), torch.from_numpy(lens[:, None]),
        cache_kv=(tck, tcv), cache_len=torch.from_numpy(lens))
    assert_allclose(ty.numpy(), np.asarray(jy), **ATTN_TOL)
    for got, want, old in ((tk, jk, ck), (tv, jv, cv)):
        _check_full_cache_write(got.transpose(1, 2).numpy(),
                                np.asarray(want), old, ATTN_TOL)


def test_mla_decode_at_a_full_cache_matches_reference():
    jc, tc, jp, tp = _pair("deepseek-v2-lite-16b")
    jl, tl = jp["prefix_0"]["mixer"], tp["prefix_0"]["mixer"]
    m = jc.mla
    rng = np.random.default_rng(9)
    ckv = _normal(rng, FULL_B, FULL_LMAX, m.kv_lora_rank)
    kpe = _normal(rng, FULL_B, FULL_LMAX, m.qk_rope_head_dim)
    x = _normal(rng, FULL_B, 1, jc.d_model)
    lens = np.asarray(FULL_LENS, np.int32)
    jy, jcache = jattn.mla_apply(
        jl, jc, jnp.asarray(x), jnp.asarray(lens[:, None]),
        cache_ckv=(jnp.asarray(ckv), jnp.asarray(kpe)),
        cache_len=jnp.asarray(lens))
    ty, got = tattn.mla_apply(
        tl, tc, torch.from_numpy(x), torch.from_numpy(lens[:, None]),
        cache_ckv=(torch.from_numpy(ckv.copy()),
                   torch.from_numpy(kpe.copy())),
        cache_len=torch.from_numpy(lens))
    assert_allclose(ty.numpy(), np.asarray(jy), **MLA_TOL)
    for g, w, old in zip(got, jcache, (ckv, kpe)):
        _check_full_cache_write(g.numpy(), np.asarray(w), old, MLA_TOL)


def test_an_int_offset_is_every_rows_offset():
    """``cache_len`` as a non-zero int: every row at that offset, as a
    (B,) tensor of it."""
    jc, tc, jp, tp = _pair("gemma-2b")
    tl = _first_layer(tp, tree_map)
    hkv, hd = tc.n_kv_heads, tc.kv_head_dim()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_normal(rng, 2, 5, tc.d_model))
    cache = torch.from_numpy(_normal(rng, 2, hkv, 16, hd))
    pos = 4 + torch.arange(5)[None]
    outs = []
    for cache_len in (4, torch.full((2,), 4, dtype=torch.int32)):
        kv = (cache.clone(), cache.clone())
        outs.append(tattn.gqa_apply(tl, tc, x, pos, cache_kv=kv,
                                    cache_len=cache_len))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


# ------------------------------ layer stacks ---------------------------

#: the seven families: dense MQA, dense GQA with qk-norm, MLA + MoE, the
#: hybrid (Mamba, attention, MoE), encoder-decoder (cross caches from a
#: prefill with frames), cross-attention layers over vision embeddings,
#: RWKV6
ARCHS = ["gemma-2b", "qwen3-1.7b", "deepseek-v2-lite-16b",
         "jamba-1.5-large-398b", "whisper-medium", "llama-3.2-vision-90b",
         "rwkv6-1.6b"]
#: the first prefill, the continuation, the cache, the rows' offsets: row
#: 0 continues right after the prefill, rows 1 and 2 re-prefill from 3
#: and 17 (a suffix after an invalidated artifact's offset)
S0, S, LMAX, OFFSETS = 32, 16, 48, (32, 3, 17)


_jit_prefill = jax.jit(jm.prefill, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def _jit_continue(jp, jc, x, positions, cache, cache_len):
    """The reference's ``_run_layers`` from a cache, jitted: its output
    and the cache."""
    x, cache, _ = jtf._run_layers(jp, jc, x, positions=positions,
                                  cache=cache, cache_len=cache_len)
    return x, cache


def _context(jc, b, rng):
    """A context for the cross layers (whisper's frames, the vlm's vision
    embeddings), or None."""
    if jc.family not in ("audio", "vlm"):
        return None, 0
    n = jc.vision.n_image_tokens if jc.family == "vlm" else 24
    return _normal(rng, b, n, jc.d_model), _ctx_len(jc, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_layers_continues_from_a_cache(arch):
    """A batched prefill of ``S0`` tokens fills both caches (and, with a
    context, the cross caches); then ``_run_layers`` runs ``S`` more
    embedded tokens at per-row offsets, positions ``offset + arange(S)``
    and no context: the outputs and every cache leaf against the
    reference's."""
    jc, tc, jp, tp = _pair(arch)
    b = len(OFFSETS)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jc.vocab_size, (b, S0)).astype(np.int32)
    ctx, ctx_len = _context(jc, b, rng)
    jcache = jm.init_cache(jc, b, LMAX, ctx_len=ctx_len)
    tcache = tm.init_cache(tc, b, LMAX, ctx_len=ctx_len, device="cpu")
    _, jcache = _jit_prefill(jp, jc, jnp.asarray(toks), jcache,
                             None if ctx is None else jnp.asarray(ctx))
    _, tcache = tm.prefill(tp, tc, torch.from_numpy(toks).long(), tcache,
                           context=None if ctx is None
                           else torch.from_numpy(ctx))
    x = _normal(rng, b, S, jc.d_model)
    off = np.asarray(OFFSETS, np.int32)
    pos = off[:, None] + np.arange(S)
    jx, jcache = _jit_continue(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                               jcache, jnp.asarray(off))
    tx, tcache, _ = ttf._run_layers(tp, tc, torch.from_numpy(x),
                                    positions=torch.from_numpy(pos),
                                    cache=tcache,
                                    cache_len=torch.from_numpy(off))
    assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    want = {k: v for k, v in _flat(jcache).items() if k != "/length"}
    got = {k: v for k, v in _flat(tcache).items() if k != "/length"}
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert_allclose(_head_major_back(name, leaf),
                        np.asarray(want[name]), err_msg=name, **TOL)
