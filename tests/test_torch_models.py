"""The port's dense models against ``repro.models`` on smoke configs
(fp32): the JAX params carried across by ``params_from_numpy``, then
prefill logits and 8 greedy decode steps.  Tolerance: atol and rtol
1e-4 on the logits (fp32; the sums run in other orders, through
another attention algorithm), and the greedy tokens must be equal.
qwen3's smoke config adds qk-norm, which runs through the rmsnorm
route."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import (decode_attention as tda,  # noqa: E402
                                 flash_attention as tfa, rmsnorm as trms)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["gemma-2b", "qwen3-1.7b"]


def _pair(arch):
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s", [(2, 37), (1, 64)])
def test_prefill_and_decode_match_reference(arch, b, s):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Same key names and leaf shapes; the meta device allocates
    nothing."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    jshapes = jax.eval_shape(lambda k: jm.init_params(jc, k),
                             jax.random.PRNGKey(0))
    tp = ttf.init_params(tc, device="meta")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        return {prefix: tuple(tree.shape)}

    assert flat(tp) == flat(jshapes)
    assert tcommon.params_count(tp) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))


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
    tc = t_smoke("gemma-2b")
    params = tm.init_params(tc, seed=0, device="cpu")
    before = (trms.rmsnorm.launches, tfa.flash_attention.launches,
              tda.decode_attention.launches)
    cache = tm.init_cache(tc, 1, 12, device="cpu")
    logits, cache = tm.prefill(params, tc, torch.ones((1, 8), dtype=torch.long),
                               cache)
    tm.decode_step(params, tc, torch.ones((1, 1), dtype=torch.long), cache)
    assert before == (trms.rmsnorm.launches, tfa.flash_attention.launches,
                      tda.decode_attention.launches)


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
    tc = t_smoke("gemma-2b")
    params = tm.init_params(tc, seed=0, device="cpu")
    cache = tm.init_cache(tc, 1, 16, device="cpu")
    p = tcommon.tree_map(lambda a: a[0], params["blocks"]["sub0"]["mixer"])
    x = torch.zeros((1, 4, tc.d_model))
    kv = (cache["blocks"]["sub0"]["k"][0], cache["blocks"]["sub0"]["v"][0])
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        tattn.gqa_apply(p, tc, x, torch.arange(4)[None], cache_kv=kv,
                        cache_len=torch.tensor([3]))
    with pytest.raises(NotImplementedError, match="forward_train"):
        tm.forward_train(params, tc, {})
    with pytest.raises(NotImplementedError, match="mamba"):
        ttf.init_params(t_smoke("jamba-1.5-large-398b"), device="meta")
