"""The port's training path on the CPU against the JAX package's, on
smoke configs in fp32: ``forward_train`` (loss and every gradient leaf)
against ``jax.value_and_grad`` of ``repro.runtime.steps.loss_fn`` on the
dense family (gemma-2b, qwen3-1.7b with qk-norm, yi-9b, command-r-35b
with layernorm) and on rwkv6-1.6b (its WKV on the plain route); the
chunked loss with a remainder; AdamW, its schedule, clipping and
compression against ``repro.optim``; three smoke train steps; gradient
accumulation; the synthetic data stream.  The JAX params carry across
by ``params_from_numpy``.  Tolerances: loss rtol 1e-5, gradient leaves
atol 1e-5 and rtol 1e-4 (the same fp32 function summed in other
orders, and the backward's sums are longer than the forward's);
optimizer state within 1e-6; compression and data bit for bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.data import (DataConfig, PrefetchLoader,  # noqa: E402
                              SyntheticLMStream)
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

pytestmark = pytest.mark.torch

DENSE = ["gemma-2b", "qwen3-1.7b", "yi-9b", "command-r-35b"]
RWKV = "rwkv6-1.6b"
LEAF_TOL = dict(atol=1e-5, rtol=1e-4)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _pair(arch, seed=1):
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = jm.init_params(jc, jax.random.PRNGKey(seed))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s)).astype(np.int32)


def _check_loss_and_grads(arch, s):
    jc, tc, jp, tp = _pair(arch)
    toks = _tokens(jc.vocab_size, 2, s)
    labels = np.roll(toks, -3, axis=1)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jl, jg = jax.jit(jax.value_and_grad(jsteps.loss_fn), static_argnums=1)(
        jp, jc, jbatch)
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    tl, tg = tsteps.value_and_grad(tp, tc, tbatch)
    assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jg))
    got = _flat(tg)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert g.dtype == torch.float32 and g.shape == want[path].shape
        assert_allclose(g.numpy(), want[path], **LEAF_TOL, err_msg=path)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_loss_and_grads_match_reference(arch):
    _check_loss_and_grads(arch, 37)


def test_rwkv6_forward_train_matches_reference_on_the_plain_route():
    """rwkv6 trains on the CPU, where its WKV is plain PyTorch (a
    sequence that is a multiple of the smoke chunk, 16)."""
    _check_loss_and_grads(RWKV, 32)


def test_chunked_loss_with_a_remainder(monkeypatch):
    """Both packages' ``CE_CHUNK`` at 16 over S = 37: 36 shifted
    positions in two chunks of 16 and a remainder of 4, equal to the
    reference and to one unchunked cross-entropy."""
    monkeypatch.setattr(jtf, "CE_CHUNK", 16)
    monkeypatch.setattr(ttf, "CE_CHUNK", 16)
    chunks = []
    real = ttf._chunk_loss

    def counted(xc, yc, head):
        chunks.append(xc.shape[1])
        return real(xc, yc, head)

    monkeypatch.setattr(ttf, "_chunk_loss", counted)
    _check_loss_and_grads("gemma-2b", 37)
    assert chunks[:3] == [16, 16, 4]

    jc, tc, jp, tp = _pair("gemma-2b")
    toks = _tokens(jc.vocab_size, 2, 37, seed=5)
    t = torch.from_numpy(toks)
    x = ttf._embed_tokens(tp, tc, t.long())
    x, _, _ = ttf._run_layers(tp, tc, x, positions=torch.arange(37)[None])
    x = tcommon.norm_apply(tp["final_norm"], x, tc.norm)
    logits = ttf._logits(tp, tc, x)
    whole = tcommon.cross_entropy(logits[:, :-1], t[:, 1:])
    chunked = ttf._chunked_ce(tp, tc, x, t)
    assert_allclose(float(chunked), float(whole), rtol=1e-5)
    assert_allclose(float(whole), float(jcommon.cross_entropy(
        jnp.asarray(logits[:, :-1].detach().numpy()),
        jnp.asarray(toks[:, 1:]))), rtol=1e-6)


def test_cross_entropy_with_a_mask_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32)
    for m in (None, mask):
        want = jcommon.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = tcommon.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_tree(seed=0):
    """A param tree with decayed and undecayed leaves, and grads."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "blocks": {"sub0": {
        "mixer": {"wq": (3, 8, 8), "q_norm": {"scale": (3, 8)}},
        "norm1": {"scale": (3, 8)}, "ffn": {"w_up": (3, 8, 12),
                                            "b_up": (3, 12)}}}}

    def draw(tree, scale):
        if isinstance(tree, dict):
            return {k: draw(v, scale) for k, v in tree.items()}
        return (rng.standard_normal(tree) * scale).astype(np.float32)

    return draw(shapes, 1.0), draw(shapes, 0.3)


def _t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moments):
    """Five AdamW steps (warmup, then cosine; the clip engaged): params
    and both moments within 1e-6, the metrics equal."""
    params, grads = _opt_tree()
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=1.0,
              moment_dtype=moments)
    jcfg, tcfg = ja.AdamWConfig(**kw), ta.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = ja.init_state(jcfg, jp)
    tp = _t(params)
    ts = ta.init_state(tcfg, tp)
    for i in range(5):
        g = jax.tree.map(lambda x: x * (1.0 + i), grads)
        jp, js, jmet = ja.apply_updates(jcfg, jp, jax.tree.map(
            jnp.asarray, g), js)
        tp, ts, tmet = ta.apply_updates(tcfg, tp, _t(g), ts)
        assert float(tmet["lr"]) == float(jmet["lr"])
        assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                        rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for name, jt, tt in (("params", jp, tp), ("mu", js.mu, ts.mu),
                         ("nu", js.nu, ts.nu)):
        want = _flat(jax.tree.map(lambda x: np.asarray(x, np.float32), jt))
        for path, got in _flat(tt).items():
            assert str(got.dtype).endswith(str(want[path].dtype)
                                           if name == "params" else moments)
            assert_allclose(got.float().numpy(), want[path], atol=1e-6,
                            rtol=0, err_msg=f"{name}{path}")


def test_lr_schedule_and_clipping_match_reference():
    cfg_kw = dict(lr=3e-4, warmup_steps=10, total_steps=50)
    jcfg, tcfg = ja.AdamWConfig(**cfg_kw), ta.AdamWConfig(**cfg_kw)
    for s in range(0, 60, 3):
        assert_allclose(float(ta.lr_schedule(tcfg, torch.tensor(s))),
                        float(ja.lr_schedule(jcfg, jnp.asarray(s))),
                        rtol=1e-6)
    _, grads = _opt_tree(1)
    for dtype in (np.float32, jnp.bfloat16):
        g = jax.tree.map(lambda x: jnp.asarray(x * 9.0, dtype), grads)
        jc, jn = ja.clip_by_global_norm(g, 1.0)
        tc, tn = ta.clip_by_global_norm(jax.tree.map(
            lambda x: torch.from_numpy(np.array(x, np.float32)).to(
                torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32),
            g), 1.0)
        assert_allclose(float(tn), float(jn), rtol=1e-6)
        want = _flat(jax.tree.map(lambda x: np.asarray(x, np.float32), jc))
        for path, got in _flat(tc).items():
            assert got.dtype == (torch.bfloat16 if dtype is jnp.bfloat16
                                 else torch.float32)
            assert_allclose(got.float().numpy(), want[path], atol=1e-6,
                            rtol=0, err_msg=path)


def test_compress_grads_matches_reference_bit_for_bit():
    _, grads = _opt_tree(2)
    _, err = _opt_tree(3)
    err = jax.tree.map(lambda x: x * 1e-3, err)
    jc, je = ja.compress_grads(jax.tree.map(jnp.asarray, grads),
                               jax.tree.map(jnp.asarray, err))
    tc, te = ta.compress_grads(_t(grads), _t(err))
    for jt, tt in ((jc, tc), (je, te)):
        want = _flat(jax.tree.map(lambda x: np.asarray(x, np.float32), jt))
        for path, got in _flat(tt).items():
            np.testing.assert_array_equal(got.float().numpy(), want[path])


def test_value_and_grad_steps_match_reference():
    """Three steps of the reference's smoke train step from carried
    params: losses within 1e-5, params within 1e-4 after each."""
    jc, tc, jp, tp = _pair("qwen3-1.7b")
    jstep = jsteps.value_and_grad_step(jc)
    tstep = tsteps.value_and_grad_step(tc)
    js = ja.init_state(ja.AdamWConfig(), jp)
    ts = ta.init_state(ta.AdamWConfig(), tp)
    for i in range(3):
        toks = _tokens(jc.vocab_size, 2, 24, seed=i)
        jp, js, jmet = jstep(jp, js, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(toks)})
        tp, ts, tmet = tstep(tp, ts, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(toks)})
        assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                        rtol=1e-5)
        want = _flat(jax.tree.map(np.asarray, jp))
        for path, got in _flat(tp).items():
            assert_allclose(got.numpy(), want[path], atol=1e-4, rtol=0,
                            err_msg=f"step {i} {path}")


def test_microbatched_step_matches_full_batch():
    """Gradient accumulation over 4 microbatches gives the full batch's
    update up to fp32 summation order (the reference's test and limit)."""
    _, tc, _, tp = _pair("gemma-2b", seed=0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, tc.vocab_size, (4, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    opt = ta.AdamWConfig()
    out = {}
    for nm in (1, 4):
        params = tcommon.tree_map(torch.clone, tp)
        step = tsteps.make_train_step(
            tc, opt, tsteps.StepOptions(n_microbatches=nm))
        out[nm], _, met = step(params, ta.init_state(opt, params),
                               tsteps.microbatch_split(batch, nm))
        assert torch.isfinite(met["loss"])
    err = max(float((a - b).abs().max()) for a, b in zip(
        tcommon.tree_leaves(out[4]), tcommon.tree_leaves(out[1])))
    assert err < 5e-3


def test_microbatched_train_steps_match_reference():
    """Two steps of the reference's ``make_train_step`` with 2
    microbatches (a one-device mesh) against the port's from
    carried params: losses within 1e-5, params within 1e-4 after each."""
    jc, tc, jp, tp = _pair("gemma-2b")
    shape = {k: jax.ShapeDtypeStruct((4, 16), jnp.int32)
             for k in ("tokens", "labels")}
    jstep, _, _ = jsteps.make_train_step(
        jc, ja.AdamWConfig(), jax.make_mesh((1, 1), ("data", "model")),
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jp),
        shape, jsteps.StepOptions(n_microbatches=2, zero=False,
                                  donate=False))
    tstep = tsteps.make_train_step(tc, ta.AdamWConfig(),
                                   tsteps.StepOptions(n_microbatches=2))
    js = ja.init_state(ja.AdamWConfig(), jp)
    ts = ta.init_state(ta.AdamWConfig(), tp)
    for i in range(2):
        toks = _tokens(jc.vocab_size, 4, 16, seed=10 + i)
        batch = {"tokens": toks, "labels": np.roll(toks, 1, axis=1)}
        jp, js, jmet = jstep(jp, js, jsteps.microbatch_split(
            jax.tree.map(jnp.asarray, batch), 2))
        # carried on the host: the step's outputs are typed by its mesh,
        # which the next step's embedding gather cannot resolve
        jp, js = jax.device_get((jp, js))
        tp, ts, tmet = tstep(tp, ts, tsteps.microbatch_split(
            {k: torch.from_numpy(v) for k, v in batch.items()}, 2))
        assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                        rtol=1e-5)
        want = _flat(jax.tree.map(np.asarray, jp))
        for path, got in _flat(tp).items():
            assert_allclose(got.numpy(), want[path], atol=1e-4, rtol=0,
                            err_msg=f"step {i} {path}")


def test_donate_false_leaves_the_inputs_alone():
    _, tc, _, tp = _pair("qwen3-1.7b")
    before = tcommon.tree_map(torch.clone, tp)
    opt = ta.AdamWConfig()
    state = ta.init_state(opt, tp)
    toks = torch.from_numpy(_tokens(tc.vocab_size, 2, 16))
    step = tsteps.make_train_step(tc, opt, tsteps.StepOptions(donate=False))
    new, new_state, _ = step(tp, state, {"tokens": toks, "labels": toks})
    assert all(torch.equal(a, b) for a, b in zip(
        tcommon.tree_leaves(tp), tcommon.tree_leaves(before)))
    assert int(state.step) == 0 and int(new_state.step) == 1
    assert not all(torch.equal(a, b) for a, b in zip(
        tcommon.tree_leaves(new), tcommon.tree_leaves(before)))


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2)])
def test_data_stream_matches_reference_bit_for_bit(host, n_hosts):
    kw = dict(vocab_size=512, seq_len=32, global_batch=4, seed=7)
    j = JStream(JDataConfig(**kw), host, n_hosts)
    t = SyntheticLMStream(DataConfig(**kw), host, n_hosts)
    for step in (0, 1, 17):
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


def test_data_config_fields_match_reference():
    assert ([f.name for f in dataclasses.fields(DataConfig)]
            == [f.name for f in dataclasses.fields(JDataConfig)])


def test_compressed_step_applies_the_compressed_gradients():
    """``StepOptions(compress_grads=True)``: the update AdamW makes from
    the bf16-compressed gradients, with the error feedback carried in
    the optimizer state."""
    _, tc, _, tp = _pair("qwen3-1.7b")
    toks = torch.from_numpy(_tokens(tc.vocab_size, 2, 16))
    batch = {"tokens": toks, "labels": toks}
    opt = ta.AdamWConfig()
    ref = tcommon.tree_map(torch.clone, tp)
    _, grads = tsteps.value_and_grad(ref, tc, batch)
    state = ta.init_state(opt, tp, with_error_feedback=True)
    comp, err = ta.compress_grads(grads, state.error)
    want, _, _ = ta.apply_updates(opt, ref, comp, ta.init_state(opt, ref))
    step = tsteps.make_train_step(tc, opt,
                                  tsteps.StepOptions(compress_grads=True))
    got, new_state, _ = step(tp, state, batch)
    for a, b in zip(tcommon.tree_leaves(got), tcommon.tree_leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(tcommon.tree_leaves(new_state.error),
                    tcommon.tree_leaves(err)):
        assert torch.equal(a, b)


def test_prefill_and_decode_steps_are_the_model_calls():
    _, tc, _, tp = _pair("gemma-2b")
    toks = torch.from_numpy(_tokens(tc.vocab_size, 2, 12)).long()
    cache = tm.init_cache(tc, 2, 14, device="cpu")
    logits, cache = tsteps.make_prefill_step(tc)(tp, {"tokens": toks},
                                                 cache)
    want, _ = tm.prefill(tp, tc, toks, tm.init_cache(tc, 2, 14,
                                                     device="cpu"))
    assert torch.equal(logits, want)
    token = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out, cache = tsteps.make_decode_step(tc)(tp, token, cache)
    assert out.shape == (2, 1, tc.vocab_size)
    assert cache["length"].tolist() == [13, 13]


def test_prefetch_loader_yields_the_stream_in_order():
    stream = SyntheticLMStream(DataConfig(vocab_size=64, seq_len=8,
                                          global_batch=2, seed=3))
    loader = PrefetchLoader(stream, start_step=5, prefetch=2)
    try:
        for want in range(5, 9):
            step, batch = next(loader)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          stream.batch_at(want)["tokens"])
    finally:
        loader.close()
