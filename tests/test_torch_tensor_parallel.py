"""Tensor-parallel serving (``repro_torch.runtime.tensor_parallel`` and
``steps.make_prefill_step`` / ``make_decode_step`` over a mesh) on CPU
gloo worlds, against ``repro``'s one-device ``prefill`` / ``decode_step``
and the port's one rank.

* Meshes (data 1, model 2), (1, 4) and (2, 2), on the smoke configs
  (fp32) of gemma-2b (one K / V head, held by every rank), qwen3-1.7b
  (qk-norm; two K / V heads, each held by two ranks at tp 4),
  command-r-35b (layernorm, tied head) and llama-3.2-vision-90b (cross
  layers over 16 image tokens).  Every tree is the JAX smoke init with
  every cross ``gate`` redrawn as N(0, 1) and every norm scale as
  1 + 0.3 N(0, 1) from a numpy seed (at the reference's init the gates
  are 0 and hide the cross path).
* A prefill of 4 x 12 tokens and 8 greedy decode steps through the
  tensor-parallel steps: every logit within rtol 1e-5 / atol 1e-5 of
  ``repro``'s one-device run and of the port's one rank (the fp32 sums
  over 'model' round in another order), the greedy tokens equal.
* Each rank's cache equal, within the same tolerance, to its rows and
  K / V heads of the one-rank cache.
* ``shard_params`` then ``gather_params`` bit-exact, each leaf's block
  of the shape its spec gives (K / V heads fewer than ranks: one head).
* On one rank (no mesh, or 'model' 1) the steps are the one-device
  steps, bit for bit; training under a 'model' group raises
  ``NotImplementedError`` naming ROADMAP item 9c, head counts that do
  not split ``ValueError``.  The other families' tensor-parallel
  serving is in ``tests/test_torch_tensor_parallel_families.py``.

The reference values are computed in this process (``repro`` jitted)
and handed to the workers in files, so the workers import no JAX.  Each
world's workers are spawned once for every config and joined with a
deadline; a worker that dies or overruns fails its tests.  They meet
through a file store under ``tmp_path``.
"""

import contextlib
import dataclasses
import multiprocessing
import os
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import axis_group  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime import tensor_parallel as tpar  # noqa: E402

pytestmark = pytest.mark.torch

ARCHS = ("gemma-2b", "qwen3-1.7b", "command-r-35b", "llama-3.2-vision-90b")
#: the worlds: mesh shape (data, model)
MESHES = {"model2": (1, 2), "model4": (1, 4), "data2_model2": (2, 2)}
CHECKS = ("serve", "cache", "roundtrip")
B, S, STEPS = 4, 12, 8
TOL = dict(rtol=1e-5, atol=1e-5)
#: seconds the workers of one world may take together (a guard against
#: a hung collective: a world takes ~10 s alone)
DEADLINE = 120


def _awake(tree, rng):
    """The numpy tree with every gate and norm scale drawn off its
    init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _awake(v, rng)
            continue
        noise = rng.standard_normal(np.shape(v)).astype(np.float32)
        out[k] = (noise if k == "gate" else
                  (1.0 + 0.3 * noise).astype(v.dtype) if k == "scale"
                  else np.asarray(v))
    return out


def _context(cfg, seed):
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.vision.n_image_tokens, cfg.d_model)).astype(np.float32)


def _reference(arch) -> dict:
    """One config's tree, inputs, ``repro``'s one-device logits and
    greedy tokens, and the port's one-rank logits, tokens and cache."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.configs import smoke_config as j_smoke

    jc, tc = j_smoke(arch), smoke_config(arch)
    tree = _awake(jax.tree.map(np.asarray,
                               jm.init_params(jc, jax.random.PRNGKey(1))),
                  np.random.default_rng(7))
    toks = np.random.default_rng(3).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32)
    ctx = _context(jc, 5)
    t = 0 if ctx is None else ctx.shape[1]

    prefill = jax.jit(jm.prefill, static_argnums=1)
    decode = jax.jit(jm.decode_step, static_argnums=1)
    jp = jax.tree.map(jnp.asarray, tree)
    logits, cache = prefill(jp, jc, jnp.asarray(toks),
                            jm.init_cache(jc, B, S + STEPS, ctx_len=t),
                            None if ctx is None else jnp.asarray(ctx))
    want, greedy = [np.asarray(logits)], []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        greedy.append(np.asarray(nxt))
        logits, cache = decode(jp, jc, nxt[:, None], cache)
        want.append(np.asarray(logits))

    params = tm.params_from_numpy(tree, tc, "cpu")
    tcache = tm.init_cache(tc, B, S + STEPS, ctx_len=t, device="cpu")
    logits, tcache = tm.prefill(
        params, tc, torch.from_numpy(toks).long(), tcache,
        context=None if ctx is None else torch.from_numpy(ctx))
    port = [logits]
    for _ in range(STEPS):
        logits, tcache = tm.decode_step(
            params, tc, torch.argmax(logits[:, -1], -1)[:, None], tcache)
        port.append(logits)
    return {"tree": tree, "tokens": toks, "context": ctx,
            "repro_logits": np.concatenate(want, axis=1),
            "repro_tokens": np.stack(greedy, axis=1),
            "port_logits": torch.cat(port, 1).numpy(),
            "port_cache": {p: x.numpy() for p, x in
                           shd.flatten_with_paths(tcache)}}


# ----------------------------- the workers -----------------------------

def _serve(cfg, ref, local, mesh):
    """The prefill and 8 greedy steps through the tensor-parallel steps:
    (logits (B, 9, V), greedy tokens (B, 8), this rank's cache)."""
    ctx = ref["context"]
    t = 0 if ctx is None else ctx.shape[1]
    cache = tpar.init_cache(cfg, B, S + STEPS, ctx_len=t, mesh=mesh,
                            device="cpu")
    batch = {"tokens": torch.from_numpy(ref["tokens"]).long()}
    if ctx is not None:
        batch["vision_embeds"] = torch.from_numpy(ctx)
    logits, cache = steps.make_prefill_step(cfg, mesh)(local, batch, cache)
    decode = steps.make_decode_step(cfg, mesh)
    out, greedy = [logits], []
    for _ in range(STEPS):
        nxt = torch.argmax(logits[:, -1], -1)
        greedy.append(nxt)
        logits, cache = decode(local, nxt[:, None], cache)
        out.append(logits)
    return torch.cat(out, 1), torch.stack(greedy, 1), cache


def _check_serve(cfg, ref, local, mesh, served):
    got, greedy, _ = served
    assert tuple(got.shape) == ref["port_logits"].shape
    np.testing.assert_array_equal(greedy.numpy(), ref["repro_tokens"])
    torch.testing.assert_close(got, torch.from_numpy(ref["repro_logits"]),
                               **TOL)
    torch.testing.assert_close(got, torch.from_numpy(ref["port_logits"]),
                               **TOL)


def _check_cache(cfg, ref, local, mesh, served):
    """Every leaf: this rank's rows, and K / V heads, of the one-rank
    cache."""
    cache = served[2]
    g = axis_group(mesh)
    rows = tpar.local_rows(B, mesh)
    start = mesh.get_local_rank("data") * rows if rows < B else 0
    hkv = tpar.local_kv_heads(cfg, g.size)
    first = (g.index * hkv if cfg.n_kv_heads >= g.size
             else g.index * cfg.n_kv_heads // g.size)
    for path, x in shd.flatten_with_paths(cache):
        want = torch.from_numpy(ref["port_cache"][path])
        if path.endswith("/length"):
            want = want[start:start + rows]
        else:                       # (..., B, Hkv, L, D)
            want = want.narrow(x.ndim - 4, start, rows).narrow(
                x.ndim - 3, first, hkv)
        torch.testing.assert_close(x, want, **TOL, msg=lambda m: f"{path}: {m}")


def _check_roundtrip(cfg, ref, local, mesh, served):
    """Each leaf's block has its spec's shape (one head where K / V heads
    are fewer than the ranks), and the gathered tree is the whole one."""
    params = tm.params_from_numpy(ref["tree"], cfg, "cpu")
    tp = axis_group(mesh).size
    whole = dict(shd.flatten_with_paths(params))
    for path, x in shd.flatten_with_paths(local):
        shape = list(shd.local_shape(shd.spec_for(path, x.ndim),
                                     tuple(whole[path].shape), {"model": tp}))
        if path.rsplit("/", 1)[-1] in ("wk", "wv") and cfg.n_kv_heads < tp:
            shape[-1] = cfg.kv_head_dim()
        assert list(x.shape) == shape, path
    back = tpar.gather_params(cfg, local, mesh)
    for (path, got), (_, want) in zip(shd.flatten_with_paths(back),
                                      shd.flatten_with_paths(params)):
        assert torch.equal(got, want), path


def _worker(rank, world, shape, refs, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        for arch in ARCHS:
            cfg = smoke_config(arch)
            ref = torch.load(os.path.join(refs, f"{arch}.pt"),
                             weights_only=False)
            local = tpar.shard_params(
                cfg, tm.params_from_numpy(ref["tree"], cfg, "cpu"), mesh)
            served = _serve(cfg, ref, local, mesh)
            for check in CHECKS:
                try:
                    globals()[f"_check_{check}"](cfg, ref, local, mesh,
                                                 served)
                    result = "ok"
                except Exception:
                    result = traceback.format_exc()
                with open(os.path.join(out, f"{arch}.{check}.{rank}"),
                          "w") as f:
                    f.write(result)
    finally:
        dist.destroy_process_group()


def _spawn(shape, refs, tmp):
    """{(arch, check): each rank's result, "ok" or a traceback}."""
    world = shape[0] * shape[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, shape, str(refs),
                               str(tmp / "store"), str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    results = {}
    for arch in ARCHS:
        for check in CHECKS:
            results[arch, check] = [
                (tmp / f"{arch}.{check}.{r}").read_text()
                if (tmp / f"{arch}.{check}.{r}").exists() else
                f"rank {r} wrote no result (exit code {p.exitcode}, killed "
                f"at the {DEADLINE} s deadline: {p in alive})"
                for r, p in enumerate(procs)]
    return results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every world's results, the references computed once."""
    refs = tmp_path_factory.mktemp("refs")
    for arch in ARCHS:
        torch.save(_reference(arch), refs / f"{arch}.pt")
    return {name: _spawn(shape, refs, tmp_path_factory.mktemp(name))
            for name, shape in MESHES.items()}


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tensor_parallel_serving_matches_one_device(ranks, mesh, arch,
                                                    check):
    for rank, result in enumerate(ranks[mesh][arch, check]):
        assert result == "ok", f"rank {rank}:\n{result}"


# ------------------------------ one process ------------------------------

@contextlib.contextmanager
def _fake_mesh(shape):
    """A (data, model) mesh over PyTorch's fake process group: rank 0 of
    ``prod(shape)``, no collective run."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    try:
        yield init_device_mesh("cpu", shape,
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _smoke_inputs(cfg):
    g = torch.Generator().manual_seed(2)
    params = ttf.init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
    ctx = (None if cfg.family != "vlm" else
           torch.randn((2, cfg.vision.n_image_tokens, cfg.d_model),
                       generator=g))
    return params, toks, ctx


def _one_device_run(cfg, prefill, decode, cache_of):
    params, toks, ctx = _smoke_inputs(cfg)
    t = 0 if ctx is None else ctx.shape[1]
    batch = {"tokens": toks}
    if ctx is not None:
        batch["vision_embeds"] = ctx
    logits, cache = prefill(params, batch, cache_of(t))
    out = [logits]
    for _ in range(3):
        logits, cache = decode(params, torch.argmax(logits[:, -1], -1)[
            :, None], cache)
        out.append(logits)
    return torch.cat(out, 1)


@pytest.mark.parametrize("arch", ["gemma-2b", "llama-3.2-vision-90b"])
@pytest.mark.parametrize("mesh", ["none", "model1"])
def test_one_rank_steps_are_the_one_device_steps(arch, mesh):
    cfg = smoke_config(arch)

    def cache_of(m):
        return lambda t: tpar.init_cache(cfg, 2, 12, ctx_len=t, mesh=m,
                                         device="cpu")

    want = _one_device_run(
        cfg, lambda p, b, c: ttf.prefill(p, cfg, b["tokens"], c,
                                         context=b.get("vision_embeds")),
        lambda p, t, c: ttf.decode_step(p, cfg, t, c), cache_of(None))
    if mesh == "none":
        got = _one_device_run(cfg, steps.make_prefill_step(cfg),
                              steps.make_decode_step(cfg), cache_of(None))
    else:
        with _fake_mesh((1, 1)) as m:
            got = _one_device_run(cfg, steps.make_prefill_step(cfg, m),
                                  steps.make_decode_step(cfg, m),
                                  cache_of(m))
    assert torch.equal(got, want)


def test_training_under_a_model_group_raises():
    cfg = smoke_config("qwen3-1.7b")
    params = ttf.init_params(cfg, 0, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with _fake_mesh((1, 2)) as m:
        with pytest.raises(NotImplementedError, match="tensor parallel"):
            steps.make_train_step(cfg, adamw.AdamWConfig(), mesh=m)
        with tpar.using(axis_group(m)), \
                pytest.raises(NotImplementedError, match="item 9c"):
            ttf.forward_train(params, cfg, {"tokens": toks, "labels": toks})


@pytest.mark.parametrize("heads,kv,tp", [(4, 3, 2), (6, 2, 4), (4, 2, 8)])
def test_head_counts_that_do_not_split_raise(heads, kv, tp):
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), n_heads=heads,
                              n_kv_heads=kv)
    with pytest.raises(ValueError, match="do not split"):
        tpar.local_kv_heads(cfg, tp)


@pytest.mark.parametrize("arch,kv_heads", [("gemma-2b", 1),
                                           ("qwen3-1.7b", 1),
                                           ("llama-3.2-vision-90b", 1)])
def test_rank_blocks_follow_the_heads(arch, kv_heads):
    """Rank 0 of (1, 2): the first half of the q heads and of the FFN's
    hidden dim and vocab rows, and the K / V heads those q heads read."""
    cfg = smoke_config(arch)
    params = ttf.init_params(cfg, 0, "cpu")
    hd = cfg.kv_head_dim()
    with _fake_mesh((1, 2)) as m:
        local = tpar.shard_params(cfg, params, m)
        cache = tpar.init_cache(cfg, 4, 8, mesh=m, device="cpu")
    layer = lambda tree: tree_map(lambda a: a[0], tree["blocks"])["sub0"]  # noqa: E731
    whole, mine = layer(params), layer(local)
    q_cols = cfg.n_heads // 2 * hd
    assert torch.equal(mine["mixer"]["wq"], whole["mixer"]["wq"][:, :q_cols])
    assert torch.equal(mine["mixer"]["wo"], whole["mixer"]["wo"][:q_cols])
    assert torch.equal(mine["mixer"]["wk"],
                       whole["mixer"]["wk"][:, :kv_heads * hd])
    half = cfg.d_ff // 2
    assert torch.equal(mine["ffn"]["w_down"], whole["ffn"]["w_down"][:half])
    assert torch.equal(local["embed"],
                       params["embed"][:cfg.vocab_size // 2])
    assert torch.equal(local["final_norm"]["scale"],
                       params["final_norm"]["scale"])
    k = layer(cache)["k"]
    assert tuple(k.shape[-4:]) == (4, kv_heads, 8, hd)
