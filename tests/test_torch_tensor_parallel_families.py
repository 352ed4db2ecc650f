"""Tensor-parallel serving of the MoE, MLA, Mamba, RWKV and
encoder-decoder families (``repro_torch.runtime.tensor_parallel`` and
``steps.make_prefill_step`` / ``make_decode_step`` over a mesh) on CPU
gloo worlds, against ``repro``'s one-device ``prefill`` /
``decode_step`` and the port's one rank.

* Meshes (data 1, model 2), (1, 4) and (2, 2), on the smoke configs
  (fp32) of olmoe-1b-7b (expert parallelism, 8 experts top 4),
  deepseek-v2-lite-16b (MLA's heads, the shared experts, a dense first
  layer), jamba-1.5-large-398b (Mamba's inner channels, one attention
  layer, the MoE on odd layers), rwkv6-1.6b (the time mix's heads,
  ``ln_x`` over every head, the channel mix) and whisper-medium (the
  encoder's heads and MLP, the cross caches by heads, layernorms with
  biases), and olmoe's and deepseek's at capacity factor 1.0 in both
  packages, where the dispatch drops pairs (asserted) and every rank
  must count capacity and slot positions over the global batch, rows of
  every 'data' rank included.  Every tree is the JAX smoke init with
  every gate redrawn as N(0, 1), every norm scale as 1 + 0.3 N(0, 1),
  every bias and Mamba ``conv_b`` as 0.1 N(0, 1) and ``d_skip`` as 1 +
  0.3 N(0, 1) from a numpy seed (their inits hide a fault).
* A prefill of 4 x 12 tokens (whisper over 16 frames) and 8 greedy
  decode steps through the tensor-parallel steps: every logit within
  rtol 1e-5 / atol 1e-5 of ``repro``'s one-device run and of the port's
  one rank, the greedy tokens equal.
* Each rank's cache equal, within rtol 1e-5 and atol 1e-5 of the
  leaf's largest magnitude, to its slice of the one-rank cache: its rows, K / V heads, Mamba channels (``conv``,
  ``ssm``) and RWKV heads (``wkv``); MLA's latent (``ckv``, ``kpe``) and
  RWKV's token shifts (``tm``, ``cm``) whole.
* ``shard_params`` then ``gather_params`` bit-exact, each leaf's block
  of the shape its spec gives, or the port's layout where it differs
  (``PAIRED``, ``ROW_LEAVES``, ``WHOLE_LEAVES``).
* jamba's and rwkv6's first layer alone (Mamba; the RWKV time and
  channel mix) against the one-rank layer, and rank 0's Mamba ``w_in``
  block the x and z halves of its channels.

The reference values are computed in this process (``repro`` jitted)
and handed to the workers in files, so the workers import no JAX.  The
three worlds' workers are spawned together, once for every config, and
joined with a deadline; a worker that dies or overruns fails its
tests.  They meet through file stores under ``tmp_path``.
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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime import tensor_parallel as tpar  # noqa: E402

pytestmark = pytest.mark.torch

ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
         "rwkv6-1.6b", "whisper-medium")
#: the MoE configs again at a capacity factor that drops pairs
DROPPING = ("olmoe-1b-7b@1.0", "deepseek-v2-lite-16b@1.0")
KEYS = ARCHS + DROPPING
#: the worlds: mesh shape (data, model)
MESHES = {"model2": (1, 2), "model4": (1, 4), "data2_model2": (2, 2)}
CHECKS = ("serve", "cache", "roundtrip")
#: the configs whose first layer is also checked alone
MIXER = ("jamba-1.5-large-398b", "rwkv6-1.6b")
B, S, STEPS, FRAMES = 4, 12, 8, 16
TOL = dict(rtol=1e-5, atol=1e-5)
#: the awake draws' bias leaves
BIASES = ("bias", "bq", "bk", "bv", "bo", "b_in", "b_out", "conv_b")
#: seconds the workers of the three worlds may take together (a guard
#: against a hung collective)
DEADLINE = 150


def _configs(key):
    """(the JAX smoke config, the port's) of a key: an arch, or an arch
    at a capacity factor ("arch@cf")."""
    from repro.configs import smoke_config as j_smoke
    arch, _, cf = key.partition("@")
    jc, tc = j_smoke(arch), smoke_config(arch)
    if cf:
        jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(cf))) for c in (jc, tc))
    return jc, tc


def _port_config(key):
    arch, _, cf = key.partition("@")
    tc = smoke_config(arch)
    if cf:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=float(cf)))
    return tc


def _awake(tree, rng):
    """The numpy tree with every leaf whose init hides a fault drawn off
    it (module docstring)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _awake(v, rng)
            continue
        noise = rng.standard_normal(np.shape(v)).astype(np.float32)
        out[k] = (noise if k == "gate" else
                  (1.0 + 0.3 * noise).astype(v.dtype)
                  if k in ("scale", "d_skip") else
                  (0.1 * noise).astype(v.dtype) if k in BIASES
                  else np.asarray(v))
    return out


def _context(cfg, seed):
    if not cfg.encoder_layers:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, FRAMES, cfg.d_model)).astype(np.float32)


def _first_layer(params, cfg):
    """Layer 0's params and spec."""
    prefix, _ = ttf.split_pattern(ttf.layer_specs(cfg))
    layer = (params["prefix_0"] if prefix else
             tree_map(lambda a: a[0], params["blocks"])["sub0"])
    return layer, ttf.layer_specs(cfg)[0]


@contextlib.contextmanager
def _drops():
    """Counts the (token, choice) pairs the port's dispatch drops."""
    saved, seen = tmoe._run_experts, [0]

    def run(p, m, xt, gate, idx, pos_in_e, slice_of, n_slices, capacity,
            act):
        seen[0] += int((pos_in_e >= capacity).sum())
        return saved(p, m, xt, gate, idx, pos_in_e, slice_of, n_slices,
                     capacity, act)

    tmoe._run_experts = run
    try:
        yield seen
    finally:
        tmoe._run_experts = saved


def _reference(key) -> dict:
    """One config's tree, inputs, ``repro``'s one-device logits and
    greedy tokens, and the port's one-rank logits, tokens, cache, first
    layer output and dropped pairs."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm

    jc, tc = _configs(key)
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
    with _drops() as dropped:
        logits, tcache = tm.prefill(
            params, tc, torch.from_numpy(toks).long(), tcache,
            context=None if ctx is None else torch.from_numpy(ctx))
        port = [logits]
        for _ in range(STEPS):
            logits, tcache = tm.decode_step(
                params, tc, torch.argmax(logits[:, -1], -1)[:, None], tcache)
            port.append(logits)
    ref = {"tree": tree, "tokens": toks, "context": ctx,
           "repro_logits": np.concatenate(want, axis=1),
           "repro_tokens": np.stack(greedy, axis=1),
           "port_logits": torch.cat(port, 1).numpy(),
           "port_cache": {p: x.numpy() for p, x in
                          shd.flatten_with_paths(tcache)},
           "dropped": dropped[0]}
    if key in MIXER:
        layer, spec = _first_layer(params, tc)
        x = params["embed"][torch.from_numpy(toks).long()]
        ref["layer_in"] = x.numpy()
        ref["layer_out"] = ttf.layer_apply(
            layer, tc, spec, x, positions=torch.arange(S)[None])[0].numpy()
    return ref


# ----------------------------- the workers -----------------------------

def _rows(mesh):
    """(this rank's first row, its row count) of the B-row batch."""
    rows = tpar.local_rows(B, mesh)
    return (mesh.get_local_rank("data") * rows if rows < B else 0), rows


def _serve(cfg, ref, local, mesh):
    """The prefill and 8 greedy steps through the tensor-parallel steps:
    (logits (B, 9, V), greedy tokens (B, 8), this rank's cache)."""
    ctx = ref["context"]
    t = 0 if ctx is None else ctx.shape[1]
    cache = tpar.init_cache(cfg, B, S + STEPS, ctx_len=t, mesh=mesh,
                            device="cpu")
    batch = {"tokens": torch.from_numpy(ref["tokens"]).long()}
    if ctx is not None:
        batch["frames"] = torch.from_numpy(ctx)
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
    """Every leaf: this rank's slice of the one-rank cache (module
    docstring)."""
    g = axis_group(mesh)
    start, rows = _rows(mesh)
    hkv = tpar.local_kv_heads(cfg, g.size)
    first = (g.index * hkv if cfg.n_kv_heads >= g.size
             else g.index * cfg.n_kv_heads // g.size)
    for path, x in shd.flatten_with_paths(served[2]):
        want = torch.from_numpy(ref["port_cache"][path])
        leaf = path.rsplit("/", 1)[-1]
        want = want.narrow(1 if path.startswith("/blocks/") else 0,
                           start, rows)
        if leaf in shd.HEAD_MAJOR:            # (..., B, Hkv, L, D)
            want = want.narrow(x.ndim - 3, first, hkv)
        elif leaf in tpar.CACHE_DIMS:
            dim = tpar.CACHE_DIMS[leaf] % x.ndim
            n = want.shape[dim] // g.size
            want = want.narrow(dim, g.index * n, n)
        else:
            assert leaf in ("length", "ckv", "kpe", "tm", "cm"), path
        # atol 1e-5 of the leaf's largest magnitude: the fp32 WKV state
        # sums k v over 20 tokens (entries up to ~41), rounded otherwise
        # layer by layer where the sums over 'model' enter
        scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
        torch.testing.assert_close(x, want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale,
                                   msg=lambda m: f"{path}: {m}")


def _check_roundtrip(cfg, ref, local, mesh, served):
    """Each leaf's block has its spec's shape, or the port's layout's,
    and the gathered tree is the whole one."""
    params = tm.params_from_numpy(ref["tree"], cfg, "cpu")
    tp = axis_group(mesh).size
    whole = dict(shd.flatten_with_paths(params))
    for path, x in shd.flatten_with_paths(local):
        shape = list(shd.local_shape(shd.spec_for(path, x.ndim),
                                     tuple(whole[path].shape), {"model": tp}))
        if path.endswith(tpar.WHOLE_LEAVES):
            shape = list(whole[path].shape)
        elif path.endswith(tpar.ROW_LEAVES):
            shape = list(whole[path].shape)
            shape[-2] //= tp
        elif path.rsplit("/", 1)[-1] in tpar.HEAD_BIASES:
            shape[-1] //= tp
        if (path.rsplit("/", 1)[-1] in tpar.KV_LEAVES
                and cfg.n_kv_heads < tp):
            shape[-1] = cfg.kv_head_dim()
        assert list(x.shape) == shape, path
    back = tpar.gather_params(cfg, local, mesh)
    for (path, got), (_, want) in zip(shd.flatten_with_paths(back),
                                      shd.flatten_with_paths(params)):
        assert torch.equal(got, want), path


def _check_mixer(cfg, ref, local, mesh, served):
    """Layer 0 alone on this rank's rows: the one-rank layer's output."""
    layer, spec = _first_layer(local, cfg)
    start, rows = _rows(mesh)
    x = torch.from_numpy(ref["layer_in"])[start:start + rows]
    with tpar.using(axis_group(mesh)):
        got = ttf.layer_apply(layer, cfg, spec, x,
                              positions=torch.arange(S)[None])[0]
    torch.testing.assert_close(
        got, torch.from_numpy(ref["layer_out"])[start:start + rows], **TOL)


def _checks(key):
    return CHECKS + (("mixer",) if key in MIXER else ())


def _worker(rank, world, shape, refs, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        for key in KEYS:
            cfg = _port_config(key)
            ref = torch.load(os.path.join(refs, f"{key}.pt"),
                             weights_only=False)
            local = tpar.shard_params(
                cfg, tm.params_from_numpy(ref["tree"], cfg, "cpu"), mesh)
            served = _serve(cfg, ref, local, mesh)
            for check in _checks(key):
                try:
                    globals()[f"_check_{check}"](cfg, ref, local, mesh,
                                                 served)
                    result = "ok"
                except Exception:
                    result = traceback.format_exc()
                with open(os.path.join(out, f"{key}.{check}.{rank}"),
                          "w") as f:
                    f.write(result)
    finally:
        dist.destroy_process_group()


def _spawn(refs, tmp_factory):
    """{mesh name: {(key, check): each rank's result, "ok" or a
    traceback}}, the three worlds run at once."""
    ctx = multiprocessing.get_context("spawn")
    worlds = {}
    for name, shape in MESHES.items():
        tmp = tmp_factory.mktemp(name)
        world = shape[0] * shape[1]
        worlds[name] = (tmp, [ctx.Process(
            target=_worker, args=(r, world, shape, str(refs),
                                  str(tmp / "store"), str(tmp)))
            for r in range(world)])
    procs = [p for _, ps in worlds.values() for p in ps]
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
    for name, (tmp, ps) in worlds.items():
        results[name] = {
            (key, check): [
                (tmp / f"{key}.{check}.{r}").read_text()
                if (tmp / f"{key}.{check}.{r}").exists() else
                f"rank {r} wrote no result (exit code {p.exitcode}, "
                f"killed at the {DEADLINE} s deadline: {p in alive})"
                for r, p in enumerate(ps)]
            for key in KEYS for check in _checks(key)}
    return results


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    refs = tmp_path_factory.mktemp("refs")
    dropped = {}
    for key in KEYS:
        ref = _reference(key)
        dropped[key] = ref["dropped"]
        torch.save(ref, refs / f"{key}.pt")
    return refs, dropped


@pytest.fixture(scope="module")
def ranks(references, tmp_path_factory):
    """Every world's results."""
    return _spawn(references[0], tmp_path_factory)


def _assert_ok(results):
    for rank, result in enumerate(results):
        assert result == "ok", f"rank {rank}:\n{result}"


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_families_serve_tensor_parallel_as_one_device(ranks, mesh, arch,
                                                      check):
    _assert_ok(ranks[mesh][arch, check])


@pytest.mark.parametrize("key", DROPPING)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dropping_moe_counts_capacity_over_the_global_batch(ranks, mesh,
                                                            key):
    _assert_ok(ranks[mesh][key, "serve"])


@pytest.mark.parametrize("key", DROPPING)
def test_the_dropping_configs_drop_pairs(references, key):
    """At capacity factor 1.0 the one-rank run drops pairs (else the
    global-capacity cases above would test nothing); at the smoke
    configs' 8.0 none drop."""
    assert references[1][key] > 0
    assert references[1][key.partition("@")[0]] == 0


@pytest.mark.parametrize("arch", MIXER)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_first_layer_alone_matches_one_rank(ranks, mesh, arch):
    """jamba's Mamba layer and rwkv6's time and channel mix alone: a
    rank that norms ``ln_x`` over its own heads, or reads x and z from
    one block of ``w_in``, fails here."""
    _assert_ok(ranks[mesh][arch, "mixer"])


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


@pytest.mark.parametrize("tp", [2, 4])
def test_mamba_rank_holds_x_and_z_of_its_channels(tp):
    """Rank 0's ``w_in`` is [x_0 | z_0]: the first D / tp columns of x
    and of z, not the first 2 D / tp of [x | z]; its conv, dt and scan
    leaves and its cache states are those channels."""
    cfg = smoke_config("jamba-1.5-large-398b")
    params = ttf.init_params(cfg, 0, "cpu")
    d_inner = cfg.mamba.expand * cfg.d_model
    n = d_inner // tp
    with _fake_mesh((1, tp)) as m:
        local = tpar.shard_params(cfg, params, m)
        cache = tpar.init_cache(cfg, 2, 8, mesh=m, device="cpu")
    whole, mine = (_first_layer(t, cfg)[0]["mixer"] for t in (params, local))
    assert torch.equal(mine["w_in"], torch.cat(
        [whole["w_in"][:, :n], whole["w_in"][:, d_inner:d_inner + n]], 1))
    for leaf in ("conv_w", "w_dt"):
        assert torch.equal(mine[leaf], whole[leaf][:, :n])
    for leaf in ("conv_b", "dt_bias", "d_skip", "a_log", "w_x_dbc"):
        assert torch.equal(mine[leaf], whole[leaf][:n])
    assert torch.equal(mine["w_out"], whole["w_out"][:n])
    state = _first_layer(cache, cfg)[0]
    assert tuple(state["conv"].shape) == (2, cfg.mamba.d_conv - 1, n)
    assert tuple(state["ssm"].shape) == (2, n, cfg.mamba.d_state)
