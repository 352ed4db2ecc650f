"""The port's train step with ``StepOptions.zero`` / ``fsdp``
(``repro_torch.runtime.steps``) on one rank and data-parallel over CPU
gloo worlds of 2 and 4 processes.

* One rank (no mesh, or a one-rank mesh over the fake process group):
  the step is the one-device step whatever the options, so two steps
  with ``zero`` and/or ``fsdp`` are ``torch.equal`` to two with
  ``zero=False`` on every param and moment leaf.
* Data-parallel, qwen3-1.7b's smoke config in fp32, a batch of 4
  sequences of 16 tokens, 2 steps: on the mesh (data 2, model 1) under
  ``zero``, ``fsdp``, both, and both over 2 pre-split microbatches
  without donation; on (pod 2, data 2, model 1) under both.  The
  gathered params and moments and the loss equal the one-rank step on
  the whole batch (with as many microbatches) within rtol 1e-5 / atol
  1e-6: the gradients are summed in another order.  Each rank's param
  and moment shards have the shapes their specs give; under ``zero`` a
  rank's moment bytes are its shards', not the whole tree's; without
  donation the caller's pieces are left as they were.  AdamW is the
  reference's default (lr 3e-4 after 100 warmup steps, so 3e-6 and 6e-6
  here): an element whose gradient lies near ``eps`` moves by a share
  of lr that the gradient's last bits decide, so the two summation
  orders can part there by up to lr.
* A mesh whose 'model' axis is above 1 (tensor parallelism) raises
  ``NotImplementedError``.

Each world's workers are spawned once for all its option sets and
joined with a deadline; a worker that dies or overruns fails the tests.
They meet through a file store under ``tmp_path``, so parallel test
workers never share a port.
"""

import contextlib
import math
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

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, mesh_axes  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

pytestmark = pytest.mark.torch

ARCH, B, S, N_STEPS = "qwen3-1.7b", 4, 16, 2
TOL = dict(rtol=1e-5, atol=1e-6)
OPTIONS = {"zero": dict(zero=True, fsdp=False),
           "fsdp": dict(zero=False, fsdp=True),
           "both": dict(zero=True, fsdp=True)}
#: seconds the workers of one run may take together
DEADLINE = 40


def _setup():
    cfg = smoke_config(ARCH)
    opt_cfg = adamw.AdamWConfig()
    params = ttf.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    return cfg, opt_cfg, params, batch


def _run(step, params, state, batch):
    for _ in range(N_STEPS):
        params, state, metrics = step(params, state, batch)
    return params, state, metrics["loss"]


def _one_rank(options=steps.StepOptions(zero=False), mesh=None,
              microbatches=1):
    cfg, opt_cfg, params, batch = _setup()
    state = adamw.init_state(opt_cfg, params)
    return _run(steps.make_train_step(cfg, opt_cfg, options, mesh=mesh),
                params, state, steps.microbatch_split(batch, microbatches))


def _leaves(params, state):
    return (list(shd.flatten_with_paths(params))
            + list(shd.flatten_with_paths(state.mu))
            + list(shd.flatten_with_paths(state.nu)))


@contextlib.contextmanager
def _fake_world(n):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", ["none", "one_rank"])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_one_rank_step_is_the_one_device_step(name, mesh):
    want = _one_rank()
    options = steps.StepOptions(**OPTIONS[name])
    if mesh == "none":
        got = _one_rank(options)
    else:
        with _fake_world(1):
            got = _one_rank(options, make_host_mesh(device="cpu"))
    for (path, g), (_, w) in zip(_leaves(*got[:2]), _leaves(*want[:2])):
        assert torch.equal(g, w), path
    assert torch.equal(got[2], want[2])


def test_tensor_parallel_mesh_is_not_ported():
    cfg, opt_cfg, _, _ = _setup()
    with _fake_world(2):
        m = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
        with pytest.raises(NotImplementedError, match="tensor parallel"):
            steps.make_train_step(cfg, opt_cfg, mesh=m)


# --------------------------- two and four ranks ---------------------------

#: the data-parallel runs: (world, mesh shape, axis names, option sets);
#: "micro" is fsdp under zero over 2 pre-split microbatches without
#: donation, "pod" the same options over (pod 2, data 2)
RUNS = {
    "data2": (2, (2, 1), ("data", "model"),
              {**OPTIONS, "micro": dict(zero=True, fsdp=True,
                                        n_microbatches=2, donate=False)}),
    "pod2_data2": (4, (2, 2, 1), ("pod", "data", "model"),
                   {"pod": dict(zero=True, fsdp=True)}),
}


def _nbytes(tree):
    return sum(x.numel() * x.element_size()
               for _, x in shd.flatten_with_paths(tree))


def _check(kwargs, want, mesh):
    """One option set on this rank: shard shapes, moment bytes, the
    caller's trees left alone without donation, and the gathered state
    and loss against the one-rank run ``want``."""
    cfg, opt_cfg, params, batch = _setup()
    options = steps.StepOptions(**kwargs)
    batch = steps.microbatch_split(batch, options.n_microbatches)
    state = adamw.init_state(opt_cfg, params)
    local = steps.shard_train_state(cfg, params, state, mesh, options)
    kept = [x.clone() for _, x in _leaves(*local)]
    step = steps.make_train_step(cfg, opt_cfg, options, mesh=mesh)
    lp, ls, loss = _run(step, *local, batch)
    if not options.donate:
        assert all(torch.equal(x, k) for (_, x), k in
                   zip(_leaves(*local), kept))
    axes = mesh_axes(mesh)
    shape = dict(shd.flatten_with_paths(ttf.init_params(cfg,
                                                        device="meta")))
    meta = ttf.init_params(cfg, device="meta")
    pspecs = dict(shd.flatten_with_paths(
        shd.fsdp_param_specs(meta, axes) if options.fsdp
        else shd.param_specs(meta)))
    mspecs = dict(shd.flatten_with_paths(
        shd.opt_state_specs(meta, axes, options.zero)))
    for tree, specs in ((lp, pspecs), (ls.mu, mspecs), (ls.nu, mspecs)):
        for path, x in shd.flatten_with_paths(tree):
            assert tuple(x.shape) == shd.local_shape(
                specs[path], tuple(shape[path].shape), axes), path
    if options.zero:
        shard_bytes = sum(
            math.prod(shd.local_shape(mspecs[p], tuple(x.shape), axes)) * 4
            for p, x in shape.items())
        assert _nbytes(ls.mu) == _nbytes(ls.nu) == shard_bytes
        assert 2 * shard_bytes < 1.1 * _nbytes(want[1].mu)
    gp, gs = steps.gather_train_state(cfg, lp, ls, mesh, options)
    for (path, g), (_, w) in zip(_leaves(gp, gs), _leaves(*want[:2])):
        torch.testing.assert_close(g, w, **TOL,
                                   msg=lambda m: f"{path}: {m}")
    torch.testing.assert_close(loss, want[2], **TOL)


def _worker(rank, run, store, out):
    world, shape, names, sets = RUNS[run]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        want = {nm: _one_rank(steps.StepOptions(
            zero=False, n_microbatches=nm), microbatches=nm)
            for nm in {kw.get("n_microbatches", 1) for kw in sets.values()}}
        for name, kwargs in sets.items():
            try:
                _check(kwargs, want[kwargs.get("n_microbatches", 1)], mesh)
                result = "ok"
            except Exception:
                result = traceback.format_exc()
            with open(os.path.join(out, f"{name}.{rank}"), "w") as f:
                f.write(result)
    finally:
        dist.destroy_process_group()


def _spawn(run, tmp):
    """{option set: each rank's result, "ok" or a traceback}."""
    world, _, _, sets = RUNS[run]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, run, str(tmp / "store"), str(tmp)))
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
    for name in sets:
        results[name] = []
        for r, p in enumerate(procs):
            path = tmp / f"{name}.{r}"
            results[name].append(
                path.read_text() if path.exists() else
                f"rank {r} wrote no result (exit code {p.exitcode}, "
                f"killed at the {DEADLINE} s deadline: {p in alive})")
    return results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both runs, spawned one after the other, each with its store."""
    return {run: _spawn(run, tmp_path_factory.mktemp(run)) for run in RUNS}


@pytest.mark.parametrize("run,name", [(run, name) for run in RUNS
                                      for name in RUNS[run][3]])
def test_data_parallel_step_matches_one_rank(ranks, run, name):
    for rank, result in enumerate(ranks[run][name]):
        assert result == "ok", f"rank {rank}:\n{result}"
