"""The port's train loop, checkpoints and launcher on the CPU: the
counterparts of the JAX package's loop tests (``tests/test_runtime.py``
``TestTrainLoop``) on smoke configs, the checkpoint manager's atomic
publish, retention and torn manifests, checkpoints crossing between the
two packages in both directions, and the training CLI."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.runtime.train_loop import (TrainLoopConfig,  # noqa: E402
                                            run_training)

pytestmark = pytest.mark.torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_loss_decreases_and_checkpoints(tmp_path):
    cfg = smoke_config("qwen3-1.7b")
    loop = TrainLoopConfig(total_steps=30, checkpoint_every=10)
    report = run_training(cfg, loop, tmp_path, device="cpu")
    assert report.steps_run == 30
    assert report.checkpoints == [10, 20, 30]
    assert CheckpointManager(tmp_path).all_steps() == [10, 20, 30]
    # the synthetic zipf stream is learnable: the loss must drop
    assert report.losses[-1] < report.losses[0] - 0.5


def test_crash_and_resume(tmp_path):
    """A crash at step 25; the restart resumes from the step-20
    checkpoint and completes."""
    cfg = smoke_config("qwen3-1.7b")
    loop = TrainLoopConfig(total_steps=40, checkpoint_every=10)
    with pytest.raises(RuntimeError, match="injected crash"):
        run_training(cfg, loop, tmp_path, crash_at_step=25, device="cpu")
    report = run_training(cfg, loop, tmp_path, device="cpu")
    assert report.resumed_from == 20
    assert report.steps_run == 20
    assert report.final_step == 40


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Crash and resume give the losses of a straight run: the data
    stream is a pure function of the step, and params, moments and the
    step count are restored."""
    cfg = smoke_config("rwkv6-1.6b")
    loop = TrainLoopConfig(total_steps=16, checkpoint_every=8)
    straight = run_training(cfg, loop, tmp_path / "a", device="cpu")
    with pytest.raises(RuntimeError):
        run_training(cfg, loop, tmp_path / "b", crash_at_step=12,
                     device="cpu")
    resumed = run_training(cfg, loop, tmp_path / "b", device="cpu")
    assert resumed.resumed_from == 8
    np.testing.assert_allclose(straight.losses[8:], resumed.losses,
                               rtol=1e-4)


def _tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3),
                       "b": torch.tensor([1.5, -2.25],
                                         dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoints_are_atomic_kept_and_skip_torn_manifests(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    for step in range(1, 6):
        mgr.save_async(step, _tree(), meta={"step": step})
    mgr.wait()
    assert mgr.all_steps() == [3, 4, 5]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"step_{s:010d}" for s in (3, 4, 5)]
    # a torn manifest, an incomplete one and a leftover temp dir are not
    # checkpoints
    torn = tmp_path / "step_0000000009"
    torn.mkdir()
    (torn / "manifest.json").write_text('{"step": 9, "comp')
    half = tmp_path / "step_0000000008"
    half.mkdir()
    (half / "manifest.json").write_text(json.dumps(
        {"step": 8, "paths": [], "meta": {}, "complete": False}))
    (tmp_path / ".tmp_step_0000000007").mkdir()
    assert mgr.latest_step() == 5
    step, tree = mgr.restore()
    assert step == 5 and mgr.meta(5) == {"step": 5}
    manifest = json.loads((tmp_path / "step_0000000005" /
                           "manifest.json").read_text())
    assert manifest["complete"] and manifest["paths"] == [
        "opt/step", "params/b", "params/w"]
    np.testing.assert_array_equal(tree["params"]["w"],
                                  np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))
    # bf16 is written as fp32, exactly
    assert tree["params"]["b"].dtype == np.float32
    np.testing.assert_array_equal(tree["params"]["b"], [1.5, -2.25])
    assert tree["opt"]["step"].dtype == np.int32 and tree["opt"]["step"] == 3


def test_checkpoints_cross_between_the_packages(tmp_path):
    """An fp32 checkpoint of the JAX package restores in the port, and the
    port's in the JAX package: same layout, paths and values."""
    rng = np.random.default_rng(0)
    arrays = {"params": {"embed": rng.standard_normal((4, 3))
                         .astype(np.float32),
                         "blocks": {"wq": rng.standard_normal((2, 3, 3))
                                    .astype(np.float32)}},
              "opt": {"step": np.asarray(7, np.int32)}}
    JManager(tmp_path / "j").save(20, {
        "params": {k: jnp.asarray(v) if not isinstance(v, dict)
                   else {kk: jnp.asarray(vv) for kk, vv in v.items()}
                   for k, v in arrays["params"].items()},
        "opt": {"step": jnp.asarray(arrays["opt"]["step"])}},
        meta={"arch": "x"})
    CheckpointManager(tmp_path / "t").save(20, {
        "params": {"embed": torch.from_numpy(arrays["params"]["embed"]),
                   "blocks": {"wq": torch.from_numpy(
                       arrays["params"]["blocks"]["wq"])}},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)}},
        meta={"arch": "x"})
    for writer, reader in (("j", CheckpointManager), ("t", JManager)):
        mgr = reader(tmp_path / writer)
        assert mgr.latest_step() == 20 and mgr.meta(20) == {"arch": "x"}
        step, tree = mgr.restore(20)
        for got, want in ((tree["params"]["embed"],
                           arrays["params"]["embed"]),
                          (tree["params"]["blocks"]["wq"],
                           arrays["params"]["blocks"]["wq"]),
                          (tree["opt"]["step"], arrays["opt"]["step"])):
            got = np.asarray(got)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_train_cli_runs(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --smoke --steps
    3`` trains, checkpoints and prints the reference's summary line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--device", "cpu", "--smoke", "--steps", "3",
         "--ckpt-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=300, check=True).stdout
    assert "arch=qwen3-1.7b-smoke steps_run=3 resumed_from=None" in out
    assert "checkpoints=[3]" in out


def test_train_cli_flags_are_the_reference_flags_and_device():
    parser = launch_train.build_parser()
    flags = {a.dest for a in parser._actions} - {"help"}
    assert flags == {"arch", "smoke", "steps", "batch", "seq_len",
                     "ckpt_dir", "ckpt_every", "crash_at", "device"}
