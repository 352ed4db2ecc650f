"""Fault-tolerant training loop, with the JAX package's names and
behaviour (``repro.runtime.train_loop``):

* auto-resume from the newest complete checkpoint (crash / restart);
* periodic async checkpoints (host IO overlaps the device's work);
* a straggler count: a step slower than ``straggler_factor`` x the
  median step time so far is counted;
* a crash hook for fault-tolerance tests.

The data stream is a pure function of (seed, step), so a resumed run
sees exactly the batches the uninterrupted run would have.  Params come
from the port's ``init_params(cfg, loop.seed, device)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime import steps as step_factories


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 20260305


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_step: int
    losses: list
    resumed_from: Optional[int]
    straggler_events: int
    checkpoints: list


def _restored(template, saved):
    """Each saved numpy leaf as a tensor of its template leaf's type and
    device."""
    if isinstance(template, dict):
        return {k: _restored(template[k], saved[k]) for k in template}
    return torch.as_tensor(np.asarray(saved)).to(device=template.device,
                                                 dtype=template.dtype)


def run_training(cfg: ModelConfig, loop: TrainLoopConfig, ckpt_dir,
                 data_cfg: Optional[DataConfig] = None,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 crash_at_step: Optional[int] = None,
                 step_fn: Optional[Callable] = None,
                 device=None) -> TrainReport:
    """Run (or resume) training on ``device`` (``None``: CUDA); returns a
    report for tests and examples."""
    dev = resolve_device(device)
    data_cfg = data_cfg or DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
        seed=loop.seed)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=loop.total_steps)
    mgr = CheckpointManager(ckpt_dir)
    stream = SyntheticLMStream(data_cfg)

    params = tf.init_params(cfg, loop.seed, dev)
    opt_state = adamw.init_state(opt_cfg, params)
    start_step = 0
    resumed_from = None
    latest = mgr.latest_step()
    if latest is not None:
        _, tree = mgr.restore(latest)
        params = _restored(params, tree["params"])
        opt_state = adamw.AdamWState(
            step=torch.as_tensor(tree["opt"]["step"], dtype=torch.int32,
                                 device=dev),
            mu=_restored(opt_state.mu, tree["opt"]["mu"]),
            nu=_restored(opt_state.nu, tree["opt"]["nu"]), error=None)
        start_step = latest
        resumed_from = latest

    if step_fn is None:
        step_fn = step_factories.value_and_grad_step(cfg)

    losses = []
    step_times = []
    stragglers = 0
    saved = []
    for step in range(start_step, loop.total_steps):
        if crash_at_step is not None and step == crash_at_step:
            # the crash ends this run, not the checkpoint write it started
            # on a thread: let that land first, or the restart may list the
            # directory before it does (on a card a step takes ms) while
            # the orphaned writer still races the restart's own writes
            mgr.wait()
            raise RuntimeError(f"injected crash at step {step}")
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if step_times and dt > loop.straggler_factor * float(
                np.median(step_times)):
            stragglers += 1
        step_times.append(dt)
        losses.append(loss)
        if (step + 1) % loop.checkpoint_every == 0 \
                or step + 1 == loop.total_steps:
            mgr.save_async(step + 1, {
                "params": params,
                "opt": {"step": opt_state.step, "mu": opt_state.mu,
                        "nu": opt_state.nu}},
                meta={"arch": cfg.name, "loss": loss})
            saved.append(step + 1)
    mgr.wait()
    return TrainReport(
        steps_run=loop.total_steps - start_step,
        final_step=loop.total_steps, losses=losses,
        resumed_from=resumed_from, straggler_events=stragglers,
        checkpoints=saved)


__all__ = ["TrainLoopConfig", "TrainReport", "run_training"]
