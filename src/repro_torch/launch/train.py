"""Training launcher of the port, with the JAX package's flags
(``repro.launch.train``) plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu

``--smoke`` swaps in the reduced same-family config; without it the
registered config is used.  ``--device`` defaults to CUDA (dense models
train through the attention and RMSNorm backward kernels there; rwkv6
trains on the CPU only for now).  The loop auto-resumes from the newest
checkpoint in ``--ckpt-dir``, so running again after a crash continues
where it stopped (``--crash-at N`` injects one).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, get, smoke_config
from repro_torch.data import DataConfig
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--ckpt-dir", default="build/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a crash at this step (fault tolerance)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get(args.arch)
    loop = TrainLoopConfig(total_steps=args.steps,
                           checkpoint_every=args.ckpt_every)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch)
    report = run_training(cfg, loop, args.ckpt_dir, data_cfg=data,
                          crash_at_step=args.crash_at, device=args.device)
    print(f"arch={cfg.name} steps_run={report.steps_run} "
          f"resumed_from={report.resumed_from} "
          f"first_loss={report.losses[0]:.4f} "
          f"last_loss={report.losses[-1]:.4f} "
          f"checkpoints={report.checkpoints}")


if __name__ == "__main__":
    main()
