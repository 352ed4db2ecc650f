"""Coherent multi-agent serving launcher (the port's twin of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --agents 4 --artifacts 3 --steps 40 --volatility 0.1 \\
        --strategy lazy --materialize

Runs the coherence-gated serving system under the paper's SS8.1
workload and reports token and prefill-FLOPs savings against the
rebroadcast baseline.  With ``--materialize`` it builds the backbone at
its registered width (``--smoke``: the reduced smoke config) with
random weights from seed 0, prefills every agent's resident
context, and, with ``--decode-steps N``, serves one batched request:
the agents' contexts cut to a common length, prefilled together, then N
greedy decode steps.  A model with cross layers (``vlm``, ``audio``)
reads a stub context drawn from the seed: vision embeddings of the
config's image tokens, or frame embeddings of ``min(--max-len, 4096)``
frames, each agent its row.  It runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import models
from repro_torch.configs import ARCHS, get, n_active_params, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import _ctx_len
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.common import dtype_of
from repro_torch.runtime.coherent_serving import (CoherentServingSystem,
                                                  run_workload)


def build_artifacts(m: int, tokens: int) -> dict:
    return {f"artifact-{i}": list(range(1, tokens + 1)) for i in range(m)}


def stub_context(cfg: ModelConfig, batch: int, length: int, seed: int,
                 device=None) -> torch.Tensor:
    """Stub frame or vision embeddings (batch, length, d_model), N(0, 1)
    drawn in fp32 from ``seed`` on ``device`` and cast to the model
    type: the modality frontends are stubs, as in the JAX package."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return torch.randn((batch, length, cfg.d_model), generator=gen,
                       device=dev).to(dtype_of(cfg.dtype))


def batched_request(system: CoherentServingSystem, params,
                    decode_steps: int,
                    forced: Optional[torch.Tensor] = None,
                    context: Optional[torch.Tensor] = None) -> dict:
    """One batched request over every agent: the agents' contexts cut to
    their common length P, prefilled at batch n into a cache of
    P + decode_steps, then ``decode_steps`` greedy steps.  ``forced``
    (n, decode_steps) feeds the given tokens instead of the greedy ones
    (to hold another route to the same inputs).  ``context`` (n, T, d),
    the frames or vision embeddings of a model with cross layers, fills
    the cross caches (``ctx_len`` T) in the prefill.  Returns ``logits``
    (n, decode_steps + 1, V) - the prefill's last position, then each
    step's - the greedy ``tokens`` (n, decode_steps), and
    ``prompt_len``."""
    cfg, dev = system.cfg, system.device
    contexts = [system.context_tokens(i) or [1]
                for i in range(len(system.agents))]
    p = min(len(c) for c in contexts)
    tokens = torch.tensor([c[:p] for c in contexts], dtype=torch.int64,
                          device=dev)
    cache = models.init_cache(cfg, tokens.shape[0], p + decode_steps,
                              ctx_len=0 if context is None
                              else context.shape[1], device=dev)
    logits, cache = models.prefill(params, cfg, tokens, cache,
                                   context=context)
    steps = [logits]
    greedy = []
    for t in range(decode_steps):
        nxt = torch.argmax(logits[:, -1], dim=-1)
        greedy.append(nxt)
        feed = nxt if forced is None else forced[:, t]
        logits, cache = models.decode_step(params, cfg, feed[:, None],
                                           cache)
        steps.append(logits)
    return {"logits": torch.cat(steps, dim=1),
            "tokens": (torch.stack(greedy, dim=1) if greedy else
                       torch.zeros((tokens.shape[0], 0), dtype=torch.int64,
                                   device=dev)),
            "prompt_len": p}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--artifacts", type=int, default=3)
    ap.add_argument("--artifact-tokens", type=int, default=64)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--volatility", type=float, default=0.10)
    ap.add_argument("--strategy", default="lazy",
                    choices=["lazy", "eager", "access_count"])
    ap.add_argument("--volatility-sorted", action="store_true",
                    help="beyond-paper prefix layout optimization")
    ap.add_argument("--materialize", action="store_true",
                    help="run real prefills through the backbone")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config, not the registered "
                         "width")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--max-len", type=int, default=256,
                    help="cache length of each agent's prefill")
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="greedy steps of one batched request over "
                         "every agent (with --materialize)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get(args.arch)
    n_active = n_active_params(ARCHS[args.arch])
    system = CoherentServingSystem(
        cfg, args.agents,
        build_artifacts(args.artifacts, args.artifact_tokens),
        strategy=args.strategy,
        volatility_sorted=args.volatility_sorted,
        n_active_params=n_active, device=args.device)
    stats = run_workload(system, args.steps, args.volatility)
    print(f"strategy={args.strategy} sorted={args.volatility_sorted}")
    print(f"  prefill tokens:   {stats.prefill_tokens:,} vs broadcast "
          f"{stats.broadcast_tokens:,} -> "
          f"savings {stats.token_savings:.1%}")
    print(f"  prefill FLOPs:    {stats.prefill_flops:.3e} vs broadcast "
          f"{stats.broadcast_flops:.3e} -> "
          f"savings {stats.flops_savings:.1%}  "
          f"(@{n_active / 1e9:.2f}B active params)")
    print(f"  fetches={stats.fetches} cache_hits={stats.cache_hits}")
    if args.materialize:
        params = models.init_params(cfg, seed=0, device=system.device)
        context = None
        if cfg.family in ("vlm", "audio"):
            context = stub_context(cfg, args.agents,
                                   _ctx_len(cfg, args.max_len), 0,
                                   system.device)
        for i in range(args.agents):
            logits = system.materialize_prefill(
                params, i, max_len=args.max_len,
                context=None if context is None else context[i:i + 1])
            print(f"  agent {i} prefill logits: {tuple(logits.shape)} "
                  f"(finite={bool(torch.isfinite(logits).all())})")
        if args.decode_steps:
            out = batched_request(system, params, args.decode_steps,
                                  context=context)
            print(f"  batched request: {args.agents} x "
                  f"{out['prompt_len']} prompt tokens, "
                  f"{args.decode_steps} greedy steps, logits finite="
                  f"{bool(torch.isfinite(out['logits']).all())}")


if __name__ == "__main__":
    main()
