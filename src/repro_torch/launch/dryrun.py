"""Pod dry-run: every (arch x shape x mesh) cell on the reference's
production meshes, from shapes alone.

The JAX package lowers and compiles each cell's step against 256 or 512
placeholder devices (``repro.launch.dryrun``).  The port compiles no
program, so for each cell it builds:

  1. meta-device stand-ins (no allocation) for params
     (``init_params(device="meta")``), the batch (``input_specs``) and
     the cache (``init_cache(device="meta")``);
  2. each rank's bytes of params, gradients, moments, batch and cache
     under the sharding rules (``runtime.sharding``) and the cell's step
     options (:func:`cell_options`), and whether they fit the card's
     80 GB (activations are not counted);
  3. the analytic cost (``launch.analytic``) at the mesh's chips and
     tensor-parallel degree, and a ``RooflineReport`` on the H100's
     rates, whose ``hlo_raw`` holds the FLOPs ``torch.utils.
     flop_counter`` counts in one call of the whole step (every rank's
     batch; a train step's microbatches as one microbatch's count times
     their number) on the meta stand-ins, where the family's step runs
     on meta: not MoE (data-dependent dispatch shapes) and not a Mamba
     or RWKV prompt (the plain scans step through time on the host).

There is no collective term: no program, so the collective bytes stay an
empty ``CollectiveStats``, and the note says so.  The specs' 'model'
entries are what the port's tensor-parallel serving steps hold
(``runtime.tensor_parallel``: head projections, the FFN's hidden dim,
vocab rows, K / V caches by head), except where a model has fewer K / V
heads than 'model' ranks: the port holds each rank's one whole head
where the specs split a head's channels (and the cache's time axis).
Training over 'model' > 1 is not ported; the dry-run counts its bytes
from the specs all the same.  Results go to ``build/dryrun_torch.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import (ARCHS, SHAPES, get, input_specs,
                                 n_active_params, n_params_analytic,
                                 shapes_for)
from repro_torch.configs.registry import _dec_len
from repro_torch.launch import analytic as an
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     POD_AXES, POD_SHAPE, mesh_axes)
from repro_torch.models import transformer as tf
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as step_factories

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_torch.json"
#: device memory of one H100 80GB, bytes
CARD_BYTES = 80e9
#: the production meshes by name, as ``{axis: size}``
MESHES = {"pod16x16": dict(zip(POD_AXES, POD_SHAPE)),
          "pod2x16x16": dict(zip(MULTI_POD_AXES, MULTI_POD_SHAPE))}
NOTE = ("no compiled program: collective bytes not measured "
        "(empty CollectiveStats); 'model' entries as the port's "
        "tensor-parallel serving holds them, but K/V heads fewer than "
        "'model' held whole; training over 'model' > 1 not ported")


def _moment_dtype(cfg) -> str:
    return ("bfloat16" if n_params_analytic(cfg) > 6e10 else "float32")


def cell_options(cfg, shape_cfg, mesh) -> step_factories.StepOptions:
    """Production memory policy per cell (recorded in the results):

    * FSDP when TP-sharded weights alone exceed ~8 GB/chip (jamba-398b,
      llama-3.2-vision-90b);
    * gradient-accumulation microbatches sized so remat boundary
      activations (B_loc x S x d x 2 x L) stay under ~4 GB/chip.
    """
    axes = mesh_axes(mesh)
    tp = axes.get("model", 1)
    dp = 1
    for a in ("pod", "data"):
        dp *= axes.get(a, 1)
    w_per_chip = n_params_analytic(cfg) * 2 / tp
    fsdp = w_per_chip > 8e9
    n_micro = 1
    if shape_cfg.kind == "train":
        b_loc = max(shape_cfg.global_batch // dp, 1)
        boundary = (b_loc * _dec_len(cfg, shape_cfg.seq_len)
                    * cfg.d_model * 2 * cfg.n_layers)
        while boundary / n_micro > 4e9 and n_micro < b_loc:
            n_micro *= 2
    return step_factories.StepOptions(fsdp=fsdp, n_microbatches=n_micro)


def _adapt_moe_dispatch(cfg, mesh):
    """Production MoE dispatch: one slice per DP shard."""
    if cfg.moe is None or cfg.moe.dispatch_slices != 1:
        return cfg
    axes = mesh_axes(mesh)
    dp_names = tuple(a for a in ("pod", "data") if a in axes)
    dp = 1
    for a in dp_names:
        dp *= axes[a]
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_slices=dp, dispatch_axes=dp_names))


def _reduced_cfg(cfg, n_blocks: int):
    """Config with n_blocks superblocks (for scan-body extrapolation)."""
    specs = tf.layer_specs(cfg)
    prefix, period = tf.split_pattern(specs)
    over = dict(n_layers=prefix + n_blocks * period)
    if cfg.encoder_layers:
        over["encoder_layers"] = n_blocks
    return dataclasses.replace(cfg, **over)


def _prefill_ctx_len(cfg, shape_cfg) -> int:
    """A prefill's cross-cache length, as the reference's dry-run sizes
    it."""
    if cfg.family == "vlm":
        return cfg.vision.n_image_tokens
    if cfg.family == "audio":
        return shape_cfg.seq_len
    return 0


def _meta_blocker(cfg, shape_cfg):
    """Why the cell's step is not run on meta, or None."""
    if cfg.moe is not None:
        return ("MoE dispatch has data-dependent shapes (torch.nonzero), "
                "which meta tensors cannot give")
    recurrent = cfg.mamba is not None or cfg.rwkv is not None
    if recurrent and shape_cfg.kind != "decode":
        steps = _dec_len(cfg, shape_cfg.seq_len)
        return (f"the plain {'selective' if cfg.mamba else 'WKV'} scan "
                f"steps through time on the host ({steps} steps a layer)")
    return None


def _stand_ins(cfg, shape_cfg, options):
    """Meta params, the batch (train: pre-split into the options'
    microbatches) and the cache (None for train)."""
    params = tf.init_params(cfg, device="meta")
    specs = input_specs(cfg, shape_cfg)
    if shape_cfg.kind == "decode":
        return params, {"token": specs["token"]}, specs["cache"]
    if shape_cfg.kind == "prefill":
        cache = tf.init_cache(cfg, shape_cfg.global_batch,
                              specs["tokens"].shape[1],
                              ctx_len=_prefill_ctx_len(cfg, shape_cfg),
                              device="meta")
        return params, specs, cache
    nm = options.n_microbatches
    if nm > 1:
        specs = {k: torch.empty((nm, v.shape[0] // nm) + tuple(v.shape[1:]),
                                dtype=v.dtype, device="meta")
                 for k, v in specs.items()}
    return params, specs, None


def _bytes(tree, specs, axes, dtype=None) -> int:
    """One rank's bytes of ``tree``'s leaves under ``specs`` (each leaf
    in ``dtype`` when given)."""
    flat = dict(shd.flatten_with_paths(specs))
    total = 0
    for path, x in shd.flatten_with_paths(tree):
        size = dtype.itemsize if dtype else x.element_size()
        total += math.prod(shd.local_shape(flat[path], tuple(x.shape),
                                           axes)) * size
    return total


def rank_bytes(cfg, shape_cfg, axes, options, params, batch, cache) -> dict:
    """Each rank's bytes of the cell's state, by part."""
    p_specs = (shd.fsdp_param_specs(params, axes) if options.fsdp
               else shd.param_specs(params))
    out = {"params": _bytes(params, p_specs, axes)}
    if shape_cfg.kind == "train":
        out["gradients"] = out["params"]
        moment = getattr(torch, _moment_dtype(cfg))
        o_specs = shd.opt_state_specs(params, axes, zero=options.zero)
        out["moments"] = 2 * _bytes(params, o_specs, axes, moment)
    out["batch"] = _bytes(batch, shd.batch_specs(
        batch, axes, 0 if options.n_microbatches <= 1 else 1), axes)
    if cache is not None:
        out["cache"] = _bytes(cache, shd.cache_specs(cache, cfg, axes),
                              axes)
    out["total_bytes_per_device"] = sum(out.values())
    out["fits_80gb"] = out["total_bytes_per_device"] <= CARD_BYTES
    return out


def _flops(cfg, shape_cfg, params, batch, cache) -> dict:
    """The FLOP counter's count of one call of the cell's step; a train
    step in microbatches counts one microbatch's loss and gradients
    times their number (each runs the same products)."""
    if shape_cfg.kind == "decode":
        return rf.cost_analysis_dict(step_factories.make_decode_step(cfg),
                                     params, batch["token"], cache)
    if shape_cfg.kind == "prefill":
        return rf.cost_analysis_dict(step_factories.make_prefill_step(cfg),
                                     params, batch, cache)
    if batch["tokens"].dim() == 2:
        return rf.cost_analysis_dict(step_factories.value_and_grad, params,
                                     cfg, batch)
    nm = batch["tokens"].shape[0]
    one = rf.cost_analysis_dict(step_factories.value_and_grad, params, cfg,
                                {k: v[0] for k, v in batch.items()})
    return {k: v * nm for k, v in one.items()}


def dry_run_cell(arch: str, shape_name: str, multi_pod: bool,
                 verbose: bool = True) -> dict:
    """One cell's report, with its options and per-rank bytes."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    axes = MESHES[mesh_name]
    n_chips = math.prod(axes.values())
    shape_cfg = SHAPES[shape_name]
    cfg = _adapt_moe_dispatch(get(arch), axes)
    t0 = time.time()
    options = cell_options(cfg, shape_cfg, axes)
    params, batch, cache = _stand_ins(cfg, shape_cfg, options)
    mem = rank_bytes(cfg, shape_cfg, axes, options, params, batch, cache)
    note, cost = NOTE, {}
    blocker = _meta_blocker(cfg, shape_cfg)
    if blocker:
        note += f"; step not run on meta: {blocker}"
    else:
        cost = _flops(cfg, shape_cfg, params, batch, cache)
        note += "; hlo_raw: the FLOP counter over the whole step on meta"
    n_active = n_active_params(cfg)
    analytic = an.analytic_cost(
        cfg, shape_cfg, n_chips, tp=axes["model"],
        moment_bytes=2 if _moment_dtype(cfg) == "bfloat16" else 4)
    report = rf.build_report(
        arch=arch, shape=shape_name, mesh_name=mesh_name, n_chips=n_chips,
        analytic=analytic, cost=cost, mem=mem, coll=rf.CollectiveStats(),
        model_flops=rf.model_flops_for(cfg, shape_cfg, n_active),
        note=note)
    result = report.to_dict()
    result.update(
        status="ok", run_s=round(time.time() - t0, 2),
        n_params=n_params_analytic(cfg), n_params_active=n_active,
        options={"fsdp": options.fsdp, "zero": options.zero,
                 "n_microbatches": options.n_microbatches})
    if verbose:
        print(f"  bytes per rank: {json.dumps(mem)}")
        print(f"  flop counter: {cost.get('flops', 'not run')}")
        print(f"  roofline: compute={report.compute_s:.4f}s "
              f"memory={report.memory_s:.4f}s -> {report.dominant}-bound "
              f"(useful_ratio={report.useful_ratio:.2f})")
    return result


def load_results(path=RESULTS) -> dict:
    path = pathlib.Path(path)
    return json.loads(path.read_text()) if path.exists() else {}


def save_results(results: dict, path=RESULTS) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1, default=float))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--out", default=str(RESULTS),
                    help="results file (default build/dryrun_torch.json)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    results = load_results(args.out)
    failures = []
    for arch in archs:
        cfg = get(arch)
        shape_list = ([SHAPES[args.shape]] if args.shape
                      else shapes_for(cfg))
        for shape_cfg in shape_list:
            meshes = {"single": [False], "multi": [True],
                      "both": [False, True]}[args.mesh]
            for multi in meshes:
                mesh_name = "pod2x16x16" if multi else "pod16x16"
                cell = f"{arch}|{shape_cfg.name}|{mesh_name}"
                if results.get(cell, {}).get("status") == "ok" \
                        and not args.force:
                    print(f"[cached] {cell}")
                    continue
                print(f"[dry-run] {cell}", flush=True)
                try:
                    results[cell] = dry_run_cell(arch, shape_cfg.name,
                                                 multi)
                except Exception as e:
                    traceback.print_exc()
                    results[cell] = {"status": "failed",
                                     "error": f"{type(e).__name__}: {e}"}
                    failures.append(cell)
                save_results(results, args.out)
    n_ok = sum(1 for v in results.values() if v.get("status") == "ok")
    print(f"\ndry-run summary: {n_ok} ok, {len(failures)} failed")
    if failures:
        for f in failures:
            print(f"  FAILED {f}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
