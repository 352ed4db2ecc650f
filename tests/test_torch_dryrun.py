"""The port's pod dry-run (``repro_torch.launch.dryrun``).

* Its pure arithmetic equals the JAX package's for every arch x shape x
  production mesh: ``_moment_dtype``, ``cell_options`` (FSDP and the
  microbatch count), ``_adapt_moe_dispatch`` and ``_reduced_cfg``.  The
  reference module sets ``XLA_FLAGS`` to 512 host devices when it is
  imported, so its values are computed in a subprocess (its meshes as
  namespaces with the ``shape`` mapping, which is all it reads) and
  never in the test process.  Both sides count a config's params once
  per config (a cache around ``n_params_analytic``, which the helpers
  call for every cell).
* Every arch's ``prefill_32k`` cell on the single-pod mesh runs well
  within 30 s, fits 80 GB a rank, and reports ``analytic_cost``'s
  FLOPs; where the step runs on meta (dense, cross-attention and
  encoder-decoder families) the FLOP counter's count is recorded, else
  the note says why not.
* The CLI writes its results file, never ``benchmarks/results``.
"""

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, SHAPES, get, shapes_for  # noqa: E402
from repro_torch.launch import analytic as an  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

pytestmark = pytest.mark.torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(arch, shape.name, mesh) for arch in ARCHS
         for shape in shapes_for(get(arch)) for mesh in dryrun.MESHES]

_REFERENCE = r"""
import functools, json, sys, types
from repro.launch import dryrun as d
from repro.configs import ARCHS, SHAPES, get, shapes_for
counted = functools.cache(d.n_params_analytic)
d.n_params_analytic = counted
meshes = json.loads(sys.argv[1])
out = {}
for arch in ARCHS:
    cfg = get(arch)
    for shape in shapes_for(cfg):
        for name, axes in meshes.items():
            mesh = types.SimpleNamespace(shape=axes)
            opt = d.cell_options(cfg, shape, mesh)
            moe = d._adapt_moe_dispatch(cfg, mesh).moe
            out[f"{arch}|{shape.name}|{name}"] = {
                "moment_dtype": d._moment_dtype(cfg),
                "fsdp": opt.fsdp, "n_microbatches": opt.n_microbatches,
                "dispatch": None if moe is None else
                    [moe.dispatch_slices, list(moe.dispatch_axes)],
                "reduced": [[r.n_layers, r.encoder_layers] for r in
                            (d._reduced_cfg(cfg, 1), d._reduced_cfg(cfg, 2))],
            }
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(dryrun.MESHES)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def counted():
    """The port's helpers with ``n_params_analytic`` counted once per
    config."""
    real = dryrun.n_params_analytic
    dryrun.n_params_analytic = functools.cache(real)
    yield
    dryrun.n_params_analytic = real


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_helpers_match_reference(reference, counted, arch, shape, mesh):
    cfg, axes = get(arch), dryrun.MESHES[mesh]
    opt = dryrun.cell_options(cfg, SHAPES[shape], axes)
    moe = dryrun._adapt_moe_dispatch(cfg, axes).moe
    got = {
        "moment_dtype": dryrun._moment_dtype(cfg),
        "fsdp": opt.fsdp, "n_microbatches": opt.n_microbatches,
        "dispatch": None if moe is None else
            [moe.dispatch_slices, list(moe.dispatch_axes)],
        "reduced": [[r.n_layers, r.encoder_layers] for r in
                    (dryrun._reduced_cfg(cfg, 1), dryrun._reduced_cfg(cfg, 2))],
    }
    assert got == reference[f"{arch}|{shape}|{mesh}"]
    assert dataclasses.replace(opt, fsdp=False, n_microbatches=1) == \
        dryrun.step_factories.StepOptions()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_cell_reports_the_analytic_cost(arch):
    t0 = time.time()
    cell = dryrun.dry_run_cell(arch, "prefill_32k", False, verbose=False)
    assert time.time() - t0 < 30
    cfg = get(arch)
    want = an.analytic_cost(
        cfg, SHAPES["prefill_32k"], 256, tp=16,
        moment_bytes=2 if dryrun._moment_dtype(cfg) == "bfloat16" else 4)
    assert cell["status"] == "ok"
    assert cell["analytic_gflops"] == want.flops_total / 1e9
    assert cell["n_chips"] == 256 and cell["mesh"] == "pod16x16"
    assert cell["collective_gbytes"] == 0 and "not measured" in cell["note"]
    assert cell["bytes_per_device"]["fits_80gb"]
    if dryrun._meta_blocker(cfg, SHAPES["prefill_32k"]) is None:
        assert cell["hlo_raw"]["flops"] > 0
    else:
        assert cell["hlo_raw"] == {} and "not run on meta" in cell["note"]


def test_cli_writes_its_own_results_file(tmp_path):
    out = tmp_path / "dryrun_torch.json"
    dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                 "--out", str(out)])
    cells = json.loads(out.read_text())
    assert sorted(cells) == ["gemma-2b|decode_32k|pod16x16",
                             "gemma-2b|decode_32k|pod2x16x16"]
    assert all(c["status"] == "ok" for c in cells.values())
    assert dryrun.RESULTS == ROOT / "build" / "dryrun_torch.json"
