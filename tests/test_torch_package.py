"""Package rules of the PyTorch/CUDA port: it imports neither JAX nor the
JAX package, and its entry points run on CUDA unless told otherwise."""

import ast
import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import acs  # noqa: E402
from repro_torch.kernels import backend, build  # noqa: E402
from repro_torch.kernels import mesi_transition  # noqa: E402
from repro_torch.sim import SCENARIOS, compare, run_scenario, zoo  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import CoherentServingSystem  # noqa: E402

pytestmark = pytest.mark.torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(pathlib.Path(repro_torch.__file__).parent.rglob("*.py"))


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_the_jax_package(path):
    for module in _imported_modules(path):
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, module)


def test_every_port_module_is_checked():
    names = {p.relative_to(PORT_FILES[0].parents[0]).as_posix()
             for p in PORT_FILES}
    for module in ("core/acs.py", "core/prng.py", "core/protocol.py",
                   "core/clock.py", "core/lease.py",
                   "kernels/mesi_transition.py", "kernels/chunk_diff.py",
                   "kernels/build.py", "kernels/ref.py",
                   "kernels/rmsnorm.py", "kernels/flash_attention.py",
                   "kernels/decode_attention.py", "kernels/ops.py",
                   "kernels/rwkv6_scan.py", "models/rwkv6.py",
                   "configs/base.py", "configs/registry.py",
                   "models/common.py", "models/attention.py",
                   "models/transformer.py", "models/convert.py",
                   "runtime/coherent_serving.py", "launch/serve.py",
                   "sim/engine.py", "sim/workloads.py"):
        assert any(n.endswith(module) for n in names), module


@pytest.fixture
def no_card(monkeypatch):
    """The host as one without a CUDA device, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: run_scenario(dataclasses.replace(SCENARIOS["A"], n_runs=2)),
    lambda: compare(dataclasses.replace(SCENARIOS["A"], n_runs=2)),
    lambda: zoo(n_agents=2, n_artifacts=2, n_runs=1)[0].rates(),
    lambda: acs.init_arrays(SCENARIOS["A"].acs, 2),
    lambda: acs.init_metrics(2),
    lambda: models.init_params(smoke_config("gemma-2b")),
    lambda: models.init_cache(smoke_config("gemma-2b"), 1, 8),
    lambda: models.params_from_numpy({}, smoke_config("gemma-2b")),
    lambda: CoherentServingSystem(smoke_config("gemma-2b"), 2,
                                  {"a": [1, 2]}),
    lambda: serve.main(["--smoke", "--steps", "1"]),
    lambda: models.init_params(smoke_config("rwkv6-1.6b")),
    lambda: models.init_cache(smoke_config("rwkv6-1.6b"), 1, 8),
    lambda: serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--steps", "1"]),
], ids=["run_scenario", "compare", "rates", "init_arrays", "init_metrics",
        "init_params", "init_cache", "params_from_numpy",
        "serving_system", "serve_cli", "rwkv6_init_params",
        "rwkv6_init_cache", "rwkv6_serve_cli"])
def test_entry_points_default_to_cuda(no_card, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_device_resolution(no_card):
    assert backend.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.resolve_device(None)


def test_routing_rule():
    cpu = torch.zeros(2)
    assert backend.use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError, match="one CUDA device"):
        backend.use_kernel(cpu, torch.zeros(2, device="meta"))


def test_cpu_route_never_counts_a_launch():
    before = mesi_transition.mesi_tick_.launches
    run_scenario(dataclasses.replace(SCENARIOS["A"], n_runs=2).with_overrides(
        n_steps=3, artifact_tokens=16), device="cpu")
    assert mesi_transition.mesi_tick_.launches == before


def test_library_path_follows_every_shared_header(tmp_path, monkeypatch):
    """A kernel's library is named by its source, the flags and every
    ``csrc/*.cuh``, so an edited or added header rebuilds it; reading
    the files is all it takes, so this runs without nvcc."""
    for src in build._CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    names = []
    for edit in (None, "hopper.cuh", "new.cuh", "flash_attention.cu"):
        if edit:
            path = tmp_path / edit
            path.write_bytes((path.read_bytes() if path.exists() else b"")
                             + b"\n// edited\n")
        names.append(build.library_path("flash_attention").name)
    assert len(set(names)) == len(names), names
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("flash_attention").name != names[-1]

