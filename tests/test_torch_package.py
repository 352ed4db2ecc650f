"""Package rules of the PyTorch/CUDA port: it imports neither JAX nor the
JAX package, and its entry points run on CUDA unless told otherwise."""

import ast
import dataclasses
import pathlib
import warnings

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import acs  # noqa: E402
from repro_torch.kernels import backend, build  # noqa: E402
from repro_torch.kernels import mesi_transition  # noqa: E402
from repro_torch.sim import SCENARIOS, compare, run_scenario, zoo  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import mesh, serve  # noqa: E402
from repro_torch.launch import service as launch_service  # noqa: E402
from repro_torch.runtime import CoherentServingSystem  # noqa: E402
from repro_torch.service import (BatchDecider, BrokerConfig,  # noqa: E402
                                 CoherenceBroker, CoherenceConfig,
                                 ServicePortal, ShardedCoherenceBroker,
                                 connect)
from repro_torch.sim import oracle  # noqa: E402
from repro_torch import checkpoint, data, optim  # noqa: E402, F401
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.runtime import steps, train_loop  # noqa: E402, F401

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


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_torch_testing(path):
    """``torch.testing`` (and its fake process group) is for tests only."""
    for module in _imported_modules(path):
        assert not module.startswith("torch.testing"), (path, module)


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
                   "sim/engine.py", "sim/workloads.py", "sim/oracle.py",
                   "core/model_check.py", "core/strategies.py",
                   "content/chunks.py", "configs/coherence.py",
                   "obs/registry.py", "obs/spans.py", "obs/runtime.py",
                   "obs/stats.py", "obs/telemetry.py",
                   "obs/conformance.py", "service/batching.py",
                   "service/trace.py", "service/broker.py",
                   "service/client.py", "service/loadgen.py",
                   "service/sharding.py", "service/connect.py",
                   "service/adapters.py", "launch/mesh.py",
                   "launch/service.py", "optim/adamw.py",
                   "data/pipeline.py", "checkpoint/checkpoint.py",
                   "runtime/steps.py", "runtime/train_loop.py",
                   "launch/train.py", "launch/analytic.py",
                   "launch/roofline.py", "runtime/sharding.py",
                   "launch/dryrun.py"):
        assert any(n.endswith(module) for n in names), module


@pytest.fixture
def no_card(monkeypatch):
    """The host as one without a CUDA device, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _broker_config():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return BrokerConfig(n_agents=2, artifacts=("a", "b"),
                            artifact_tokens=8)


def _trace(chunk_tokens: int = 0):
    cfg = dataclasses.replace(SCENARIOS["A"].acs, n_steps=2,
                              artifact_tokens=8, chunk_tokens=chunk_tokens)
    return cfg, oracle.sample_trace(cfg, oracle.episode_key(0, 0, "cpu"))


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
    lambda: BatchDecider(_broker_config().acs_config()),
    lambda: CoherenceBroker(_broker_config()),
    lambda: oracle.episode_key(0),
    lambda: oracle.replay_kernel(*_trace()),
    lambda: oracle.replay_content_kernel(*_trace(chunk_tokens=4)),
    lambda: oracle.check_trace(*_trace()),
    lambda: oracle.check_content_trace(*_trace(chunk_tokens=4)),
    lambda: mesh.shard_streams(2),
    lambda: mesh.shard_devices(2),
    lambda: mesh.make_host_mesh(),
    lambda: connect(n_agents=2, artifacts=("a", "b"), shards=2),
    lambda: connect(n_agents=2, artifacts=("a",)),
    lambda: ShardedCoherenceBroker(CoherenceConfig.make(2, ("a",), hosts=2)),
    lambda: ServicePortal(CoherenceConfig.make(2, ("a", "b"), shards=2)),
    lambda: launch_service.main(["--clients", "2", "--artifacts", "2",
                                 "--artifact-tokens", "8", "--rounds", "1",
                                 "--shards", "2"]),
    lambda: train_loop.run_training(smoke_config("qwen3-1.7b"),
                                    train_loop.TrainLoopConfig(total_steps=1),
                                    "build/never_written"),
    lambda: launch_train.main(["--arch", "qwen3-1.7b", "--smoke",
                               "--steps", "1",
                               "--ckpt-dir", "build/never_written"]),
], ids=["run_scenario", "compare", "rates", "init_arrays", "init_metrics",
        "init_params", "init_cache", "params_from_numpy",
        "serving_system", "serve_cli", "rwkv6_init_params",
        "rwkv6_init_cache", "rwkv6_serve_cli", "batch_decider",
        "broker", "episode_key", "oracle_kernel_leg",
        "oracle_content_kernel_leg", "check_trace", "check_content_trace",
        "shard_streams", "shard_devices", "host_mesh", "connect_sharded", "connect_single",
        "sharded_broker", "sharded_portal", "service_cli",
        "run_training", "train_cli"])
def test_entry_points_default_to_cuda(no_card, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_device_resolution(no_card):
    assert backend.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.resolve_device(None)


def test_routing_rule():
    cpu = torch.zeros(2)
    meta = torch.zeros(2, device="meta")
    assert backend.use_kernel(cpu, cpu) is False
    assert backend.use_kernel(meta, meta) is False
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



@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_c_entry_takes_the_arguments_its_wrapper_passes(name):
    """Each kernel's C entry, as its source defines it, takes as many
    parameters as ``build.KERNELS`` gives ctypes (a count off by one
    would shift every argument after it, with no error from ctypes)."""
    source, symbol, argtypes = build.KERNELS[name]
    text = (build._CSRC / source).read_text()
    start = text.index(f'extern "C" int {symbol}(') + len(
        f'extern "C" int {symbol}(')
    params = text[start:text.index(")", start)]
    assert len(params.split(",")) == len(argtypes), (name, params)
