"""The port's pod meshes (``repro_torch.launch.mesh``) and the DTensor
placements of its sharding specs, in one process over PyTorch's fake
process group: rank 0 of a world of 1, 8, 256 or 512 ranks whose
collectives do nothing.  Each test builds its group and destroys it
before it returns, so no other test sees it.

The meshes must have the reference's shapes and axis names
(``repro.launch.mesh``: (data 16, model 16), (pod 2, data 16, model
16), (data 1, model 1) and a 1-D sweep mesh) and raise without a world
of their size.  ``to_placements`` is held by local shapes: on rank 0,
``distribute_tensor`` of a meta leaf has the global shape divided along
each spec entry by its axes' sizes, for every param, moment, batch and
cache leaf of one arch per family on the two-pod mesh.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

pytestmark = pytest.mark.torch


@contextlib.contextmanager
def fake_world(n: int):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_mesh_has_the_reference_shape(multi_pod, shape, axes):
    with fake_world(512 if multi_pod else 256):
        m = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert tuple(m.shape) == shape
        assert m.mesh_dim_names == axes
        assert m.device_type == "cpu"
        assert tmesh.mesh_axes(m) == dict(zip(axes, shape))


def test_host_and_sweep_meshes():
    with fake_world(1):
        m = tmesh.make_host_mesh(device="cpu")
        assert (tuple(m.shape), m.mesh_dim_names) == ((1, 1),
                                                     ("data", "model"))
    with fake_world(8):
        m = tmesh.make_sweep_mesh(device="cpu")
        assert (tuple(m.shape), m.mesh_dim_names) == ((8,), ("runs",))
        m = tmesh.make_sweep_mesh(8, "workloads", device="cpu")
        assert tmesh.mesh_axes(m) == {"workloads": 8}


def test_a_mesh_never_shrinks_to_the_world():
    with pytest.raises(RuntimeError, match="none is initialized"):
        tmesh.make_host_mesh(device="cpu")
    with fake_world(8):
        with pytest.raises(RuntimeError, match="256 ranks.*has 8"):
            tmesh.make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="512 ranks"):
            tmesh.make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(RuntimeError, match="4 ranks"):
            tmesh.make_sweep_mesh(4, device="cpu")
    assert not dist.is_initialized()


def test_mesh_axes_takes_a_mapping():
    assert tmesh.mesh_axes({"data": 2, "model": 1}) == {"data": 2,
                                                       "model": 1}


def _leaves_and_specs(arch, axes):
    """(name, meta leaf, spec) of every param, fsdp param, ZeRO moment,
    train batch and decode cache leaf of ``arch``."""
    cfg = tcfgs.get(arch)
    params = ttf.init_params(cfg, device="meta")
    out = []
    for what, specs in (("param", tshd.param_specs(params)),
                        ("fsdp", tshd.fsdp_param_specs(params, axes)),
                        ("moment", tshd.opt_state_specs(params, axes))):
        flat = dict(tshd.flatten_with_paths(specs))
        out += [(f"{what}{p}", x, flat[p])
                for p, x in tshd.flatten_with_paths(params)]
    for shape, fn in (("train_4k", lambda t: tshd.batch_specs(t, axes)),
                      ("decode_32k",
                       lambda t: tshd.cache_specs(t, cfg, axes))):
        tree = tcfgs.input_specs(cfg, tcfgs.SHAPES[shape])
        if shape == "decode_32k":
            tree = tree["cache"]
        flat = dict(tshd.flatten_with_paths(fn(tree)))
        out += [(f"{shape}{p}", x, flat[p])
                for p, x in tshd.flatten_with_paths(tree)]
    return out


#: one arch per family
FAMILIES = ["gemma-2b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
            "jamba-1.5-large-398b", "rwkv6-1.6b", "llama-3.2-vision-90b",
            "whisper-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_placements_give_the_spec_local_shapes(arch):
    with fake_world(512):
        m = tmesh.make_production_mesh(multi_pod=True, device="cpu")
        axes = tmesh.mesh_axes(m)
        bad = []
        for name, leaf, spec in _leaves_and_specs(arch, axes):
            local = distribute_tensor(leaf, m, tshd.to_placements(spec, m))
            want = tshd.local_shape(spec, tuple(leaf.shape), axes)
            if tuple(local.to_local().shape) != want:
                bad.append((name, spec, tuple(leaf.shape),
                            tuple(local.to_local().shape)))
        assert not bad, bad
