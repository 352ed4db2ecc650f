"""The port's cost model against ``repro``'s on the CPU: the analytic
FLOPs / HBM model (``launch/analytic.py``), the model-FLOP count and the
one-card roofline (``launch/roofline.py``), and the registry's
``shapes_for`` / ``input_specs``, for every registered arch.

``analytic_cost`` and ``model_flops_for`` are plain arithmetic over the
configs, copied with the same operations in the same order, so they are
held with ``==`` at the reference's pod meshes (256 and 512 chips, tp
16).  The reference counts parameters by ``jax.eval_shape`` of its init,
which is slow at full width, so the reference's count is computed once
per arch here (``n_params_analytic`` patched to a memo of itself)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import analytic as tanalytic  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402

pytestmark = pytest.mark.torch

ARCHS = sorted(treg.ARCHS)
#: the reference's pod meshes: (n_chips, tp)
MESHES = [(256, 16), (512, 16)]
#: the port's head-major cache leaves, (..., Hkv, L, D) against the
#: reference's (..., L, Hkv, D)
HEAD_MAJOR = ("k", "v", "xk", "xv", "enc_k", "enc_v")

_jcount = functools.lru_cache(maxsize=None)(jreg.n_params_analytic)


@pytest.fixture
def memo_reference_count(monkeypatch):
    monkeypatch.setattr(jreg, "n_params_analytic", _jcount)


def _breakdown(cost) -> tuple:
    return (cost.flops_total, cost.hbm_bytes_per_chip, cost.flops_by_part,
            cost.bytes_by_part)


def test_the_registries_hold_the_same_archs():
    assert sorted(jreg.ARCHS) == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_for_gives_the_reference_names(arch):
    got = [s.name for s in treg.shapes_for(treg.get(arch))]
    assert got == [s.name for s in jreg.shapes_for(jreg.get(arch))]
    assert all(isinstance(s, treg.ShapeConfig)
               for s in treg.shapes_for(treg.get(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_cost_equals_the_reference(arch, memo_reference_count):
    jc, tc = jreg.get(arch), treg.get(arch)
    assert treg.n_params_analytic(tc) == _jcount(jc)
    for jshape, tshape in zip(jreg.shapes_for(jc), treg.shapes_for(tc)):
        for n_chips, tp in MESHES:
            want = janalytic.analytic_cost(jc, jshape, n_chips, tp)
            got = tanalytic.analytic_cost(tc, tshape, n_chips, tp)
            assert _breakdown(got) == _breakdown(want), (tshape.name, n_chips)
            assert tanalytic._kv_cache_bytes(tc, 4, 2048, 1024) \
                == janalytic._kv_cache_bytes(jc, 4, 2048, 1024)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    jc, tc = jreg.get(arch), treg.get(arch)
    active = treg.n_active_params(tc)
    assert active == jreg.n_active_params(jc)
    for jshape, tshape in zip(jreg.shapes_for(jc), treg.shapes_for(tc)):
        assert troofline.model_flops_for(tc, tshape, active) \
            == jroofline.model_flops_for(jc, jshape, active)


def _spec(leaf) -> tuple:
    return tuple(leaf.shape), str(leaf.dtype).split(".")[-1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    """Train and prefill: the same shapes and dtypes; decode: the token,
    and every cache leaf up to the head-major permutation of the
    attention K / V leaves.  Every port spec lies on the meta device."""
    jc, tc = jreg.get(arch), treg.get(arch)
    for jshape, tshape in zip(jreg.shapes_for(jc), treg.shapes_for(tc)):
        want = _flat(jreg.input_specs(jc, jshape))
        got = _flat(treg.input_specs(tc, tshape))
        assert sorted(got) == sorted(want), tshape.name
        for name, leaf in got.items():
            assert leaf.device.type == "meta", name
            shape, dtype = _spec(leaf)
            if name.rsplit("/", 1)[-1] in HEAD_MAJOR:
                shape = shape[:-3] + (shape[-2], shape[-3], shape[-1])
            assert (shape, dtype) == _spec(want[name]), (tshape.name, name)


def test_token_dtype_is_int32():
    assert treg.token_dtype() == torch.int32
    assert jnp.dtype(jreg.token_dtype()) == jnp.int32


@pytest.mark.parametrize("card,bf16,memory", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 835e12, 3.9e12)])
def test_one_card_report_takes_the_cards_rates(card, bf16, memory):
    """``build_report`` at one card: compute = analytic FLOPs over the
    card's bf16 rate, memory = its bytes over the card's memory rate, no
    collective term, no raw cost analysis; the reference's arithmetic for
    the rest."""
    tc = treg.get("gemma-2b")
    shape = treg.SHAPES["prefill_32k"]
    cost = tanalytic.analytic_cost(tc, shape, n_chips=1, tp=1)
    flops = troofline.model_flops_for(tc, shape, treg.n_active_params(tc))
    rep = troofline.build_report(arch=tc.name, shape=shape.name,
                                 mesh_name="1xH100", n_chips=1,
                                 analytic=cost, model_flops=flops,
                                 card=card)
    assert rep.compute_s == cost.flops_total / 1 / bf16
    assert rep.memory_s == cost.hbm_bytes_per_chip / memory
    assert rep.collective_s == 0.0 and rep.collective_gbytes == 0.0
    assert rep.hlo_raw == {} and rep.collective_by_op == {}
    assert rep.dominant == max(("compute", rep.compute_s),
                               ("memory", rep.memory_s),
                               key=lambda kv: kv[1])[0]
    assert rep.bound_time_s == max(rep.compute_s, rep.memory_s)
    assert rep.useful_ratio == flops / cost.flops_total
    assert rep.flops_by_part is cost.flops_by_part
    fields = [f.name for f in jroofline.RooflineReport.__dataclass_fields__
              .values()]
    assert list(rep.to_dict()) == fields


def test_one_card_costs_are_finite():
    """``n_chips=1, tp=1`` divides by ``dp = 1``: every registered cell's
    one-card terms are finite and positive."""
    for arch in ARCHS:
        tc = treg.get(arch)
        for shape in treg.shapes_for(tc):
            cost = tanalytic.analytic_cost(tc, shape, n_chips=1, tp=1)
            assert np.isfinite(cost.flops_total) and cost.flops_total > 0
            assert np.isfinite(cost.hbm_bytes_per_chip) \
                and cost.hbm_bytes_per_chip > 0


def test_card_rates_refuse_another_card():
    with pytest.raises(RuntimeError, match="no bf16 rate"):
        troofline.bf16_rate("NVIDIA A100-SXM4-80GB")
    assert jax.devices()[0].platform == "cpu"
