"""The port's JAX-free leaves against the JAX package: the CCS model
checker, the strategy registry and the public names of ``core``,
``content`` and ``kernels.ops``."""

import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import repro.content as rcontent  # noqa: E402
import repro.core as rcore  # noqa: E402
from repro.core import model_check as rmc, strategies as rstrat  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
import repro_torch.content as tcontent  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import model_check as tmc  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

pytestmark = pytest.mark.torch

#: the configurations of the JAX package's model-check tests
CONFIGS = {
    "default": {},
    "larger": dict(max_version=4, max_steps=5),
    "four_agents": dict(n_agents=4, max_version=2, max_steps=2),
    "k1": dict(max_stale_steps=1, max_steps=4, max_version=2),
    "k3": dict(max_stale_steps=3, max_steps=4, max_version=2),
    "broken_upgrade": dict(broken_upgrade=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_check_reaches_the_reference_state_space(name):
    got = tmc.check(tmc.CheckConfig(**CONFIGS[name]))
    want = rmc.check(rmc.CheckConfig(**CONFIGS[name]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ok == want.ok


def test_swmr_counterexample_is_the_reference_one():
    got = tmc.find_swmr_counterexample()
    want = rmc.find_swmr_counterexample()
    assert got.violation == want.violation
    assert got.violation["invariant"] == "SingleWriter"
    acts = [a.split("(")[0] for a in got.violation["trace"]]
    assert acts.count("Write") == 2 and acts.count("Upgrade") == 2


def test_initial_state_and_successors_match():
    cfg = tmc.CheckConfig()
    init = tmc.initial_state(cfg)
    assert init == rmc.initial_state(rmc.CheckConfig())
    assert (sorted(tmc.successors(cfg, init))
            == sorted(rmc.successors(rmc.CheckConfig(), init)))


def test_strategy_registry_field_by_field():
    assert list(tstrat.REGISTRY) == list(rstrat.REGISTRY)
    for name, want in rstrat.REGISTRY.items():
        assert dataclasses.asdict(tstrat.get(name)) == dataclasses.asdict(
            want)
    with pytest.raises(KeyError):
        tstrat.get("nope")


def _functions(module) -> set:
    """Public functions defined in ``module`` (the reference's are
    ``jax.jit`` wrappers of them)."""
    return {name for name, obj in vars(module).items()
            if callable(obj) and not name.startswith("_")
            and getattr(inspect.unwrap(obj), "__module__", None)
            == module.__name__}


@pytest.mark.parametrize("ref,port", [(rcore, tcore),
                                      (rcontent, tcontent)],
                         ids=["core", "content"])
def test_package_exports_match(ref, port):
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


#: the port's ops entries with no counterpart in ``repro.kernels.ops``:
#: Mamba's conv and scan (and the scan's gated mode), kernels on the card
#: where the reference runs plain JAX (``repro.models.mamba``)
PORT_ONLY_OPS = {"causal_conv1d", "selective_scan", "selective_scan_gated"}
#: trailing arguments of a port entry that the reference's lacks: flash
#: attention's per-row query offsets and key lengths, which the cached
#: prefill at an offset passes (the reference's model masks in ``_sdpa``)
PORT_ONLY_ARGS = {"flash_attention": ["q_offset", "kv_len"]}


def test_ops_entry_points_match():
    assert _functions(tops) == _functions(rops) | PORT_ONLY_OPS
    assert _functions(rops) == {"rmsnorm", "flash_attention",
                                "decode_attention", "rwkv6_scan",
                                "mesi_tick"}
    for name in _functions(rops):
        ref_params = list(inspect.signature(
            inspect.unwrap(getattr(rops, name))).parameters)
        assert list(inspect.signature(getattr(tops, name)).parameters) \
            == ref_params + PORT_ONLY_ARGS.get(name, []), name
