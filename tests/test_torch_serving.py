"""The port's coherent serving runtime against ``repro.runtime``: the
same numpy stream drives both, so every integer of ``ServingStats`` is
equal; a materialized prefill's logits match on the gemma-2b and
rwkv6-1.6b smoke configs (fp32, atol and rtol 1e-4); the parameter
counts of the registered gemma-2b, qwen3-1.7b and rwkv6-1.6b equal the
JAX package's; the launcher runs end to end on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import n_active_params as j_active  # noqa: E402
from repro.configs import n_params_analytic as j_total  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch.serve import build_artifacts  # noqa: E402
from repro.runtime import coherent_serving as jcs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import n_active_params as t_active  # noqa: E402
from repro_torch.configs import n_params_analytic as t_total  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime import coherent_serving as tcs  # noqa: E402

pytestmark = pytest.mark.torch

INTS = ("prefill_tokens", "broadcast_tokens", "fetches", "cache_hits")


def _systems(strategy, sorted_, n=4, m=3, tokens=64, arch="gemma-2b"):
    arts = build_artifacts(m, tokens)
    j = jcs.CoherentServingSystem(j_smoke(arch), n, dict(arts),
                                  strategy=strategy,
                                  volatility_sorted=sorted_,
                                  n_active_params=1000)
    t = tcs.CoherentServingSystem(t_smoke(arch), n, dict(arts),
                                  strategy=strategy,
                                  volatility_sorted=sorted_,
                                  n_active_params=1000, device="cpu")
    return j, t


@pytest.mark.parametrize("strategy", ["lazy", "eager", "access_count"])
@pytest.mark.parametrize("sorted_", [False, True])
@pytest.mark.parametrize("volatility", [0.1, [0.02, 0.3, 0.6]])
def test_serving_stats_equal_reference(strategy, sorted_, volatility):
    j, t = _systems(strategy, sorted_)
    js = jcs.run_workload(j, 40, volatility, seed=3)
    ts = tcs.run_workload(t, 40, volatility, seed=3)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    for field in INTS:
        assert isinstance(getattr(ts, field), int)
    assert [a.layout for a in j.agents] == [a.layout for a in t.agents]
    assert (js.token_savings, js.flops_savings) == (ts.token_savings,
                                                    ts.flops_savings)


def test_parameter_counts_equal_reference():
    assert t_active(T_ARCHS["gemma-2b"]) == j_active(J_ARCHS["gemma-2b"])
    assert t_total(T_ARCHS["qwen3-1.7b"]) == j_total(J_ARCHS["qwen3-1.7b"])


def test_rwkv6_parameter_counts_equal_reference():
    assert t_total(T_ARCHS["rwkv6-1.6b"]) == j_total(J_ARCHS["rwkv6-1.6b"])
    assert t_active(T_ARCHS["rwkv6-1.6b"]) == j_active(
        J_ARCHS["rwkv6-1.6b"])


def test_materialized_prefill_matches_reference():
    _materialized_prefill("gemma-2b")


def test_rwkv6_materialized_prefill_matches_reference():
    """Contexts of 64-token artifacts cut to 96 tokens: multiples of the
    smoke chunk (16), as the JAX model requires."""
    _materialized_prefill("rwkv6-1.6b")


def _materialized_prefill(arch):
    j, t = _systems("lazy", False, arch=arch)
    jcs.run_workload(j, 12, 0.1, seed=1)
    tcs.run_workload(t, 12, 0.1, seed=1)
    jp = jm.init_params(j.cfg, jax.random.PRNGKey(2))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), t.cfg, "cpu")
    for agent in range(2):
        jl = j.materialize_prefill(jp, agent, max_len=96)
        tl = t.materialize_prefill(tp, agent, max_len=96)
        assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_batched_request_forced_tokens_reproduce_greedy():
    _, t = _systems("lazy", False)
    tcs.run_workload(t, 20, 0.1, seed=4)
    params = tm.init_params(t.cfg, seed=5, device="cpu")
    out = tserve.batched_request(t, params, 4)
    again = tserve.batched_request(t, params, 4, forced=out["tokens"])
    assert out["logits"].shape == (4, 5, t.cfg.vocab_size)
    assert torch.equal(out["logits"], again["logits"])
    assert out["prompt_len"] == min(len(t.context_tokens(i))
                                    for i in range(4))


def test_serve_cli_on_the_cpu(capsys):
    tserve.main(["--smoke", "--device", "cpu", "--steps", "6",
                 "--materialize", "--max-len", "64", "--decode-steps", "2"])
    out = capsys.readouterr().out
    assert "savings" in out and "finite=True" in out


def test_rwkv6_serve_cli_on_the_cpu(capsys):
    tserve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                 "--steps", "6", "--materialize", "--max-len", "64",
                 "--decode-steps", "2"])
    out = capsys.readouterr().out
    assert "1.60B active params" in out
    assert "finite=True" in out and "finite=False" not in out
