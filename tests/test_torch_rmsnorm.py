"""The port's RMSNorm (plain version, the CPU route of the kernel
wrapper) against the JAX package: ``repro.kernels.ops.rmsnorm`` (the
Pallas kernel, in interpret mode on the CPU) and ``ref.rmsnorm_ref``, on inputs made with numpy from a seed.

Tolerances: fp32 1e-5 (rtol and atol; the sums run in another order);
bf16 2e-2, the JAX package's own bf16 tolerance.  In bf16 the port and
the TPU kernel multiply by the weight in fp32 before the cast, while
``rmsnorm_ref`` casts first, so against the oracle the two may round
one bf16 ulp apart.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_plain  # noqa: E402

pytestmark = pytest.mark.torch

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    jx, jw = (jnp.asarray(a).astype(JAX_DT[dtype]) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (x, w))
    return jx, jw, tx, tw


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("shape", [(8, 128), (33, 512), (1, 2048),
                                   (4, 16, 256), (3, 5, 4, 32),
                                   # qk-norm widths, one row and a row per
                                   # (token, head); a width that is no
                                   # multiple of the kernel's 16-byte vector
                                   (1, 64), (1, 128), (1, 256), (2, 8, 128),
                                   (4, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_equals_pallas_and_oracle(shape, dtype):
    jx, jw, tx, tw = _inputs(shape, dtype, sum(shape))
    got = rmsnorm_plain(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    kernel = jops.rmsnorm(jx, jw)
    assert_allclose(_f32(got), _f32(kernel), **TOLS[dtype])
    assert_allclose(_f32(got), _f32(jref.rmsnorm_ref(jx, jw)),
                    **TOLS[dtype])


def test_plain_follows_the_kernel_cast_order():
    """bf16: weight multiplied in fp32, then one rounding - the Pallas
    kernel's result to the bit."""
    jx, jw, tx, tw = _inputs((64, 256), "bfloat16", 3)
    np.testing.assert_array_equal(
        _f32(rmsnorm_plain(tx, tw)),
        _f32(jops.rmsnorm(jx, jw)))


def test_cpu_route_runs_the_plain_version():
    _, _, tx, tw = _inputs((6, 64), "float32", 9)
    before = trms.rmsnorm.launches
    np.testing.assert_array_equal(ops.rmsnorm(tx, tw).numpy(),
                                  rmsnorm_plain(tx, tw).numpy())
    assert trms.rmsnorm.launches == before


def test_mixed_devices_raise():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        trms.rmsnorm(x, torch.zeros(4, device="meta"))
