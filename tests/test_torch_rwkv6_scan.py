"""The port's RWKV6 WKV recurrence (plain version, the CPU route of the
kernel wrapper) against the JAX package: the Pallas kernel
``rwkv6_scan_pallas`` in interpret mode and the oracle
``ref.rwkv6_scan_ref``, on inputs made with numpy from a seed (decay
``sigmoid(normal)`` as the JAX package's own tests draw it).

Tolerances: fp32 atol and rtol 1e-5 (the JAX side may contract the
state update into an FMA and sums in another order); bf16 y 3e-2, the
JAX package's own bf16 tolerance.  Within the port, a state carried
across two calls reproduces one call bit for bit: the same ops run in
the same order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import rwkv6_scan_plain  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _inputs(b, t, h, dh, seed, state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, h, dh))))
         ).astype(np.float32)
    bonus = (rng.standard_normal((h, dh)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dh, dh)).astype(np.float32)
          if state else None)
    return r, k, v, w, bonus, s0


def _torch(arrays, dtype=torch.float32):
    r, k, v, w, bonus, s0 = arrays
    out = [torch.from_numpy(a).to(dtype) for a in (r, k, v, w)]
    out.append(torch.from_numpy(bonus))
    out.append(None if s0 is None else torch.from_numpy(s0))
    return out


def _jax(arrays, dtype=jnp.float32):
    r, k, v, w, bonus, s0 = arrays
    out = [jnp.asarray(a).astype(dtype) for a in (r, k, v, w)]
    out.append(jnp.asarray(bonus))
    out.append(None if s0 is None else jnp.asarray(s0))
    return out


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("b,t,h,dh", [(1, 16, 2, 32), (2, 64, 4, 32),
                                      (2, 16, 1, 64), (1, 64, 2, 64)])
@pytest.mark.parametrize("state", [False, True])
def test_plain_matches_pallas_and_oracle(b, t, h, dh, state):
    arrays = _inputs(b, t, h, dh, seed=t + dh + b, state=state)
    y, s = rwkv6_scan_plain(*_torch(arrays))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert tuple(y.shape) == (b, t, h, dh)
    assert tuple(s.shape) == (b, h, dh, dh)
    jy, js = rwkv6_scan_pallas(*_jax(arrays), chunk=16, interpret=True)
    ry, rs = jref.rwkv6_scan_ref(*_jax(arrays))
    for ey, es in ((jy, js), (ry, rs)):
        assert_allclose(_f32(y), _f32(ey), **TOL)
        assert_allclose(_f32(s), _f32(es), **TOL)


def test_carried_state_equals_the_whole():
    """Two halves, the first's state fed to the second, give the whole
    run's y and state bit for bit."""
    r, k, v, w, bonus, _ = _torch(_inputs(2, 64, 3, 32, seed=7))
    y, s = rwkv6_scan_plain(r, k, v, w, bonus)
    half = 32
    ya, sa = rwkv6_scan_plain(r[:, :half], k[:, :half], v[:, :half],
                              w[:, :half], bonus)
    yb, sb = rwkv6_scan_plain(r[:, half:], k[:, half:], v[:, half:],
                              w[:, half:], bonus, sa)
    assert torch.equal(torch.cat([ya, yb], dim=1), y)
    assert torch.equal(sb, s)


def test_one_step_equals_the_models_wkv_step():
    """T = 1 with a state, what decode runs, against the JAX model's
    ``_wkv_step`` and the port's own."""
    arrays = _inputs(2, 1, 4, 32, seed=11, state=True)
    r, k, v, w, bonus, s0 = _torch(arrays)
    y, s = rwkv6_scan_plain(r, k, v, w, bonus, s0)
    jr, jk, jv, jw, jb, js0 = _jax(arrays)
    jh, jy = jrwkv._wkv_step(js0, jr[:, 0], jk[:, 0], jv[:, 0], jw[:, 0],
                             jb)
    assert_allclose(_f32(y[:, 0]), _f32(jy), **TOL)
    assert_allclose(_f32(s), _f32(jh), **TOL)
    th, ty = trwkv._wkv_step(s0, r[:, 0], k[:, 0], v[:, 0], w[:, 0], bonus)
    assert_allclose(_f32(y[:, 0]), _f32(ty), **TOL)
    assert torch.equal(s, th)


def test_bf16_inputs_give_bf16_y_and_fp32_state():
    arrays = _inputs(1, 32, 2, 32, seed=5)
    y, s = rwkv6_scan_plain(*_torch(arrays, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    jy, js = rwkv6_scan_pallas(*_jax(arrays, jnp.bfloat16), chunk=8,
                               interpret=True)
    assert jy.dtype == jnp.bfloat16
    assert_allclose(_f32(y), _f32(jy), **BF16_TOL)
    assert_allclose(_f32(s), _f32(js), **BF16_TOL)


def test_cpu_tensors_take_the_plain_route():
    """The wrapper and ``ops.rwkv6_scan`` return the plain version's
    result on CPU tensors and count no launch."""
    args = _torch(_inputs(1, 16, 2, 32, seed=3, state=True))
    before = rwkv6_scan.launches
    want = rwkv6_scan_plain(*args)
    for fn in (rwkv6_scan, ops.rwkv6_scan):
        got = fn(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert rwkv6_scan.launches == before


@pytest.mark.parametrize("chunk", [16, 64])
def test_ops_takes_the_references_chunk(chunk):
    """``ops.rwkv6_scan`` has the reference's signature: ``chunk`` (the
    TPU kernel's T tile) is accepted and changes nothing, and the result
    matches ``repro.kernels.ops.rwkv6_scan`` at the same ``chunk``."""
    from repro.kernels import ops as jops
    arrays = _inputs(2, 64, 2, 32, seed=13, state=True)
    args = _torch(arrays)
    y, s = ops.rwkv6_scan(*args, chunk=chunk)
    want = rwkv6_scan_plain(*args)
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])
    jy, js = jops.rwkv6_scan(*_jax(arrays), chunk=chunk)
    assert_allclose(_f32(y), _f32(jy), **TOL)
    assert_allclose(_f32(s), _f32(js), **TOL)
