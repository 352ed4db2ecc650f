"""The port's CUDA kernels on a card: each kernel against its plain
PyTorch version on the same CUDA tensors, and the engine's kernel route
against its scan route.  Needs a CUDA device and nvcc; elsewhere every
test skips.  Imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import chunk_diff, mesi_transition  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, plan)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import (attention_plain,  # noqa: E402
                                     decode_attention_plain, rmsnorm_plain)
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan,  # noqa: E402
                                            rwkv6_scan_plain)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.acs import draw_write_chunks  # noqa: E402
from repro_torch.sim import SCENARIOS, run_workload, run_scenario, zoo  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.cuda]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _ints(gen, lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _mesi_inputs(gen, B, n, m):
    state = _ints(gen, 0, 2, B, n, m)
    version = _ints(gen, 1, 5, B, m)
    sync = torch.where(state > 0, version[:, None, :], 0).to(torch.int32)
    return (state, version, sync, _ints(gen, 0, 6, B, n, m),
            _ints(gen, 0, 2, B, n), _ints(gen, 0, m, B, n),
            _ints(gen, 0, 2, B, n))


@pytest.mark.parametrize("B,n,m", [
    (1, 1, 1), (33, 4, 3), (300, 16, 16),
    (24576, 16, 16),          # the content fleet
    (16384, 4, 3),            # the four scenarios' batch
    (1003, 16, 16),           # B not a multiple of a block's simulations
    (77, 32, 32),             # the staged path's widest slab
    (64, 40, 40),             # agents and artifacts past the staged budget
    (50, 8, 33),              # artifacts past it: the direct path
])
@pytest.mark.parametrize("eager,access_k", [(False, 0), (True, 0),
                                            (False, 3)])
def test_mesi_kernel_equals_plain(gen, B, n, m, eager, access_k):
    """Every output of the tick equal to the plain version's, on the
    staged path and, past its budget of a warp's lanes (n, m <= 32), on
    the direct path: ``plan`` says which ran."""
    staged = n <= 32 and m <= 32
    assert (mesi_transition.plan(n, m) > 0) == staged
    inputs = _mesi_inputs(gen, B, n, m)
    opts = dict(artifact_tokens=64, eager=eager, access_k=access_k)
    launches = mesi_transition.mesi_tick_.launches
    out = mesi_transition.mesi_tick(*inputs, **opts)
    torch.cuda.synchronize()
    assert mesi_transition.mesi_tick_.launches == launches + 1
    plain = [t.clone() for t in inputs[:4]]
    plain += list(mesi_transition.mesi_tick_plain_(*plain, *inputs[4:],
                                                   **opts))
    for got, exp in zip(out, plain):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("B,n,m", [(24576, 16, 16), (16384, 4, 3),
                                   (64, 40, 40)])
@pytest.mark.parametrize("eager,access_k", [(False, 0), (True, 0),
                                            (False, 3)])
def test_mesi_repeated_launches_agree(gen, B, n, m, eager, access_k):
    """50 launches of the in-place tick, each from the same inputs: every
    output equal to the first bit for bit."""
    inputs = _mesi_inputs(gen, B, n, m)
    opts = dict(artifact_tokens=64, eager=eager, access_k=access_k)

    def tick():
        state = [t.clone() for t in inputs[:4]]
        return state + list(mesi_transition.mesi_tick_(*state, *inputs[4:],
                                                       **opts))
    first = tick()
    for i in range(50):
        assert all(torch.equal(a, b) for a, b in zip(tick(), first)), i


def _chunk_inputs(gen, B, n, m, C, chain=False):
    """A MESI tick's ``miss`` and random chunk vectors lagging the
    authority by 0 or 1, write spans of 30 % of the chunks; with
    ``chain`` every agent fills and writes artifact 0 instead."""
    *_, acts, arts, writes = _mesi_inputs(gen, B, n, m)
    miss = mesi_transition.mesi_tick(*_mesi_inputs(gen, B, n, m)[:4], acts,
                                     arts, writes, artifact_tokens=64)[5]
    wact = (acts * writes).contiguous()
    if chain:
        miss, wact = torch.ones_like(miss), torch.ones_like(wact)
        arts = torch.zeros_like(arts)
    cv = _ints(gen, 1, 4, B, m, C)
    cs = torch.clamp(cv[:, None] - _ints(gen, 0, 2, B, n, m, C), min=0)
    return (cv, cs, (cv > 1).to(torch.int32), miss, wact, arts,
            draw_write_chunks(prng.split(prng.prng_key(5, "cuda"), B), n,
                              C, 0.3).to(torch.int32))


@pytest.mark.parametrize("B,n,m,C,chunk,tokens,chain", [
    (1, 1, 1, 1, 16, 11, False), (37, 4, 3, 5, 16, 75, False),
    (100, 16, 16, 70, 16, 1115, False),
    (300, 16, 16, 64, 64, 4096, False),   # the fleet's rows
    (64, 16, 16, 64, 64, 4090, True),     # one artifact, fill and write
    (64, 40, 40, 64, 64, 4096, False),    # past the staged budget
    (3, 16, 16, 4096, 1, 4096, False),    # 1-token chunks: rows in tiles
    (1, 16, 16, 64, 64, 4096, False),     # B = 1
    (50, 4, 3, 6, 16, 96, False),         # the content goldens' rows:
    (50, 4, 3, 3, 40, 96, False),         # 96 tokens, 16- and 40-token
])
def test_chunk_kernel_equals_plain(gen, B, n, m, C, chunk, tokens, chain):
    """Every output of the tick equal to the plain version's, on the
    staged path and where it does not take the shape (n or m above 32,
    C no multiple of 4) on the direct path: ``plan`` says which ran."""
    staged = n <= 32 and m <= 32 and C % 4 == 0
    assert (chunk_diff.plan(n, m, C) > 0) == staged
    opts = dict(artifact_tokens=tokens, chunk_tokens=chunk)
    inputs = _chunk_inputs(gen, B, n, m, C, chain)
    launches = chunk_diff.chunk_tick_.launches
    out = chunk_diff.chunk_tick(*inputs, **opts)
    torch.cuda.synchronize()
    assert chunk_diff.chunk_tick_.launches == launches + 1
    plain = [t.clone() for t in inputs[:3]]
    plain += list(chunk_diff.chunk_tick_plain_(*plain, *inputs[3:], **opts))
    for got, exp in zip(out, plain):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("B,n,m,C", [(24576, 16, 16, 64), (1000, 16, 16, 70)])
def test_chunk_tick_repeated_launches_agree(gen, B, n, m, C):
    """50 launches of the in-place tick, each from the same inputs: every
    output equal to the first bit for bit."""
    inputs = _chunk_inputs(gen, B, n, m, C)
    opts = dict(artifact_tokens=64 * C - 7, chunk_tokens=64)

    def tick():
        state = [t.clone() for t in inputs[:3]]
        return state + list(chunk_diff.chunk_tick_(*state, *inputs[3:],
                                                   **opts))
    first = tick()
    for i in range(50):
        assert all(torch.equal(a, b) for a, b in zip(tick(), first)), i


#: the service's tick shapes: the staged path's top (B = n + 1 prefix
#: simulations at n = 32 clients), the direct path at n > 32, and the
#: content plane's one-simulation chunk tick
SERVICE_MESI_SHAPES = [(33, 32, 6), (49, 48, 6)]
SERVICE_CHUNK_SHAPE = (1, 32, 6, 64)


@pytest.mark.parametrize("B,n,m", SERVICE_MESI_SHAPES)
@pytest.mark.parametrize("eager,access_k", [(False, 0), (True, 0),
                                            (False, 3)])
def test_mesi_service_shapes_exact_and_repeated(gen, B, n, m, eager,
                                                access_k):
    """The tick at the service's shapes: equal to the plain version, and
    50 more launches from the same inputs equal to the first bit for
    bit."""
    assert (mesi_transition.plan(n, m) > 0) == (n <= 32)
    inputs = _mesi_inputs(gen, B, n, m)
    opts = dict(artifact_tokens=4096, eager=eager, access_k=access_k)

    def tick():
        state = [t.clone() for t in inputs[:4]]
        return state + list(mesi_transition.mesi_tick_(*state, *inputs[4:],
                                                       **opts))
    first = tick()
    plain = [t.clone() for t in inputs[:4]]
    plain += list(mesi_transition.mesi_tick_plain_(*plain, *inputs[4:],
                                                   **opts))
    assert all(torch.equal(a, b) for a, b in zip(first, plain))
    for i in range(50):
        assert all(torch.equal(a, b) for a, b in zip(tick(), first)), i


def test_chunk_service_shape_exact_and_repeated(gen):
    B, n, m, C = SERVICE_CHUNK_SHAPE
    inputs = _chunk_inputs(gen, B, n, m, C)
    opts = dict(artifact_tokens=64 * C, chunk_tokens=64)

    def tick():
        state = [t.clone() for t in inputs[:3]]
        return state + list(chunk_diff.chunk_tick_(*state, *inputs[3:],
                                                   **opts))
    first = tick()
    plain = [t.clone() for t in inputs[:3]]
    plain += list(chunk_diff.chunk_tick_plain_(*plain, *inputs[3:], **opts))
    assert all(torch.equal(a, b) for a, b in zip(first, plain))
    for i in range(50):
        assert all(torch.equal(a, b) for a, b in zip(tick(), first)), i


@pytest.mark.parametrize("strategy,chunk_tokens", [
    ("lazy", 64), ("eager", 0), ("access_count", 64)])
def test_decider_routes_agree_on_the_card(gen, strategy, chunk_tokens):
    """The decision layer's two routes on card-resident directories:
    equal decisions batch by batch, one tick launch (and with content one
    chunk tick launch) per kernel-route batch and none on the scan
    route."""
    import numpy as np
    from repro_torch.core import acs
    from repro_torch.service import BatchDecider
    n, m = 32, 6
    cfg = acs.ACSConfig(n_agents=n, n_artifacts=m, artifact_tokens=4096,
                        n_steps=1, strategy=acs.STRATEGY_CODES[strategy],
                        access_k=3, chunk_tokens=chunk_tokens)
    scan = BatchDecider(cfg, "scan", device="cuda")
    kernel = BatchDecider(cfg, "kernel", device="cuda")
    rng = np.random.default_rng(3)
    C = acs.content_chunks(cfg) if chunk_tokens else 0
    for step in range(12):
        acts = rng.random(n) < 0.7
        arts = rng.integers(0, m, n).astype(np.int32)
        writes = rng.random(n) < 0.3
        wc = (rng.random((n, C)) < 0.25) if C else None
        before = (mesi_transition.mesi_tick_.launches,
                  chunk_diff.chunk_tick_.launches)
        a = scan.decide(acts, arts, writes, write_chunks=wc)
        mid = (mesi_transition.mesi_tick_.launches,
               chunk_diff.chunk_tick_.launches)
        b = kernel.decide(acts, arts, writes, write_chunks=wc)
        after = (mesi_transition.mesi_tick_.launches,
                 chunk_diff.chunk_tick_.launches)
        assert mid == before
        assert (after[0] - mid[0], after[1] - mid[1]) == (1, int(bool(C)))
        np.testing.assert_array_equal(a.miss, b.miss)
        np.testing.assert_array_equal(a.version, b.version)
        assert a.ledger_delta == b.ledger_delta
        assert a.wire_delta == b.wire_delta
        if C:
            np.testing.assert_array_equal(a.fetched_chunks,
                                          b.fetched_chunks)
        np.testing.assert_array_equal(scan.host_state, kernel.host_state)
        np.testing.assert_array_equal(scan.host_version,
                                      kernel.host_version)
    for leaf in ("state", "version", "last_sync") + (
            ("chunk_version", "chunk_sync", "chunk_dirty") if C else ()):
        assert torch.equal(getattr(scan.arrays, leaf),
                           getattr(kernel.arrays, leaf)), leaf


def test_engine_routes_agree_on_the_card(gen):
    scn = dataclasses.replace(SCENARIOS["C"], n_runs=64)
    kern = run_scenario(scn, tick_backend="kernel")
    scan = run_scenario(scn, tick_backend="scan")
    assert (kern.per_run_total_tokens == scan.per_run_total_tokens).all()
    assert (kern.per_run_chr == scan.per_run_chr).all()
    w = zoo(n_agents=8, n_artifacts=6, n_runs=32, chunk_tokens=256)[0]
    kern = run_workload(w, tick_backend="kernel")
    scan = run_workload(w, tick_backend="scan")
    assert kern.stats.delta_bytes_mean == scan.stats.delta_bytes_mean
    assert (kern.per_run_total_tokens == scan.per_run_total_tokens).all()


# --- model kernels: fp32 within 1e-5 on unit-scale inputs, bf16 within
# --- one bf16 ulp (rmsnorm) or 1e-2 (attention) of the plain version

def _normal(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, exp, dtype, atol):
    assert got.dtype == exp.dtype and got.shape == exp.shape
    err = (got.float() - exp.float()).abs().max().item()
    assert err <= (1e-5 if dtype == torch.float32 else atol), err


def _rmsnorm_checked(x, w):
    """The kernel once (one launch) against the plain version: bf16
    within one bf16 ulp of the plain value, fp32 within 1e-5."""
    launches = rmsnorm.launches
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == launches + 1
    exp = rmsnorm_plain(x, w)
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if x.dtype == torch.bfloat16:
        # one bf16 ulp of the plain value: x = m * 2**e with m in
        # [0.5, 1) has 8 significant bits, so its ulp is 2**(e - 8)
        ulp = torch.ldexp(torch.ones_like(exp, dtype=torch.float32),
                          torch.frexp(exp.float()).exponent - 8)
        assert bool(((got.float() - exp.float()).abs() <= ulp).all())
    else:
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 32), (7, 128), (300, 2048),
                                   (2, 3, 5, 256), (4, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_equals_plain(gen, shape, dtype):
    _rmsnorm_checked(_normal(gen, *shape, dtype=dtype),
                     _normal(gen, shape[-1], dtype=dtype))


@pytest.mark.parametrize("d", [64, 100, 128, 2048, 8192])
@pytest.mark.parametrize("rows", [1, 4, 33, 2113])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_widths_rows_and_views(gen, d, rows, offset, dtype):
    """Every team width (a warp a row up to 4 KB of row, 2-8 warps up to
    d 8192), row counts that leave the persistent grid's teams uneven
    (2113 is no multiple of a block's 8 one-warp teams), and x as a view
    one element into its buffer (offset 1): no 16-byte aligned pointer,
    so the kernel reads and writes element by element, as it does at
    d = 100, a width that is no multiple of its vector."""
    x = _normal(gen, rows * d + offset, dtype=dtype)[offset:].view(rows, d)
    _rmsnorm_checked(x, _normal(gen, d, dtype=dtype))


def _bf16_row_err(got, exp):
    """max |got - exp| over one bf16 ulp of exp plus 2**-10 of the rms of
    exp's row (last axis): at most 1 when both round nearly the same fp32
    result, as chip_smoke.py's check_attention holds attention."""
    exp32 = exp.float()
    ulp = torch.where(exp32 == 0, 0.0, torch.ldexp(
        torch.ones_like(exp32), torch.frexp(exp32).exponent - 8))
    allow = ulp + 2.0 ** -10 * exp32.square().mean(dim=-1,
                                                    keepdim=True).sqrt()
    return float(((got.float() - exp32).abs() / allow).max())


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,lq,lk", [
    (1, 2, 2, 1, 1),          # one row, one key
    (2, 8, 1, 70, 70),        # ragged tails, MQA (group 8)
    (1, 4, 2, 33, 130),       # Lq < Lk causal, group 2
    (2, 2, 2, 128, 128),      # whole tiles
    (1, 8, 1, 1000, 1000),    # group 8 over 8 q blocks and 16 key tiles
    (2, 4, 2, 200, 777),      # Lq < Lk, both ragged
    (1, 2, 2, 2048, 2048),    # 16 q blocks, 32 key tiles round the ring
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain(gen, d, b, hq, hkv, lq, lk,
                                             dtype):
    """fp32 within 1e-5; bf16 within 1e-2 and, element by element, within
    one bf16 ulp plus 2**-10 of its row's rms (a kernel that rounds P to
    bf16 before P V fails that)."""
    q = _normal(gen, b, hq, lq, d, dtype=dtype)
    k = _normal(gen, b, hkv, lk, d, dtype=dtype)
    v = _normal(gen, b, hkv, lk, d, dtype=dtype)
    for causal in (True, False):
        launches = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == launches + 1
        exp = attention_plain(q, k, v, causal=causal)
        _close(got, exp, dtype, 1e-2)
        if dtype == torch.bfloat16:
            assert _bf16_row_err(got, exp) <= 1.0, (causal, d)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (1, 8, 1, 6144, 6144, 256),   # one agent's prefill: 2 ring stages
    (2, 4, 2, 200, 777, 256),     # ragged, Lq < Lk
    (2, 4, 2, 1000, 1000, 128),   # ragged, 4 ring stages
])
def test_flash_attention_repeated_launches_agree(gen, b, hq, hkv, lq, lk, d):
    """Causal bf16 launched 60 times: every output passes the row gate
    and equals the first bit for bit.  Each element is summed in a fixed
    order, so a difference means a ring stage was overwritten while a
    warpgroup still read it, which depends on timing and may spare any
    single launch."""
    q = _normal(gen, b, hq, lq, d, dtype=torch.bfloat16)
    k, v = (_normal(gen, b, hkv, lk, d, dtype=torch.bfloat16)
            for _ in range(2))
    exp = attention_plain(q, k, v, causal=True)
    first = flash_attention(q, k, v, causal=True)
    for i in range(60):
        got = flash_attention(q, k, v, causal=True) if i else first
        assert _bf16_row_err(got, exp) <= 1.0, i
        assert torch.equal(got, first), i


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "flash_wgmma"),
                                         (torch.float32, "flash_fp32")])
def test_flash_attention_type_chooses_the_kernel(gen, dtype, entry):
    """bf16 runs the tensor-core kernel, fp32 the CUDA-core one (whose
    products stay fp32, not TF32): one launch each, named by the
    profiler, within the type's limit of the plain version."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = (_normal(gen, 1, 4, 300, 128, dtype=dtype) for _ in range(3))
    launches = flash_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    names = [ev.key for ev in prof.key_averages() if "flash_" in ev.key]
    assert len(names) == 1 and entry in names[0], names
    _close(got, attention_plain(q, k, v), dtype, 1e-2)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,L", [
    (4, 8, 1, 6176),          # gemma-2b's serving shape
    (3, 2, 1, 100),           # group 2, ragged cache
    (2, 4, 4, 1),             # group 1, one key
    (1, 8, 2, 257),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_equals_plain(gen, d, b, hq, hkv, L, dtype):
    q = _normal(gen, b, hq, d, dtype=dtype)
    kc = _normal(gen, b, hkv, L, d, dtype=dtype)
    vc = _normal(gen, b, hkv, L, d, dtype=dtype)
    lens = torch.randint(1, L + 1, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    for kv_len in (None, lens):
        launches = decode_attention.launches
        got = decode_attention(q, kc, vc, kv_len)
        torch.cuda.synchronize()
        assert decode_attention.launches == launches + 1
        _close(got, decode_attention_plain(q, kc, vc, kv_len), dtype, 1e-2)


def _decode_checked(q, kc, vc, kv_len):
    """The kernel once (one launch) against the plain version: fp32
    within 1e-5, bf16 within 1e-2 and the row gate."""
    launches = decode_attention.launches
    got = decode_attention(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert decode_attention.launches == launches + 1
    exp = decode_attention_plain(q, kc, vc, kv_len)
    _close(got, exp, q.dtype, 1e-2)
    if q.dtype == torch.bfloat16:
        assert _bf16_row_err(got, exp) <= 1.0
    return got


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,L", [
    (3, 8, 1, 1000),          # group 8 (MQA)
    (2, 6, 2, 300),           # group 3
    (3, 5, 5, 130),           # group 1 (MHA)
    (2, 8, 2, 777),           # group 4
    (1, 7, 1, 6176),          # group 7, gemma-2b's cache length
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kv_len_edges(gen, d, b, hq, hkv, L, dtype):
    """kv_len 1, 63, 64, 65, on the launch's split boundary and one past
    it, L, above L (masks nothing) and None, the other batch rows a few
    keys shorter: the split that holds the last key, the tile that holds
    it and the merge of the splits before it."""
    q = _normal(gen, b, hq, d, dtype=dtype)
    kc = _normal(gen, b, hkv, L, d, dtype=dtype)
    vc = _normal(gen, b, hkv, L, d, dtype=dtype)
    split_keys = plan(b, hq, hkv, L, d, dtype, q.device)[0]
    for n in (1, 63, 64, 65, split_keys, split_keys + 1, L, L + 7, None):
        lens = None if n is None else torch.tensor(
            [n] + [max(1, n - 3 * i) for i in range(1, b)],
            dtype=torch.int32, device="cuda")
        _decode_checked(q, kc, vc, lens)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_zero_kv_len_is_nan_as_plain(gen, d, dtype):
    """kv_len 0 masks every key, and the kernel writes NaN rows exactly
    where the plain version's softmax over no key gives NaN (the
    reference's 0/0); the other rows pass the usual gates."""
    q = _normal(gen, 4, 4, d, dtype=dtype)
    kc, vc = (_normal(gen, 4, 2, 300, d, dtype=dtype) for _ in range(2))
    lens = torch.tensor([0, 17, 0, 300], dtype=torch.int32, device="cuda")
    got = decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    exp = decode_attention_plain(q, kc, vc, lens)
    assert bool(exp[[0, 2]].isnan().all()) and not bool(
        exp[[1, 3]].isnan().any())
    assert torch.equal(got.isnan(), exp.isnan())
    _close(got[[1, 3]], exp[[1, 3]], dtype, 1e-2)
    if dtype == torch.bfloat16:
        assert _bf16_row_err(got[[1, 3]], exp[[1, 3]]) <= 1.0


@pytest.mark.parametrize("b,hq,hkv,L,d", [
    (4, 8, 1, 6176, 256),     # gemma-2b's batched decode
    (1, 8, 1, 6176, 256),     # one agent: 97 splits, two merge levels
    (8, 16, 8, 2048, 128),
])
def test_decode_attention_repeated_launches_agree(gen, b, hq, hkv, L, d):
    """bf16 launched 60 times over ragged lengths: every output passes
    the gates and equals the first bit for bit.  The splits finish in
    any order, so an output that changed would mean a merge that did not
    run in split order or a ticket not back at 0."""
    q = _normal(gen, b, hq, d, dtype=torch.bfloat16)
    kc, vc = (_normal(gen, b, hkv, L, d, dtype=torch.bfloat16)
              for _ in range(2))
    lens = torch.randint(L // 2, L + 1, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    first = _decode_checked(q, kc, vc, lens)
    for i in range(60):
        assert torch.equal(decode_attention(q, kc, vc, lens), first), i


def test_decode_attention_on_two_streams_at_once(gen):
    """bf16 decode calls queued on two streams at once, 30 on each, over
    different inputs, each launch merging its splits behind tickets:
    every output equals its inputs' first output bit for bit, so the
    streams' launches never take each other's tickets."""
    b, hq, hkv, L, d = 4, 8, 1, 6176, 256
    inputs = []
    for _ in range(2):
        q = _normal(gen, b, hq, d, dtype=torch.bfloat16)
        kc, vc = (_normal(gen, b, hkv, L, d, dtype=torch.bfloat16)
                  for _ in range(2))
        lens = torch.randint(L // 2, L + 1, (b,), generator=gen,
                             device="cuda", dtype=torch.int32)
        inputs.append((q, kc, vc, lens))
    assert plan(b, hq, hkv, L, d, torch.bfloat16, "cuda")[3] > 0
    firsts = [_decode_checked(*args) for args in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    outs = [[], []]
    torch.cuda.synchronize()
    for _ in range(30):
        for stream, args, got in zip(streams, inputs, outs):
            with torch.cuda.stream(stream):
                got.append(decode_attention(*args))
    torch.cuda.synchronize()
    for got, first in zip(outs, firsts):
        for i, out in enumerate(got):
            assert torch.equal(out, first), i


#: one decode call per kv_len under the profiler, in a fresh process: in a
#: process that had already run a device-only profiler session, a later
#: session recorded no device kernel of the cluster launch
_PROFILE_DECODE = """
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.decode_attention import decode_attention
gen = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn((4, 8, 256), generator=gen, device="cuda").bfloat16()
kc, vc = (torch.randn((4, 1, 3000, 256), generator=gen,
                      device="cuda").bfloat16() for _ in range(2))
lens = torch.tensor([2999, 3000, 3100, 17], dtype=torch.int32, device="cuda")
decode_attention(q, kc, vc, lens)    # built, planned, attributes set
torch.cuda.synchronize()
found = []
for kv_len in (lens, None):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_attention(q, kc, vc, kv_len)
        torch.cuda.synchronize()
    found.append([ev.name for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA
                  and not ev.is_user_annotation])
print(json.dumps(found))
"""


def test_decode_attention_launches_only_its_kernel(gen):
    """A call is one launch of the port's kernel and nothing else: no
    clamp, cast or fill of kv_len, no merge launch (the profiler sees one
    device kernel), with and without kv_len."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(src), env.get("PYTHONPATH")) if p)
    run = subprocess.run([sys.executable, "-c", _PROFILE_DECODE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    for kernels in json.loads(run.stdout.strip().splitlines()[-1]):
        assert len(kernels) == 1 and "decode_kernel" in kernels[0], kernels


def test_decode_attention_refuses_what_it_does_not_take(gen):
    q = _normal(gen, 2, 4, 64)
    kc = _normal(gen, 2, 2, 50, 64)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, kc, kc, torch.tensor([3, 50], device="cuda"))
    with pytest.raises(ValueError, match="query group"):
        decode_attention(_normal(gen, 2, 18, 64), kc, kc)
    with pytest.raises(RuntimeError, match="launch failed"):
        # a cache 4 bytes into its buffer: the kernel's 16-byte copies
        # refuse it
        kc_off = _normal(gen, kc.numel() + 1)[1:].view(kc.shape)
        decode_attention(q, kc_off, kc_off)


# --- rwkv6_scan: the final state bit for bit (the kernel rounds where the
# --- plain version's ops do); y in fp32 within 1e-5 of the rms of its
# --- head's output over the sequence, and in bf16 within one bf16 ulp of
# --- the plain value plus 2**-10 of its row's rms.  Not 1e-5 of the row's
# --- own rms in fp32: early in a sequence the state has low rank and a
# --- row of y is a sum that cancels, so even the plain version lies up to
# --- 1e-4 of such a row's rms from the same sum taken in fp64.

def _wkv_inputs(gen, b, t, h, dh, dtype, state):
    r, k, v = (_normal(gen, b, t, h, dh, dtype=dtype) for _ in range(3))
    # the model's decay range: exp(-exp(U(-8, -5)))
    w = torch.exp(-torch.exp(torch.rand((b, t, h, dh), generator=gen,
                                        device="cuda") * 3 - 8)).to(dtype)
    bonus = _normal(gen, h, dh) * 0.1
    s0 = _normal(gen, b, h, dh, dh) if state else None
    return r, k, v, w, bonus, s0


def _wkv_err(got, exp):
    """max |got - exp| over each element's allowance, y (B, T, H, dh):
    in fp32 1e-5 of the rms of its (b, h) head over T and dh; in bf16 one
    bf16 ulp of exp plus 2**-10 of its row's rms."""
    if exp.dtype != torch.float32:
        return _bf16_row_err(got, exp)
    exp32 = exp.float()
    allow = 1e-5 * exp32.square().mean(dim=(1, 3), keepdim=True).sqrt()
    return float(((got.float() - exp32).abs() / allow).max())


@pytest.mark.parametrize("b,t,h,dh,state", [
    (1, 1, 1, 64, False),       # one step
    (4, 1, 32, 64, True),       # a decode step of rwkv6-1.6b
    (2, 37, 3, 32, True),       # ragged T (not a multiple of the stage)
    (1, 200, 2, 32, False),     # the smoke configs' head size
    (2, 1000, 8, 64, False),
    (1, 6144, 32, 64, False),   # one agent's prefill of rwkv6-1.6b
    (4, 6144, 32, 64, False),   # its batched prefill
    (1, 77, 1, 64, True),       # B*H below the column split
    (1, 45, 1, 32, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel_equals_plain(gen, b, t, h, dh, state, dtype):
    args = _wkv_inputs(gen, b, t, h, dh, dtype, state)
    launches = rwkv6_scan.launches
    y, s = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == launches + 1
    ey, es = rwkv6_scan_plain(*args)
    assert y.dtype == dtype and s.dtype == torch.float32
    assert y.shape == ey.shape and s.shape == es.shape
    assert torch.equal(s, es)
    assert _wkv_err(y, ey) <= 1.0


@pytest.mark.parametrize("b,t,h,dh", [(4, 6144, 32, 64), (1, 6144, 32, 64),
                                     (4, 1, 32, 64), (3, 77, 5, 32)])
def test_rwkv6_scan_repeated_launches_agree(gen, b, t, h, dh):
    """fp32 launched 50 times more: y and the final state equal to the
    first launch's bit for bit (a stage of the ring refilled too early, or
    partial sums read before they are complete, would show in some
    launches and not others)."""
    args = _wkv_inputs(gen, b, t, h, dh, torch.float32, True)
    y, s = rwkv6_scan(*args)
    for i in range(50):
        y2, s2 = rwkv6_scan(*args)
        assert torch.equal(y2, y) and torch.equal(s2, s), i


def test_rwkv6_scan_cpu_tensors_never_reach_the_kernel(gen):
    args = [None if a is None else a.cpu()
            for a in _wkv_inputs(gen, 1, 5, 2, 64, torch.float32, True)]
    launches = rwkv6_scan.launches
    y, s = rwkv6_scan(*args)
    assert rwkv6_scan.launches == launches
    assert y.device.type == "cpu" and s.device.type == "cpu"
    with pytest.raises(ValueError, match="one CUDA device"):
        rwkv6_scan(args[0].cuda(), *args[1:])
