"""The RMSNorm backward's launch plan (``kernels.rmsnorm.bwd_plan``), on
the CPU: the grid's row ranges, the ring's shared memory and bulk
copies, and the partial rows of dweight.  The kernel itself runs only
on a card (``tests/test_torch_cuda.py``); here its CPU route runs the
plain version and counts no launch.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_bwd_plain  # noqa: E402

pytestmark = pytest.mark.torch

#: widths from one element to the widest row, in both types
WIDTHS = [1, 3, 8, 64, 100, 128, 256, 1000, 2048, 2052, 4096, 4100, 6144,
          8192]
#: an mbarrier counts at most 2**20 - 1 bytes of a phase
MAX_TX = (1 << 20) - 1


@pytest.mark.parametrize("rows", [1, 5, 131, 264, 1001, 8191, 8192, 131072])
@pytest.mark.parametrize("blocks", [1, 132, 264])
def test_row_ranges_take_every_row_once_in_order(rows, blocks):
    """Concatenated in block order, the ranges are the rows in order;
    their lengths differ by at most one."""
    ranges = [trms.row_range(b, rows, blocks) for b in range(blocks)]
    assert [r for rng in ranges for r in rng] == list(range(rows))
    sizes = {len(rng) for rng in ranges}
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms", [1, 132])
def test_ring_fits_shared_memory(d, itemsize, sms):
    """A block's shared memory fits 227 KB and the blocks an SM fit its
    228 KB with 1 KB reserved each; the ring has two stages or more, and
    the grid is the blocks an SM times the SMs."""
    plan = trms.bwd_plan(d, itemsize, sms)
    assert plan.stages >= 2 and plan.rows_per_stage >= 1
    assert plan.smem_bytes == trms.bwd_smem(d, itemsize, plan.rows_per_stage,
                                            plan.stages)
    assert plan.smem_bytes <= trms.MAX_BLOCK_SMEM
    assert plan.blocks_per_sm * (plan.smem_bytes + trms.BLOCK_RESERVED_SMEM) \
        <= trms.SM_SMEM
    assert plan.blocks == plan.blocks_per_sm * sms


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_bulk_copies_are_whole_vectors_under_the_barriers_limit(d, itemsize):
    """Where rows go by bulk copy (a row's bytes a multiple of 16), each
    copy of k <= rows_per_stage rows is a multiple of 16 bytes, and a
    stage's two copies stay under the mbarrier's byte count; a stage
    holds about ``BWD_STAGE_BYTES`` unless a row alone is larger."""
    plan = trms.bwd_plan(d, itemsize, 132)
    row = d * itemsize
    stage = 2 * plan.rows_per_stage * row
    if row % 16 == 0:
        assert all(k * row % 16 == 0
                   for k in range(1, plan.rows_per_stage + 1))
    assert stage <= MAX_TX
    assert stage <= trms.BWD_STAGE_BYTES or plan.rows_per_stage == 1
    assert (plan.rows_per_stage == trms.BWD_MAX_STAGE_ROWS
            or 2 * stage > trms.BWD_STAGE_BYTES)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_partial_rows_equal_the_grid(d, itemsize):
    plan = trms.bwd_plan(d, itemsize, 132)
    assert plan.scratch_floats == plan.blocks * d
    assert plan.blocks <= 264 < 1024


def test_plan_at_the_training_widths():
    """bf16 d 2048 (gemma-2b, rwkv6-1.6b): 4 rows a stage, 3 stages, two
    blocks an SM, 264 partial rows on 132 SMs; the qk-norm width d 128:
    64 rows a stage; fp32 d 8192: one block an SM, one row a stage."""
    assert trms.bwd_plan(2048, 2, 132)[:4] == (264, 4, 3, 2)
    assert trms.bwd_plan(128, 2, 132)[:4] == (264, 64, 3, 2)
    assert trms.bwd_plan(8192, 4, 132)[:4] == (132, 1, 3, 1)


@pytest.mark.parametrize("cast_first", [False, True])
def test_cpu_route_runs_the_plain_backward(cast_first):
    gen = torch.Generator().manual_seed(0)
    x, dy = (torch.randn(7, 48, generator=gen) for _ in range(2))
    w = torch.randn(48, generator=gen)
    before = trms.rmsnorm_bwd.launches
    got = trms.rmsnorm_bwd(x, w, dy, cast_first=cast_first)
    for g, e in zip(got, rmsnorm_bwd_plain(x, w, dy,
                                           cast_first=cast_first)):
        assert torch.equal(g, e)
    assert trms.rmsnorm_bwd.launches == before
