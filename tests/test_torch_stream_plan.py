"""The launch plan of linprog_tpu_torch's streaming kernel, as a pure
function of the batch, the lane shape and the card's SM count and
shared-memory limit.  No card is needed: the plan is what the wrapper hands
to the C entry point, so its arithmetic is held here."""

import pytest
import torch

from linprog_tpu_torch.ops import plans as pl
from linprog_tpu_torch.ops import stream_kernel as ssk
from linprog_tpu_torch.ops.solve_kernel import SegmentState

# every shape the routes produce: crossover and fallback at m = 2048, the
# two-phase shape at m = 1024, a ragged one, the boundary of the streaming
# regime, and the largest two-phase shape
SHAPES = [(2048, 4096), (2048, 6144), (1024, 3072), (1000, 2999),
          (700, 1400), (4096, 12288)]
BATCHES = [1, 8, 64, 1024]


def _vector_floats(m, n, cluster, dual):
    # a block's slice: 8 / cluster whole bands of an eighth of the lane
    ml = (8 // cluster) * -(-m // 8)
    nl = (8 // cluster) * -(-n // 8)
    floats = 3 * m + max(m, n) + (n if dual else 0) + 5 * ml + 4 * nl
    return -(-floats // 4) * 4


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("m,n", SHAPES, ids=lambda v: str(v))
def test_stream_plans_fit_the_card(m, n, B, dual):
    """Every candidate stays within a block's shared memory (a plan counts
    on one block per SM: its planned residency is 1, and what more the card
    holds is the occupancy query's to say), holds the lane's vectors and
    both views of its ring, takes the bulk-copy branch only where every row starts and
    ends on a multiple of 4 floats, and keeps every copy 16-byte sized."""
    plans = ssk.stream_plans(B, m, n, dual=dual)
    assert plans and len({p.cluster for p in plans}) == len(plans)
    aligned = m % 4 == 0 and n % 4 == 0
    for p in plans:
        assert p.smem_bytes + 2048 <= pl.SMEM_LIMIT
        assert p.aligned == aligned
        vec = 4 * _vector_floats(m, n, p.cluster, dual)
        if not p.aligned:
            assert p.cluster == 8  # the scalar branch's size
            assert p.smem_bytes == vec
            assert (p.stages, p.stage_floats, p.warp_stages,
                    p.chunk_floats) == (0, 0, 0, 0)
            continue
        assert p.cluster in (8, 2)
        ring = (p.smem_bytes - vec) // 4
        assert 2 <= p.stages <= 8 and 1 <= p.warp_stages <= 4
        assert p.stages * p.stage_floats <= ring
        assert 8 * p.warp_stages * p.chunk_floats <= ring
        assert p.stage_floats % 4 == 0 and p.chunk_floats % 4 == 0
        # a row streams in chunks whose lane-strided sums keep their order
        assert p.chunk_floats >= m or p.chunk_floats % 32 == 0
        # a sweep of a column pass is one 16-byte-multiple copy per row
        sweep = min(p.stage_floats, 2048) // 4 * 4
        assert sweep >= 4 and (n % sweep) % 4 == 0 and (m % sweep) % 4 == 0


@pytest.mark.parametrize("B,first", [(1, 8), (7, 8), (8, 8), (16, 8),
                                     (32, 2), (64, 2), (1024, 2)])
def test_stream_plans_prefer_one_block_per_sm(B, first):
    """The first candidate is the largest built cluster size that keeps
    the batch within the card's SMs (8 blocks a lane for the fallback's
    bucket of 8, 2 for a batch of 64); the other follows.  The wrapper then
    takes the first with the fewest waves of resident clusters."""
    sizes = [p.cluster for p in ssk.stream_plans(B, 2048, 6144)]
    assert sizes[0] == first
    assert sizes[1:] == [cl for cl in (8, 2) if cl != first]
    assert [p.cluster for p in ssk.stream_plans(B, 2048, 6144,
                                                sm_count=264)][0] >= first


def test_stream_plans_ragged_shape_takes_the_scalar_branch():
    for B in BATCHES:
        plans = ssk.stream_plans(B, 1000, 2999)
        assert [p.cluster for p in plans] == [8]
        assert not any(p.aligned for p in plans)
    assert pl.slices_aligned(1000, 3000) and not pl.slices_aligned(1000, 2999)
    assert not pl.slices_aligned(1002, 3000)
    assert ssk.scalar_plan(2, 1000, 2999) is None  # not built for 2 blocks
    assert ssk.scalar_plan(8, 1000, 2999, dual=True).smem_bytes == \
        4 * _vector_floats(1000, 2999, 8, True)


def test_stream_plans_shrink_the_ring_before_they_give_up():
    """A lane whose vectors leave little room gets a smaller ring; one
    whose vectors alone pass a block's shared memory raises."""
    big = ssk.stream_plans(8, 2048, 6144)[0]
    tight = ssk.stream_plans(8, 4096, 12288, dual=True)
    assert big.cluster == 8 and big.stages * big.stage_floats * 4 == 128 * 1024
    assert all(p.smem_bytes - 4 * _vector_floats(4096, 12288, p.cluster, True)
               < 128 * 1024 for p in tight)
    assert ssk.stream_plans(8, 2048, 6144, smem_limit=100 * 1024)[0].smem_bytes \
        < 100 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        ssk.stream_plans(8, 16384, 40000)
    with pytest.raises(ValueError, match=">= 1"):
        ssk.stream_plans(0, 8, 8)


def test_stream_wrapper_raises_for_a_lane_past_shared_memory_on_any_device():
    """The wrapper's CUDA branch plans before it launches; the plan's
    refusal is the ValueError a caller of a lane too large sees.  On a CPU
    tensor the plain version runs whatever the size."""
    m, n, B = 4, 8, 2
    A = torch.zeros((B, m, n))
    state = SegmentState(
        invBT=torch.eye(m).expand(B, m, m).clone(), bfs=torch.ones((B, m)),
        cB=torch.zeros((B, m)),
        basis=torch.arange(n - m, n, dtype=torch.int32).expand(B, m).clone(),
        pen=torch.zeros((B, n)), gamma=torch.ones((B, n)),
        iters=torch.zeros(B, dtype=torch.int32),
        status=torch.zeros(B, dtype=torch.int32))
    out = ssk.solve_segment_stream(A, torch.zeros((B, n)), torch.zeros((B, n)),
                                   4, state, seg_len=4, pricing=1,
                                   opt_tol=1e-6, pivot_tol=1e-7)
    assert out.status.tolist() == [1, 1] and ssk.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        ssk.launch_with_plan(ssk.stream_plans(B, m, n)[0], A,
                             torch.zeros((B, n)), torch.zeros((B, n)), 4,
                             state, seg_len=4, pricing=1, opt_tol=1e-6,
                             pivot_tol=1e-7)
