"""The launch plans of linprog_tpu_torch's whole-segment kernels (kernel 1,
``solve_segment``, and kernel 4, ``solve_bounded_segment``), as pure
functions of the batch, the lane shape and the card's SM count and
shared-memory limit.  No card is needed: the plan is what the wrapper hands
to the C entry point, so its arithmetic is held here."""

import pytest
import torch

from linprog_tpu_torch.ops import bounded_kernel as bk
from linprog_tpu_torch.ops import solve_kernel as sk

KERNELS = {"segment": sk, "bounded": bk}
# the shapes the paths launch (B, m, n with the slack and artificial
# columns): the router's two-phase simplex at m = 128, the crossover, the
# two-phase simplex, the warm re-solve and the bounded leg at m = 256, the
# router's ipm+crossover, the recovery bucket at m = 512, and calibrate()'s
# grid at 64 lanes
LAUNCHED = [(1024, 128, 384), (1024, 256, 512), (256, 256, 512),
            (64, 512, 1024), (64, 128, 384), (64, 160, 480), (64, 192, 576),
            (64, 256, 512)]
BATCHES = [1, 8, 64, 256, 1024, 4096]


def _slice(size, cluster):
    # a CTA's slice: 16 / cluster whole bands of a sixteenth of the lane
    return (16 // cluster) * -(-size // 16)


def _r4(v):
    return -(-v // 4) * 4


def _bytes(kernel, m, n, cl):
    # the CTA's rows of A and of the factor, the whole vectors, its partials
    # and three slices of its rows
    # (kernel 4 keeps its variable states as bytes, after the floats)
    ml = _slice(m, cl)
    if kernel == "segment":
        return 4 * (_r4(ml * n) + _r4(ml * m) + _r4(6 * m + 5 * n + 3 * ml))
    return (4 * (_r4(ml * n) + _r4(ml * m) + _r4(8 * m + 4 * n + 3 * ml))
            + 16 * -(-n // 16))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("B,m,n", LAUNCHED, ids=lambda v: str(v))
def test_plans_at_the_launched_shapes_fit_a_block(kernel, B, m, n):
    """Every candidate at every launched shape is a built cluster size (the
    cluster-resident branch) whose CTA holds its rows of A and the factor
    and the lane's vectors within the 232,448 bytes a block may use."""
    mod = KERNELS[kernel]
    plans = mod.segment_plans(B, m, n)
    assert plans and len({p.cluster for p in plans}) == len(plans)
    for p in plans:
        assert p.cluster in (1, 2, 4, 8, 16)
        assert p.smem_bytes == _bytes(kernel, m, n, p.cluster)
        assert p.smem_bytes + 1024 <= 232448


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("B,m,n,cluster", [
    (1024, 128, 384, 2), (1024, 256, 512, 4), (256, 256, 512, 4),
    (64, 512, 1024, 16), (64, 128, 384, 2), (8, 128, 384, 16)])
def test_first_candidate_at_the_launched_shapes(kernel, B, m, n, cluster):
    """The first candidate: the largest cluster that keeps the batch within
    the card's SMs, else the smallest that holds the lane (4 CTAs a lane of
    768 KB at m = 256, 16 for the recovery bucket's 3 MB lanes)."""
    assert KERNELS[kernel].segment_plans(B, m, n)[0].cluster == cluster


@pytest.mark.parametrize("size", [1, 5, 16, 37, 100, 256, 384, 512, 1000, 1023])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_slices_are_whole_bands_at_every_cluster_size(size, cluster):
    """A CTA's slice is whole bands of a sixteenth of the lane, so the
    bands, and with them the order of every sum, are the same at every
    cluster size; the slices cover the lane."""
    band = sk.slice_len(size, 16)
    assert band == -(-size // 16) and 16 * band >= size > 16 * (band - 1)
    assert sk.slice_len(size, cluster) == (16 // cluster) * band
    assert cluster * sk.slice_len(size, cluster) >= size


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("m,n", [(8, 24), (37, 87), (128, 384), (256, 512),
                                 (512, 1024), (528, 1056), (532, 1064),
                                 (1024, 2048), (1180, 2360)],
                         ids=lambda v: str(v))
def test_branch_depends_on_the_lane_shape_only(kernel, m, n):
    """Every batch size gives the same branch and the same set of cluster
    sizes at (m, n) (only their order follows the batch), so a lane's
    result does not depend on its batch; past the largest cluster the one
    plan is the block-per-lane branch."""
    mod = KERNELS[kernel]
    resident = sk.resident(m, n, cbytes=mod.cluster_bytes)
    sizes = None
    for B in BATCHES:
        plans = mod.segment_plans(B, m, n)
        assert (plans[0].cluster > 0) == resident
        if not resident:
            assert plans == [sk.SegmentPlan(0, mod.block_bytes(m, n))]
        got = sorted(p.cluster for p in plans)
        assert sizes is None or got == sizes
        sizes = got
    if m <= 512:
        assert resident
    if m >= 1024:
        assert not resident


def test_devex_changes_only_the_block_branch():
    """The cluster-resident layout holds the devex weights in every mode;
    the block-per-lane branch takes a fifth row of n floats for them."""
    assert sk.segment_plans(64, 256, 512, devex=True) == \
        sk.segment_plans(64, 256, 512)
    (blk,) = sk.segment_plans(8, 1024, 2048, devex=True)
    assert blk.cluster == 0 and blk.smem_bytes == 4 * (7 * 1024 + 5 * 2048)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plans_raise_for_a_lane_that_fits_no_branch(kernel):
    """A lane whose vectors alone pass a block's shared memory raises; so
    does an empty shape."""
    mod = KERNELS[kernel]
    with pytest.raises(ValueError, match="shared memory"):
        mod.segment_plans(8, 4096, 12288)
    with pytest.raises(ValueError, match=">= 1"):
        mod.segment_plans(0, 8, 8)


def test_plans_follow_the_card():
    """A smaller shared-memory limit pushes a lane to larger clusters, or to
    the block-per-lane branch; more SMs let a batch take larger clusters."""
    assert sk.segment_plans(1024, 256, 512, smem_limit=150 * 1024)[0].cluster == 8
    assert sk.segment_plans(8, 512, 1024, smem_limit=150 * 1024)[0].cluster == 0
    assert sk.segment_plans(64, 256, 512, sm_count=264)[0].cluster == 4
    assert sk.segment_plans(64, 128, 384, sm_count=264)[0].cluster == 4


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_wrapper_takes_the_plain_version_on_the_cpu_whatever_the_size(kernel):
    """On a CPU tensor the plain version runs, whatever the plan would say,
    and nothing counts as a launch; ``launch_with_plan`` refuses a CPU
    tensor."""
    m, n, B = 4, 8, 2
    A = torch.zeros((B, m, n))
    common = dict(invBT=torch.eye(m).expand(B, m, m).clone(),
                  bfs=torch.ones((B, m)), cB=torch.zeros((B, m)),
                  basis=torch.arange(n - m, n, dtype=torch.int32)
                  .expand(B, m).clone(),
                  iters=torch.zeros(B, dtype=torch.int32),
                  status=torch.zeros(B, dtype=torch.int32))
    plan = KERNELS[kernel].segment_plans(B, m, n)[0]
    before = KERNELS[kernel].launches
    if kernel == "segment":
        state = sk.SegmentState(pen=torch.zeros((B, n)),
                                gamma=torch.ones((B, n)), **common)
        z = torch.zeros((B, n))
        out = sk.solve_segment(A, z, z, 4, state, seg_len=4, pricing=1,
                               opt_tol=1e-6, pivot_tol=1e-7)
        with pytest.raises(ValueError, match="CUDA"):
            sk.launch_with_plan(plan, A, z, z, 4, state, seg_len=4,
                                pricing=1, opt_tol=1e-6, pivot_tol=1e-7)
    else:
        vs = torch.zeros((B, n), dtype=torch.int8)
        vs[:, n - m:] = bk.BASIC
        state = bk.BoundedSegmentState(
            vstate=vs, lbB=torch.zeros((B, m)), ubB=torch.full((B, m), 9.0),
            **common)
        z = torch.zeros((B, n))
        out = bk.solve_bounded_segment(A, z, z, z + 9.0, 4, state, seg_len=4,
                                       opt_tol=1e-6, pivot_tol=1e-7)
        with pytest.raises(ValueError, match="CUDA"):
            bk.launch_with_plan(plan, A, z, z, z + 9.0, 4, state, seg_len=4,
                                opt_tol=1e-6, pivot_tol=1e-7)
    assert out.status.tolist() == [1, 1]
    assert KERNELS[kernel].launches == before
