"""The launch plans of linprog_tpu_torch's whole-segment kernels (kernel 1,
``solve_segment``, and kernel 4, ``solve_bounded_segment``), as pure
functions of the batch, the lane shape and the card's SM count and
shared-memory limit.  No card is needed: the plan is what the wrapper hands
to the C entry point, so its arithmetic is held here."""

import pytest
import torch

from linprog_tpu_torch.ops import bounded_kernel as bk
from linprog_tpu_torch.ops import plans as pl
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


# (bands, size, cluster): the resident branches' 16 bands at every built
# cluster size, the streaming branches' 8 at 2 CTAs a lane
BAND_CASES = ([(16, size, cluster)
               for size in (1, 5, 16, 37, 100, 256, 384, 512, 1000, 1023)
               for cluster in (1, 2, 4, 8, 16)]
              + [(8, size, 2)
                 for size in (1, 5, 8, 100, 1000, 2048, 2999, 6144)])


@pytest.mark.parametrize("bands,size,cluster", BAND_CASES)
def test_slices_are_whole_bands_at_every_cluster_size(bands, size, cluster):
    """A CTA's slice is whole bands of a sixteenth of the lane (the
    cluster-resident branches) or of an eighth (the streaming branches),
    so the bands, and with them the order of every sum, are the same at
    every cluster size; the slices cover the lane."""
    slice_len = {16: pl.slice_len, 8: pl.band_slice_len}[bands]
    band = slice_len(size, bands)
    assert band == -(-size // bands)
    assert bands * band >= size > bands * (band - 1)
    assert slice_len(size, cluster) == (bands // cluster) * band
    assert cluster * slice_len(size, cluster) >= size


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("m,n", [(8, 24), (37, 87), (128, 384), (256, 512),
                                 (512, 1024), (528, 1056), (532, 1064),
                                 (1024, 2048), (1180, 2360)],
                         ids=lambda v: str(v))
def test_branch_depends_on_the_lane_shape_only(kernel, m, n):
    """Every batch size gives the same branch and the same set of cluster
    sizes at (m, n) (only their order follows the batch), so a lane's
    result does not depend on its batch; past the largest cluster the plans
    of both kernels are all of their streaming branches (which replaced
    their blocks per lane)."""
    mod = KERNELS[kernel]
    resident = pl.resident(m, n, mod.cluster_bytes)
    sizes = None
    for B in BATCHES:
        plans = mod.segment_plans(B, m, n)
        streaming = [isinstance(p, pl.StreamingPlan) for p in plans]
        assert all(streaming) if not resident else not any(streaming)
        if kernel == "segment" and not resident:
            assert set(plans) == set(sk.segment_plans(1, m, n))
        got = sorted(p.cluster for p in plans)
        assert sizes is None or got == sizes
        sizes = got
    if m <= 512:
        assert resident
    if m >= 1024:
        assert not resident


# kernel 4's streaming branch (past the largest cluster): shapes that took
# the block-per-lane branch it replaced, aligned and not, the phase 16
# shape among them
STREAMED = [(1024, 2048), (1180, 2360), (1279, 2558), (1280, 2560),
            (2000, 4000), (3044, 6088), (3045, 6090), (2048, 1024),
            (5000, 2000), (600, 9000)]


def _old_block_line(m, n):
    # the block-per-lane branch's vectors: 9m + 5n floats in one block
    return 4 * (9 * m + 5 * n) + 1024 <= 232448


@pytest.mark.parametrize("ratio", [0.25, 0.5, 1, 2, 3, 5])
def test_bounded_has_plan_is_the_block_branch_line(ratio):
    """Whether kernel 4 takes a lane is what it was before the streaming
    branch replaced the block per lane: the cluster-resident branch, or the
    block branch's line (m ~ 3000 at n = 2m), up to it and past it."""
    for m in range(1, 7000, 13):
        n = max(1, int(m * ratio))
        want = (pl.resident(m, n, bk.cluster_bytes)
                or _old_block_line(m, n))
        assert bk.has_plan(m, n) == want, (m, n)
        if not want:
            with pytest.raises(ValueError, match="shared memory"):
                bk.segment_plans(16, m, n)


def _stream_bytes(m, n, cl, plan):
    # d, u, c_B whole, the partial over max(m, n), seven slices of m and
    # five of n (whole bands of an eighth of the lane); then the ring: the
    # warps' view, which the block's view of four stages fits into
    ml, nl = (8 // cl) * -(-m // 8), (8 // cl) * -(-n // 8)
    vec = 4 * _r4(3 * m + max(m, n) + 7 * ml + 5 * nl)
    return vec + 4 * 8 * plan.warp_stages * plan.chunk_floats


@pytest.mark.parametrize("m,n", STREAMED, ids=lambda v: str(v))
def test_bounded_streaming_plans_fit_and_take_whole_bands(m, n):
    """Every shape the block-per-lane branch took gets plans of the
    streaming branch only: 4 and 8 CTAs a lane, bulk-copy rings where the
    rows are 16-byte aligned (a ring that fills the SM at 4 and 8, half of
    it for two CTAs an SM at 8), scalar loads otherwise; each CTA's bytes
    fit the 232,448 a block may use less its static part (two CTAs an SM:
    half of the SM's 228 KB less the card's 1 KB a block); its slices are
    whole bands of an eighth of the lane, which cover it."""
    assert not pl.resident(m, n, bk.cluster_bytes)
    assert _old_block_line(m, n)
    plans = bk.segment_plans(16, m, n)
    aligned = m % 4 == 0 and n % 4 == 0
    assert all(isinstance(p, pl.StreamingPlan) for p in plans)
    assert {p.aligned for p in plans} == {aligned}
    if aligned:
        # two CTAs an SM where half the SM holds a CTA's vectors and a ring
        layouts = {(p.cluster, p.ctas_per_sm) for p in plans}
        assert {(4, 1), (8, 1)} <= layouts <= {(4, 1), (8, 1), (8, 2)}
        smallest = pl.StreamingPlan(8, True, 4, 0, 2, min(256, m), 0, 2)
        half = _stream_bytes(m, n, 8, smallest) + 2048 + 1024 <= 233472 // 2
        assert ((8, 2) in layouts) == half
    else:
        assert sorted(p.cluster for p in plans) == [4, 8]
    for p in plans:
        assert p.smem_bytes + 2048 <= 232448
        assert p.ctas_per_sm * (p.smem_bytes + 2048 + 1024) <= 233472
        assert p.smem_bytes == _stream_bytes(m, n, p.cluster, p)
        if aligned:
            assert p.stages * p.stage_floats <= (8 * p.warp_stages
                                                 * p.chunk_floats)
            assert p.chunk_floats % 32 == 0 or p.chunk_floats >= m
        band = -(-m // 8)
        assert pl.band_slice_len(m, p.cluster) == (8 // p.cluster) * band
        assert p.cluster * pl.band_slice_len(m, p.cluster) >= m


@pytest.mark.parametrize("m,n", STREAMED, ids=lambda v: str(v))
def test_bounded_streaming_set_does_not_depend_on_the_batch(m, n):
    """The streaming candidates at (m, n) are the same plans at every batch
    size (only their order follows the batch), so a lane's bits, which do
    not depend on the cluster size nor on the load branch, do not depend on
    its batch."""
    sets = {frozenset(bk.segment_plans(B, m, n)) for B in BATCHES}
    assert len(sets) == 1


@pytest.mark.parametrize("m,n", STREAMED, ids=lambda v: str(v))
def test_bounded_built_stream_plans_add_the_scalar_branch(m, n):
    """The layouts the card tests hold against each other: the candidates,
    then on an aligned shape the scalar-load branch at 4 and 8 CTAs a lane
    (an unaligned shape's candidates are those already); a resident shape
    has none."""
    plans = bk.segment_plans(16, m, n)
    built = bk.built_stream_plans(16, m, n)
    assert built[:len(plans)] == plans and len(set(built)) == len(built)
    assert sorted(p.cluster for p in built if not p.aligned) == [4, 8]
    with pytest.raises(ValueError, match="cluster-resident"):
        bk.built_stream_plans(16, 256, 512)


def test_bounded_streaming_order_by_waves_then_sms():
    """The candidates' order: the fewest waves of resident clusters (an
    estimate that loses one cluster to the GPCs: 15 clusters of 8 at one
    CTA an SM), then the most SMs, then the listed order.  At [16, 1280,
    2560] (phase 16) 8 CTAs a lane at one CTA an SM takes two waves, and 8
    at two an SM and 4 at one both fill 64 SMs: the measured choice, 8 at
    two an SM, comes first.  Four lanes take 8 CTAs a lane on 32 SMs."""
    first = bk.segment_plans(16, 1280, 2560)[0]
    assert (first.cluster, first.ctas_per_sm, first.aligned) == (8, 2, True)
    (ring8,) = [p for p in bk.segment_plans(16, 1280, 2560)
                if (p.cluster, p.ctas_per_sm) == (8, 1)]
    assert pl.estimated_held(ring8) == 15
    assert bk.segment_plans(16, 1280, 2560)[-1] == ring8
    four = bk.segment_plans(4, 1280, 2560)[0]
    assert (four.cluster, four.ctas_per_sm) == (8, 1)
    assert pl.plan_sms(four, 4, pl.estimated_held(four)) == 32


def test_devex_changes_only_the_block_branch():
    """The cluster-resident layout holds the devex weights in every mode;
    past it (where the block per lane took a fifth row of n floats for
    them) devex moves the streaming branch's reach line, the old block
    line with that fifth row, and its plans' vectors by a slice of n."""
    assert sk.segment_plans(64, 256, 512, devex=True) == \
        sk.segment_plans(64, 256, 512)
    for B in (8, 32, 64):
        dv = sk.segment_plans(B, 1024, 2048, devex=True)
        plain = sk.segment_plans(B, 1024, 2048)
        assert [(p.cluster, p.ctas_per_sm) for p in dv] == \
            [(p.cluster, p.ctas_per_sm) for p in plain]
        for p in dv:
            vec = sk.large_vector_bytes(1024, 2048, p.cluster, devex=True)
            assert vec == sk.large_vector_bytes(1024, 2048, p.cluster) \
                + 4 * pl.band_slice_len(2048, p.cluster)
            assert p.smem_bytes == vec + 4 * 8 * p.warp_stages * p.chunk_floats
    # the line: 7m + 4n floats, 7m + 5n with devex
    m = 3000
    n = ((232448 - 1024) // 4 - 7 * m) // 4
    assert sk.in_reach(m, n) and not sk.in_reach(m, n + 1)
    assert not sk.in_reach(m, n, devex=True)
    sk.segment_plans(8, m, n)
    with pytest.raises(ValueError, match="shared memory"):
        sk.segment_plans(8, m, n, devex=True)


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
    the streaming branch; more SMs let a batch take larger clusters."""
    assert sk.segment_plans(1024, 256, 512, smem_limit=150 * 1024)[0].cluster == 8
    assert isinstance(sk.segment_plans(8, 512, 1024, smem_limit=150 * 1024)[0],
                      pl.StreamingPlan)
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


# kernel 1's streaming branch (past the largest cluster): shapes that took
# the block-per-lane branch it replaced, aligned and not, the m = 1024
# crossover's (1024, 2048) among them
SEGMENT_STREAMED = [(528, 1056), (1023, 2046), (1024, 2048), (1100, 1100),
                    (1180, 2360), (2000, 4000), (3000, 6000), (3400, 6800),
                    (2048, 1024), (5000, 2000), (600, 9000), (8, 11000)]


def _old_segment_line(m, n, devex=False):
    # the block-per-lane branch's vectors: 7m + 4n floats (5n with devex)
    return 4 * (7 * m + (5 if devex else 4) * n) + 1024 <= 232448


@pytest.mark.parametrize("devex", [False, True], ids=["dantzig", "devex"])
@pytest.mark.parametrize("ratio", [0.125, 0.5, 1, 2, 3, 8])
def test_segment_reach_is_the_block_branch_line(ratio, devex):
    """Kernel 1 takes a lane where it did before the streaming branch
    replaced the block per lane: the cluster-resident branch, or the block
    branch's line (m ~ 3850 at n = 2m, 7m + 4n floats, 5n with devex), up to
    it and past it; where it does not, the plans raise naming shared
    memory."""
    for m in range(1, 9000, 17):
        n = max(1, int(m * ratio))
        want = pl.resident(m, n, sk.cluster_bytes) or _old_segment_line(m, n, devex)
        try:
            plans = sk.segment_plans(16, m, n, devex=devex)
        except ValueError as e:
            assert not want, (m, n, str(e))
            assert "shared memory" in str(e)
        else:
            assert want and plans, (m, n)


def _large_bytes(m, n, cl, devex, plan):
    # d, u, c_B whole, the partial over max(m, n) and two over n, five
    # slices of m and four of n (five with devex), whole bands of an eighth
    # of the lane; then the ring: the warps' view, which the block's view
    # of four stages fits into
    ml, nl = (8 // cl) * -(-m // 8), (8 // cl) * -(-n // 8)
    vec = 4 * _r4(3 * m + max(m, n) + 2 * n + 5 * ml + (5 if devex else 4) * nl)
    return vec + 4 * 8 * plan.warp_stages * plan.chunk_floats


@pytest.mark.parametrize("devex", [False, True], ids=["dantzig", "devex"])
@pytest.mark.parametrize("m,n", SEGMENT_STREAMED, ids=lambda v: str(v))
def test_segment_streaming_plans_fit_and_take_whole_bands(m, n, devex):
    """Every shape the block-per-lane branch took past the largest cluster
    gets plans of kernel 1's streaming branch only: bulk-copy rings where
    the rows are 16-byte aligned (2 CTAs a lane one to an SM, 4 two to an
    SM or one, 8 two to an SM, where a ring fits), scalar loads at 4 and 8
    otherwise; each CTA's bytes fit the 232,448 a block may use less its
    static part (two CTAs an SM: half of the SM's 228 KB less the card's 1
    KB a block); its slices are whole bands of an eighth of the lane, which
    cover it."""
    assert not pl.resident(m, n, sk.cluster_bytes) and _old_segment_line(m, n, devex)
    plans = sk.segment_plans(64, m, n, devex=devex)
    assert all(isinstance(p, pl.StreamingPlan) for p in plans)
    layouts = {(p.cluster, p.ctas_per_sm) for p in plans}
    if plans[0].aligned:
        assert m % 4 == 0 and n % 4 == 0
        assert all(p.aligned for p in plans)
        assert layouts <= set(sk.LARGE_LAYOUTS)
    else:
        assert not any(p.aligned for p in plans)
        assert {p.cluster for p in plans} <= {4, 8}
    for p in plans:
        assert p.smem_bytes + 2048 <= 232448
        assert p.ctas_per_sm * (p.smem_bytes + 2048 + 1024) <= 233472
        assert p.smem_bytes == _large_bytes(m, n, p.cluster, devex, p)
        if p.aligned:
            assert p.stages * p.stage_floats <= (8 * p.warp_stages
                                                 * p.chunk_floats)
            assert p.chunk_floats % 32 == 0 or p.chunk_floats >= m
        band = -(-m // 8)
        assert pl.band_slice_len(m, p.cluster) == (8 // p.cluster) * band
        assert p.cluster * pl.band_slice_len(m, p.cluster) >= m


@pytest.mark.parametrize("devex", [False, True], ids=["dantzig", "devex"])
@pytest.mark.parametrize("m,n", SEGMENT_STREAMED, ids=lambda v: str(v))
def test_segment_streaming_set_does_not_depend_on_the_batch(m, n, devex):
    """Kernel 1's streaming candidates at (m, n) are the same plans at
    every batch size (only their order follows the batch), so a lane's
    bits, which do not depend on the cluster size nor on the load branch,
    do not depend on its batch."""
    sets = {frozenset(sk.segment_plans(B, m, n, devex=devex))
            for B in BATCHES}
    assert len(sets) == 1


@pytest.mark.parametrize("devex", [False, True], ids=["dantzig", "devex"])
@pytest.mark.parametrize("B,layout", [(64, (2, 1)), (32, (8, 2)),
                                      (8, (8, 2))])
def test_segment_streaming_first_plan_is_the_measured_one(B, layout, devex):
    """The first candidate at (1024, 2048), the m = 1024 crossover's lanes:
    at B = 64 2 CTAs a lane one to an SM (one wave on 128 SMs; 0.519 ms an
    iteration on an H100 against 0.612-0.848 for the other rings), at B = 32
    8 two to an SM (128 SMs; 0.380 against 0.415 for 2 a lane on 64 SMs and
    0.437 for 4 one to an SM, listed after it), and so at the fallback's
    bucket of 8 lanes (64 SMs)."""
    first = sk.segment_plans(B, 1024, 2048, devex=devex)[0]
    assert (first.cluster, first.ctas_per_sm, first.aligned) == (*layout, True)
    assert pl.plan_sms(first, B, pl.estimated_held(first)) == min(
        128, B * first.cluster // first.ctas_per_sm)


@pytest.mark.parametrize("m,n", SEGMENT_STREAMED, ids=lambda v: str(v))
def test_segment_built_stream_plans_add_the_scalar_branch(m, n):
    """The layouts the card tests hold against each other: the candidates,
    then on an aligned shape the scalar-load branch at 4 and 8 CTAs a lane
    (an unaligned shape's candidates are those already); a resident shape
    has none."""
    plans = sk.segment_plans(16, m, n)
    built = sk.built_stream_plans(16, m, n)
    assert built[:len(plans)] == plans and len(set(built)) == len(built)
    assert sorted(p.cluster for p in built if not p.aligned) == [4, 8]
    with pytest.raises(ValueError, match="cluster-resident"):
        sk.built_stream_plans(16, 256, 512)


# ---- kernel 1's unit layout ---------------------------------------------------


def _trailing_unit(A):
    """The trailing columns of A with exactly one nonzero in every lane,
    counted one column at a time."""
    count = 0
    for k in range(A.shape[2] - 1, -1, -1):
        if not bool(((A[:, :, k] != 0).sum(dim=1) == 1).all()):
            break
        count += 1
    return count


def _two_phase_matrix(B=3, m=8, n_g=12, seed=0):
    """[G | I | I] with the rows of h < 0 sign-flipped, as the two-phase
    simplex builds its Phase-I matrix: -1 entries in the slack block and
    -0.0 for the zeros of the flipped rows."""
    gen = torch.Generator().manual_seed(seed)
    G = torch.randn((B, m, n_g), generator=gen)
    h = torch.randn((B, m), generator=gen)
    eye = torch.eye(m).expand(B, m, m)
    A = torch.cat([G, eye], dim=2)
    A = torch.where((h < 0)[:, :, None], -A, A)
    return torch.cat([A, eye], dim=2)


def test_unit_columns_map_the_trailing_block():
    """The two-phase matrix's 2m trailing unit columns: their rows and
    values, -1 entries of the flipped slack rows included; the block starts
    at the first multiple of 4 at or past the last dense column."""
    A = _two_phase_matrix(n_g=10)
    B, m, n = A.shape
    assert bool((A == -1).any()) and bool((torch.signbit(A) & (A == 0)).any())
    u = sk.unit_columns(A)
    assert _trailing_unit(A) == 2 * m and u.n_d == 12
    assert u.rows.dtype == torch.int32 and u.vals.dtype == torch.float32
    assert u.rows.shape == u.vals.shape == (B, n - u.n_d)
    tail = A[:, :, u.n_d:]
    want_rows = (tail != 0).to(torch.int8).argmax(dim=1)
    assert torch.equal(u.rows.long(), want_rows)
    assert torch.equal(u.vals, torch.gather(tail, 1, want_rows[:, None])[:, 0])
    assert bool((u.vals == -1).any())


@pytest.mark.parametrize("case", ["two_nonzeros", "zero", "one_lane",
                                  "inside", "nan_entry", "leading_units"])
def test_unit_columns_fall_back_where_the_block_breaks(case):
    """A last column with two nonzeros or none, in any one lane, leaves no
    unit block (the dense launch, n_d = n): the block is common to the
    batch. A break inside the block shortens it to the columns past the
    break; a NaN is a nonzero; unit columns before a dense one are held."""
    A = _two_phase_matrix()
    B, m, n = A.shape
    if case == "two_nonzeros":
        A[:, 0, n - 1] = 2.0
    elif case == "zero":
        A[:, :, n - 1] = 0.0
    elif case == "one_lane":
        A[1, 3, n - 1] = 0.5
    elif case == "inside":
        A[2, 0, n - 5] = 0.5
    elif case == "nan_entry":
        A[0, :, n - 2] = 0.0
        A[0, 4, n - 2] = float("nan")
    else:  # the structural columns end in a unit column and a dense one
        A = torch.cat([A[:, :, :12], torch.eye(m)[:, :1].expand(B, m, 1),
                       A[:, :, :1], A[:, :, 12:]], dim=2)
        n = A.shape[2]
    u = sk.unit_columns(A)
    run = _trailing_unit(A)
    if case in ("two_nonzeros", "zero", "one_lane"):
        assert run == 0 and u is None
        return
    assert u.n_d == -(-(n - run) // 4) * 4 < n
    if case == "inside":
        assert run == 4 and u.n_d == n - 4
    if case == "nan_entry":
        assert run == 16
        k = n - 2 - u.n_d
        assert int(u.rows[0, k]) == 4 and bool(torch.isnan(u.vals[0, k]))
    if case == "leading_units":
        assert run == 16 and n - run == 14 and u.n_d == 16


@pytest.mark.parametrize("m,n,n_d", [(256, 768, 256), (256, 512, 256),
                                     (128, 384, 128), (37, 90, 16),
                                     (256, 768, 768)])
def test_unit_layout_plan_bytes(m, n, n_d):
    """In the unit layout a CTA holds its rows of the leading n_d columns
    and the row and value of every unit column; the rest is the dense
    layout's. n_d = n is the dense layout."""
    for cl in (1, 2, 4, 8, 16):
        ml = _slice(m, cl)
        want = 4 * (_r4(ml * n_d) + _r4(ml * m) + _r4(6 * m + 5 * n + 3 * ml)
                    + _r4(2 * (n - n_d)))
        assert sk.cluster_bytes(m, n, cl, n_d) == want
    assert sk.cluster_bytes(m, n, 4, n) == sk.cluster_bytes(m, n, 4)
    plans = sk.segment_plans(1024, m, n, n_d=n_d)
    assert all(p.smem_bytes == sk.cluster_bytes(m, n, p.cluster, n_d)
               for p in plans)


def test_unit_layout_halves_the_two_phase_cluster():
    """The two-phase simplex's Phase-I lanes at m = 256 ([G | I | I], n =
    768): 8 CTAs a lane of 152,960 bytes dense (a 4-CTA share needs
    284,416), 4 of 157,440 with the 512 unit columns left out. The branch
    stays the one (m, n) gives, and the crossover's [G | I] keeps its 4."""
    dense = sk.segment_plans(1024, 256, 768)
    unit = sk.segment_plans(1024, 256, 768, n_d=256)
    assert dense[0] == pl.SegmentPlan(8, 152960)
    assert sk.cluster_bytes(256, 768, 4) == 284416
    assert unit[0] == pl.SegmentPlan(4, 157440)
    assert [p.cluster for p in unit] == [4, 8, 16]
    assert sk.segment_plans(1024, 256, 512, n_d=256)[0].cluster == 4
    assert sk.segment_plans(1024, 1024, 3072, n_d=1024) == sk.segment_plans(
        1024, 1024, 3072)


@pytest.mark.parametrize("B,m,n,n_d", [(1024, 256, 768, 256),
                                       (1024, 256, 512, 256),
                                       (1024, 256, 768, 768)])
def test_unit_layout_pays_only_on_a_card(B, m, n, n_d):
    """Off a CUDA device the segment kernel is the plain version, so no
    unit layout pays there and the driver makes no map; the count of the
    trailing unit columns is a device scalar (no host read)."""
    assert not sk.unit_pays(B, m, n, n_d, "cpu")
    A = _two_phase_matrix()
    count = sk.unit_count(A)
    assert count.shape == () and int(count) == _trailing_unit(A)
    assert sk.unit_map(A, 0) is None
