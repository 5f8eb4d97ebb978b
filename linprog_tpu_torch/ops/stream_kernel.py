"""Whole-segment simplex kernel for large m: the counterpart of the Pallas
kernel ``linprog_tpu/ops/stream_kernel.py :: solve_segment_stream`` (body
``_stream_kernel``, helper ``_factor_rb``).

The TPU kernel exists because one lane's factor and A stop fitting in
VMEM: it DMAs ``B^-T`` into scratch, keeps Aᵀ resident or streams it in
``(n_blk, m)`` row blocks, and at the top of its range reads the factor in
``(RB, m)`` row slices.  Its iteration math is the one of
:mod:`linprog_tpu_torch.ops.solve_kernel`, minus devex, so the plain
version here reuses :func:`~linprog_tpu_torch.ops.solve_kernel
.solve_segment_plain`.  The one difference it reproduces is the
blocked-factor mode's summation order for the direction ``d = B^-1 a``.
``a_resident`` chooses VMEM choreography only, and so does ``n_blk``
outside sectional pricing: both versions accept them and ignore them.
``partial=True`` (primal mode, bland or dantzig, ``n % n_blk == 0``) is the
reference's sectional pricing: each iteration prices one section of
``n_blk`` columns, stays in it while it yields an entering column, moves
on when it comes up empty, and calls a lane OPTIMAL after ``n / n_blk``
empty sections in a row under one basis (the plain version:
:func:`~linprog_tpu_torch.ops.solve_kernel.solve_segment_plain` with
``n_blk``).  On the card each CTA's pricing pass then streams only the
section's columns of its rows, an ``S``-th of A.  The port takes
``A[B, m, n]``, not the
reference's Aᵀ (which suits the TPU's sublane slices; on the card a copy
of Aᵀ would cost ``m n`` floats per lane).

On the H100 (``csrc/solve_segment_stream.cu``) the kernel is bound by
device-memory bandwidth: a primal pivot reads A once and ``B^-T`` twice and
writes ``B^-T`` once (80 MiB per lane-pivot at m = 2048, n = 4096), and the
card needs megabytes of loads in flight to reach its rate.  One cluster of
8 or 2 thread blocks runs a lane.  The blocks split the lane by rows: a
block owns whole bands (an eighth of the rows each) of A and the same rows
of ``B^-T``, computes its partial of each product over all columns, and the
cluster adds the partials up through distributed shared memory, as it
combines the selections.  Every sum runs band by band and then over the
eight band totals as one fixed tree, so a lane's result does not depend on
the cluster size, nor on the branch.  One step departs from the plain
version's arithmetic: the direction ``d = B^-1 a`` sums with fused
multiply-adds (as the plain version's library GEMV does), the rest rounds
each product first.  Where
the rows are 16-byte aligned (m and n multiples of 4) every pass streams
whole rows through a ring of a few large stages in shared memory, filled by
asynchronous bulk copies; other shapes take scalar loads in the same
kernel.  The eta pass that rewrites ``B^-T`` also produces the next
iteration's duals, so only a launch's first iteration reads the factor a
third time.

The launch plan -- cluster size, ring geometry, shared-memory bytes, aligned
or scalar branch -- is :func:`stream_plans`, a pure function of the batch
and lane shape and of the card's SM count and shared-memory limit; the
wrapper takes the first candidate that runs the batch in the fewest waves
of resident clusters, as the occupancy query of the built kernel counts
them.  Only the sizes a route launches are built: 8 blocks a lane (the
fallback's bucket of 8 lanes, either branch) and 2 (a batch of 64,
bulk-copy branch).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import torch

from ..observability import note
from . import _build
from .solve_kernel import (
    SegmentState,
    check_segment_args,
    ring_layout,
    slices_aligned,
    solve_segment_plain,
)

launches = 0  # CUDA launches of the kernel (never the plain version)
launches_dual = 0  # those of them in dual mode
launches_partial = 0  # those of them with sectional pricing
last_plan = None  # the StreamPlan of the last launch

SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
SM_COUNT = 132  # SMs of an H100 SXM (the default of the plan)
_STATIC_BYTES = 2048  # the kernel's static shared memory and a block's reserve
_BANDS = 8  # row bands of a lane (csrc/solve_segment_stream.cu: kBands)
_CLUSTERS = (8, 2)  # cluster sizes the bulk-copy branch is built for
_SCALAR_CLUSTERS = (8,)  # cluster sizes the scalar branch is built for

class StreamPlan(NamedTuple):
    """How one launch of the streaming kernel is laid out."""

    cluster: int  # thread blocks per lane
    aligned: bool  # bulk-copy rings (True) or scalar loads (False)
    stages: int  # block ring: stages (0 on the scalar branch)
    stage_floats: int  # block ring: floats per stage
    warp_stages: int  # warp rings: stages per warp
    chunk_floats: int  # warp rings: floats per stage (a chunk of a row)
    smem_bytes: int  # dynamic shared memory per block


def _slice_len(size: int, cluster: int) -> int:
    """Entries of a block's slice: whole bands of ``ceil(size / 8)``."""
    return (_BANDS // cluster) * -(-size // _BANDS)


def _vector_bytes(m: int, n: int, cluster: int, dual: bool) -> int:
    """The lane's vectors in one block: d, u and c_B whole, the block's
    partial of ``y A`` over all n columns (reused for the direction's) and
    in dual mode that of the dual row, five slices of m and four of n,
    rounded to 16 bytes."""
    floats = (3 * m + max(m, n) + (n if dual else 0)
              + 5 * _slice_len(m, cluster) + 4 * _slice_len(n, cluster))
    return 4 * (-(-floats // 4) * 4)


def scalar_plan(cluster: int, m: int, n: int, dual: bool = False,
                smem_limit: int = SMEM_LIMIT) -> Optional[StreamPlan]:
    """The scalar-load branch at ``cluster`` blocks a lane (no ring), or
    None."""
    if cluster not in _SCALAR_CLUSTERS:
        return None
    vec = _vector_bytes(m, n, cluster, dual)
    if vec + _STATIC_BYTES > smem_limit:
        return None
    return StreamPlan(cluster, False, 0, 0, 0, 0, vec)


def _plan_for(cluster: int, m: int, n: int, dual: bool,
              smem_limit: int) -> Optional[StreamPlan]:
    """The plan at ``cluster`` blocks a lane: on an aligned shape the
    largest ring that fits one block on an SM (the bulk-copy branch may use
    all of a thread's registers, so it counts on no second block)."""
    if not slices_aligned(m, n):
        return scalar_plan(cluster, m, n, dual, smem_limit)
    ring = ring_layout(m, _vector_bytes(m, n, cluster, dual),
                       smem_limit - _STATIC_BYTES)
    return None if ring is None else StreamPlan(cluster, True, *ring)


def stream_plans(B: int, m: int, n: int, sm_count: int = SM_COUNT,
                 smem_limit: int = SMEM_LIMIT,
                 dual: bool = False) -> List[StreamPlan]:
    """Candidate launch plans for ``B`` lanes of ``(m, n)``, best first.

    First the largest cluster that keeps the batch within one block per SM
    (``B * cluster <= sm_count``: 8 blocks a lane up to a bucket of 16, 2
    for a batch of 64), then the other size.  The wrapper takes the first
    that runs the batch in the fewest waves: a cluster must lie within one
    GPC, so the card holds fewer clusters of a size than its SM count
    suggests (15 of 8 blocks, 66 of 2 at one block per SM on an H100 SXM).
    A shape whose rows are not aligned takes the scalar branch, which is
    built for 8 blocks a lane only.  Dual mode keeps one more row of n
    floats; a plan counts on one block per SM.  Raises
    ``ValueError`` for a lane whose vectors pass the shared memory of a
    block at every cluster size.
    """
    if B < 1 or m < 1 or n < 1:
        raise ValueError(f"stream_plans needs B, m, n >= 1, got {(B, m, n)}")
    first = next((cl for cl in _CLUSTERS if B * cl <= sm_count),
                 _CLUSTERS[-1])
    order = [first] + [cl for cl in _CLUSTERS if cl != first]
    plans = []
    for cl in order:
        plan = _plan_for(cl, m, n, dual, smem_limit)
        if plan is not None:
            plans.append(plan)
    if not plans:
        raise ValueError(
            f"solve_segment_stream: a lane of m={m}, n={n} needs "
            f"{_vector_bytes(m, n, _CLUSTERS[0], dual) + _STATIC_BYTES} bytes of "
            f"shared memory per block at {_CLUSTERS[0]} blocks a lane, past "
            f"the {smem_limit} a block of the card may hold"
        )
    return plans


@functools.lru_cache(maxsize=None)
def _choose_plan(B: int, m: int, n: int, dual: bool, device_index: int,
                 pointers_aligned: bool) -> StreamPlan:
    """The candidate that runs the batch in the fewest waves of resident
    clusters on this device (ties: the earlier candidate)."""
    props = torch.cuda.get_device_properties(device_index)
    lib = _build.library()
    best, best_waves, seen = None, None, []
    for plan in stream_plans(B, m, n, props.multi_processor_count,
                             dual=dual):
        if plan.aligned and not pointers_aligned:
            plan = scalar_plan(plan.cluster, m, n, dual)
            if plan is None:
                continue
        with torch.cuda.device(device_index):  # the query asks this device
            resident = lib.lp_solve_segment_stream_max_clusters(
                plan.cluster, int(plan.aligned), plan.smem_bytes)
        seen.append((plan.cluster, resident))
        if resident <= 0:
            continue
        waves = -(-B // resident)
        if best is None or waves < best_waves:
            best, best_waves = plan, waves
    if best is None:
        raise RuntimeError(
            "solve_segment_stream: the device holds no cluster of any "
            f"planned size for m={m}, n={n}: (cluster, resident or negated "
            f"CUDA error) = {seen}"
        )
    return best


def _factor_rb(m: int) -> int:
    """Row-block size of the blocked-factor mode (divides m)."""
    if m >= 4096 and m % 256 == 0:
        return 256
    if m >= 2048 and m % 512 == 0:
        return 512
    for rb in (8, 4, 2):
        if m % rb == 0 and rb < m:
            return rb
    return m


def _check_mode(pricing: int, dual: bool, factor_blocked: bool,
                partial: bool = False, n: int = 0, n_blk: int = 0) -> None:
    if pricing not in (0, 1):
        raise ValueError(
            "solve_segment_stream: pricing must be bland (0) or dantzig (1); "
            "devex is not offered on the streaming kernel (its weight "
            "update would need a second pass over A)"
        )
    if factor_blocked and dual:
        raise ValueError("solve_segment_stream: the blocked-factor mode is "
                         "primal only")
    if partial:
        if dual:
            raise ValueError("partial pricing: primal mode only")
        if factor_blocked:
            raise ValueError("blocked-factor mode: plain primal only")
        if n_blk < 1 or n % n_blk:
            raise ValueError(f"n={n} not divisible by n_blk={n_blk}")


def solve_segment_stream_plain(A, c, apen, maxiters: int,
                               state: SegmentState, *, seg_len: int,
                               pricing: int, opt_tol: float,
                               pivot_tol: float, dual: bool = False,
                               feas_tol: float = 1e-6, stall_limit: int = 0,
                               packed: bool = False, a_resident: bool = True,
                               n_blk: int = 256,
                               factor_blocked: bool = False,
                               partial: bool = False) -> SegmentState:
    """The plain PyTorch version; updates ``state`` in place and returns
    it."""
    del a_resident
    _, m, n = A.shape
    _check_mode(pricing, dual, factor_blocked, partial, n, n_blk)
    return solve_segment_plain(
        A, c, apen, maxiters, state, seg_len=seg_len, pricing=pricing,
        opt_tol=opt_tol, pivot_tol=pivot_tol, dual=dual, feas_tol=feas_tol,
        stall_limit=stall_limit, packed=packed,
        factor_rb=_factor_rb(m) if factor_blocked else 0,
        n_blk=n_blk if partial else 0,
    )


def solve_segment_stream(A, c, apen, maxiters: int, state: SegmentState, *,
                         seg_len: int, pricing: int, opt_tol: float,
                         pivot_tol: float, dual: bool = False,
                         feas_tol: float = 1e-6, stall_limit: int = 0,
                         packed: bool = False, a_resident: bool = True,
                         n_blk: int = 256,
                         factor_blocked: bool = False,
                         partial: bool = False) -> SegmentState:
    """Run up to ``seg_len`` simplex iterations per lane; updates ``state``
    in place and returns it.

    Arguments as :func:`linprog_tpu_torch.ops.solve_kernel.solve_segment`
    (``pricing`` 0 = bland, 1 = dantzig; devex raises ``ValueError``), plus
    the reference's mode switches: ``a_resident`` is accepted and ignored,
    ``factor_blocked`` (primal only) sums the direction over row blocks of
    the factor in the plain version, ``partial`` prices one section of
    ``n_blk`` columns an iteration (primal only, ``n % n_blk == 0``, not
    with ``factor_blocked``; the reference's ``ValueError`` otherwise).  A
    CPU tensor takes the plain version; a CUDA tensor launches the cluster
    kernel, or raises for a lane too large for its shared memory.
    """
    check_segment_args(A, c, apen, state, "solve_segment_stream")
    kw = dict(seg_len=seg_len, pricing=pricing, opt_tol=opt_tol,
              pivot_tol=pivot_tol, dual=dual, feas_tol=feas_tol,
              stall_limit=stall_limit, packed=packed,
              factor_blocked=factor_blocked, partial=partial, n_blk=n_blk)
    if A.device.type == "cpu":
        return solve_segment_stream_plain(A, c, apen, maxiters, state, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"solve_segment_stream: unsupported device {A.device}")
    B, m, n = A.shape
    _check_mode(pricing, dual, factor_blocked, partial, n, n_blk)
    if B == 0 or seg_len <= 0:
        # a lane too large raises all the same
        stream_plans(max(B, 1), m, n, dual=bool(dual))
        return state
    pointers_aligned = (A.data_ptr() % 16 == 0
                        and state.invBT.data_ptr() % 16 == 0)
    index = A.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _choose_plan(B, m, n, bool(dual), index, pointers_aligned)
    return launch_with_plan(plan, A, c, apen, maxiters, state,
                            seg_len=seg_len, pricing=pricing, opt_tol=opt_tol,
                            pivot_tol=pivot_tol, dual=dual, feas_tol=feas_tol,
                            stall_limit=stall_limit, packed=packed,
                            partial=partial, n_blk=n_blk)


def launch_with_plan(plan: StreamPlan, A, c, apen, maxiters: int,
                     state: SegmentState, *, seg_len: int, pricing: int,
                     opt_tol: float, pivot_tol: float, dual: bool = False,
                     feas_tol: float = 1e-6, stall_limit: int = 0,
                     packed: bool = False, partial: bool = False,
                     n_blk: int = 256) -> SegmentState:
    """Launch the CUDA kernel under ``plan`` (one of :func:`stream_plans`,
    or a variation of one: the card tests hold cluster sizes and branches
    against each other).  CUDA tensors only; the C entry point refuses a
    plan that does not fit the shape."""
    global launches, launches_dual, launches_partial, last_plan
    check_segment_args(A, c, apen, state, "solve_segment_stream")
    if A.device.type != "cuda":
        raise ValueError("launch_with_plan needs CUDA tensors")
    B, m, n = A.shape
    _check_mode(pricing, dual, False, partial, n, n_blk)
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        code = lib.lp_solve_segment_stream(
            A.data_ptr(), c.data_ptr(), apen.data_ptr(),
            state.invBT.data_ptr(), state.bfs.data_ptr(), state.cB.data_ptr(),
            state.basis.data_ptr(), state.pen.data_ptr(),
            state.iters.data_ptr(), state.status.data_ptr(),
            B, m, n, min(int(seg_len), 0x7FFFFFFF), int(maxiters),
            float(opt_tol), float(pivot_tol), float(feas_tol),
            int(bool(dual)), int(pricing), int(bool(packed)),
            int(stall_limit), int(bool(partial)), int(n_blk) if partial else 0,
            plan.cluster, int(plan.aligned), plan.stages, plan.stage_floats,
            plan.warp_stages, plan.chunk_floats, plan.smem_bytes,
            stream,
        )
    _build.check(code, "solve_segment_stream launch")
    launches += 1
    launches_dual += int(bool(dual))
    launches_partial += int(bool(partial))
    last_plan = plan
    note("segment", held_cols=n, cluster=plan.cluster, branch="stream")
    return state
