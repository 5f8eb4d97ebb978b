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
from typing import List, Optional

import torch

from ..observability import note
from . import _build
from .plans import (SM_COUNT, SMEM_LIMIT, STREAM_STATIC_BYTES, StreamingPlan,
                    _round4, aligned_pointers, band_slice_len, cuda_index,
                    fewest_waves, held_on, scalar_for_unaligned,
                    slices_aligned, streaming_plan)
from .solve_kernel import SegmentState, check_segment_args, solve_segment_plain

launches = 0  # CUDA launches of the kernel (never the plain version)
launches_dual = 0  # those of them in dual mode
launches_partial = 0  # those of them with sectional pricing
last_plan = None  # the StreamingPlan of the last launch

_CLUSTERS = (8, 2)  # cluster sizes the bulk-copy branch is built for
_SCALAR_CLUSTERS = (8,)  # cluster sizes the scalar branch is built for


def _vector_bytes(m: int, n: int, cluster: int, dual: bool) -> int:
    """The lane's vectors in one block: d, u and c_B whole, the block's
    partial of ``y A`` over all n columns (reused for the direction's) and
    in dual mode that of the dual row, five slices of m and four of n,
    rounded to 16 bytes."""
    return 4 * _round4(3 * m + max(m, n) + (n if dual else 0)
                       + 5 * band_slice_len(m, cluster)
                       + 4 * band_slice_len(n, cluster))


def scalar_plan(cluster: int, m: int, n: int, dual: bool = False,
                smem_limit: int = SMEM_LIMIT) -> Optional[StreamingPlan]:
    """The scalar-load branch at ``cluster`` blocks a lane (no ring), or
    None."""
    if cluster not in _SCALAR_CLUSTERS:
        return None
    return streaming_plan(cluster, 1, _vector_bytes(m, n, cluster, dual), m,
                          False, smem_limit)


def stream_plans(B: int, m: int, n: int, sm_count: int = SM_COUNT,
                 smem_limit: int = SMEM_LIMIT,
                 dual: bool = False) -> List[StreamingPlan]:
    """Candidate launch plans for ``B`` lanes of ``(m, n)``, best first.

    First the largest cluster that keeps the batch within one block per SM
    (``B * cluster <= sm_count``: 8 blocks a lane up to a bucket of 16, 2
    for a batch of 64), then the other size.  The wrapper settles them with
    :func:`~.plans.fewest_waves`: a cluster must lie within one GPC, so the
    card holds fewer clusters of a size than its SM count suggests (15 of
    8 blocks, 66 of 2 at one block per SM on an H100 SXM).  On an aligned
    shape each size's largest ring that fits one block on an SM (the
    bulk-copy branch may use all of a thread's registers, so a plan counts
    on no second block); a shape whose rows are not aligned takes the
    scalar branch, which is built for 8 blocks a lane only.  Dual mode
    keeps one more row of n floats.  Raises ``ValueError`` for a lane whose
    vectors pass the shared memory of a block at every cluster size.
    """
    if B < 1 or m < 1 or n < 1:
        raise ValueError(f"stream_plans needs B, m, n >= 1, got {(B, m, n)}")
    first = next((cl for cl in _CLUSTERS if B * cl <= sm_count),
                 _CLUSTERS[-1])
    order = [first] + [cl for cl in _CLUSTERS if cl != first]
    if slices_aligned(m, n):
        plans = [streaming_plan(cl, 1, _vector_bytes(m, n, cl, dual), m, True,
                                smem_limit) for cl in order]
    else:
        plans = [scalar_plan(cl, m, n, dual, smem_limit) for cl in order]
    plans = [p for p in plans if p is not None]
    if not plans:
        raise ValueError(
            f"solve_segment_stream: a lane of m={m}, n={n} needs "
            f"{_vector_bytes(m, n, _CLUSTERS[0], dual) + STREAM_STATIC_BYTES} "
            f"bytes of shared memory per block at {_CLUSTERS[0]} blocks a "
            f"lane, past the {smem_limit} a block of the card may hold"
        )
    return plans


def clusters_held(plan: StreamingPlan) -> int:
    """Clusters of ``plan`` the current device holds at once, as the built
    kernel's occupancy query counts them (< 0: a negated CUDA error)."""
    return _build.library().lp_solve_segment_stream_max_clusters(
        plan.cluster, int(plan.aligned), plan.smem_bytes)


@functools.lru_cache(maxsize=None)
def _choose_plan(B: int, m: int, n: int, dual: bool, device_index: int,
                 pointers_aligned: bool) -> StreamingPlan:
    """:func:`~.plans.fewest_waves` by the built kernel's occupancy query
    on this device; unaligned pointers take the scalar branch."""
    props = torch.cuda.get_device_properties(device_index)
    plans = stream_plans(B, m, n, props.multi_processor_count, dual=dual)
    if not pointers_aligned:
        plans = scalar_for_unaligned(
            plans, lambda cl: scalar_plan(cl, m, n, dual))
    return fewest_waves(plans, B, held_on(device_index, clusters_held),
                        "solve_segment_stream", f" for m={m}, n={n}")


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
    plan = _choose_plan(B, m, n, bool(dual), cuda_index(A.device),
                        aligned_pointers(A, state.invBT))
    return launch_with_plan(plan, A, c, apen, maxiters, state,
                            seg_len=seg_len, pricing=pricing, opt_tol=opt_tol,
                            pivot_tol=pivot_tol, dual=dual, feas_tol=feas_tol,
                            stall_limit=stall_limit, packed=packed,
                            partial=partial, n_blk=n_blk)


def launch_with_plan(plan: StreamingPlan, A, c, apen, maxiters: int,
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
