"""Whole-segment simplex kernel: up to ``seg_len`` revised-simplex
iterations per lane in one launch, with the lane's state updated in place.

Replaces the Pallas kernel ``linprog_tpu/ops/solve_kernel.py ::
solve_segment`` (body ``_solve_segment_kernel``, helper ``pack_min_keys``).
One iteration (primal): duals ``y = c_B B^-1``, reduced costs
``r = c - yA + pen``, the entering column (bland, dantzig or devex; a lane
that stalls falls back to Bland), the direction ``d = B^-1 a``, the
min-ratio leaving row, a rank-1 eta update of ``B^-T``, and the bfs, c_B,
basis, penalty and status updates.  Dual mode picks the leaving row first
(most infeasible, or first infeasible under Bland), then the entering
column by the dual ratio test over the row ``B^-1[leave, :] A``.

What must carry over exactly, and does here in both versions:

* the optimality test uses the ABSOLUTE ``opt_tol`` (the reference's XLA
  path scales it by ``max(1, max|c|)``; its kernel, which the main path
  runs, does not);
* packed keys: the float's bits with the index in the low
  ``(k - 1).bit_length()`` bits, complemented for negative values,
  ``INT32_MAX`` for "no candidate", the lowest index on an exact tie; dual
  ratios clamp to ``+0.0`` before packing;
* stall state is local to a segment (``z0 = sum(c_B bfs)``, ``dz = inf``,
  ``stall = bland = 0`` at entry) and ``dz`` uses the mantissa-truncated
  ratio of the packed path;
* a lane that is not RUNNING, or has reached ``maxiters``, is untouched;
* ``unroll`` does not change results (it is accepted and ignored).

Two more modes of the reference's kernel: ``split=True`` (primal mode,
bland or dantzig) prices with the bf16 halves of ``y`` and ``A``, ``r = c -
((yh Ah + yh Al) + yl Ah) + pen`` (every product of halves exact in f32, the
lo * lo term dropped; the CUDA kernel takes the halves in registers from the
f32 A it holds anyway), and ``ablate`` = 1..7 (profiling only) drops one
stage of the iteration: 1 the pricing product, 4 the entering selection, 2
the direction product, 5 the ratio-test reductions, 6 the masked scalar
extracts, 3 the factor's update, 7 the bookkeeping writes.

On the H100 two branches, chosen by the lane's shape (m, n) alone, never by
the batch:

* cluster-resident (``csrc/solve_segment.cu``), for every lane whose A and
  ``B^-T`` fit the shared memory of a cluster of at most 16 CTAs (m up to
  512 at n = 2m): one
  cluster of 1, 2, 4, 8 or 16 CTAs a lane loads the lane's A and ``B^-T``
  into shared memory once at launch, CTA k owning whole bands of the lane's
  16 fixed row bands, and runs every iteration of the segment on chip.
  Pricing, the direction and the dual and devex rows are band partials;
  every CTA adds up the partials of all the entries it needs through
  distributed shared memory in one fixed tree (so a lane's bits do not
  depend on the cluster size, its batch or its wave) and runs each
  selection over whole vectors, so an iteration has two cluster barriers;
  the eta update of the own rows yields the next duals.  Device memory sees
  A and the factor once a launch; an iteration's latency bounds it.
  :func:`segment_plans` lays the launch out.  Where the trailing columns
  ``[n_d, n)`` of A hold one nonzero each in every lane (the slack and
  artificial columns of a standard form; :func:`unit_columns` finds them),
  the unit layout keeps only the leading ``n_d`` columns in shared memory
  and each trailing column as its row and value; its passes give the bits
  of the dense launch, and its smaller CTAs let the card hold more lanes;
* streaming (``csrc/solve_segment_large.cu``), for lanes past the largest
  cluster, up to the line of the block per lane it replaced (:func:`in_reach`),
  in the design of kernel 3 (:mod:`~linprog_tpu_torch.ops.stream_kernel`):
  a cluster of 2, 4 or 8 CTAs a lane splits it by rows in 8 fixed bands,
  streams its rows of A and ``B^-T`` from device memory each pass
  (bulk-copy rings on aligned shapes, scalar loads otherwise), adds the
  partials through distributed shared memory in one fixed tree, prices and
  selects over a slice of the columns per CTA, and takes the next duals
  from each pivot's eta pass; a devex pivot's row rides the next pricing
  pass.  A lane's bits do not depend on the cluster size nor on the load
  branch.  A primal pivot moves A once and ``B^-T`` three times, so it is
  bound by device-memory bandwidth.  :func:`segment_plans` lays it out as a
  :class:`StreamingPlan`.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import torch

from .. import status as st
from ..observability import host_read, note
from . import _build
from .plans import (RESIDENT_STATIC_BYTES, SM_COUNT, SMEM_LIMIT, StreamingPlan,
                    _round4, aligned_pointers, band_slice_len, built_streaming,
                    cuda_index, estimated_held, fewest_waves, first_granted,
                    held_on, packed_scalar_plan, rank_plans, resident,
                    resident_plans, scalar_for_unaligned, slice_len,
                    slices_aligned, streaming_plan)

INTMAX = 0x7FFFFFFF

launches = 0  # CUDA launches of the kernel (never the plain version)
launches_dual = 0  # those of them in dual mode
launches_split = 0  # those of them with split pricing
launches_streaming = 0  # those of them on the streaming branch
launches_streaming_dual = 0  # those of them in dual mode
launches_ablate = {k: 0 for k in range(1, 8)}  # those with each ablation mode
launches_unit = 0  # those of them in the unit layout
last_plan = None  # the plan of the last launch

# Kernel 1's streaming branch (csrc/solve_segment_large.cuh: the builds of
# LP_LARGE_RING_BUILDS and LP_LARGE_SCALAR_BUILDS, each capped at the
# registers of LARGE_CTAS CTAs an SM). (CTAs a lane, CTAs an SM) of the
# bulk-copy candidates, listed best first where waves and SMs tie: at
# [64, 1024, 2048] on an H100, 2 a lane one to an SM 0.519 ms an iteration
# against 4 two to an SM 0.848 (the card holds 62 of those, not 65); at
# [32, 1024, 2048] 8 a lane two to an SM 0.380 against 4 one to an SM 0.437
# (PERF.md, section 6).
LARGE_LAYOUTS = ((2, 1), (8, 2), (4, 2), (4, 1))
LARGE_SCALAR_CLUSTERS = (4, 8)
LARGE_CTAS = 2


class SegmentState(NamedTuple):
    """The kernel's in-place state: ``invBT[B, m, m]`` (the TRANSPOSED basis
    inverse), ``bfs[B, m]``, ``cB[B, m]``, ``basis[B, m]`` i32, ``pen[B, n]``
    (+inf on basis and disallowed columns), ``gamma[B, n]`` (devex weights),
    ``iters[B]`` i32, ``status[B]`` i32."""

    invBT: torch.Tensor
    bfs: torch.Tensor
    cB: torch.Tensor
    basis: torch.Tensor
    pen: torch.Tensor
    gamma: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor


class UnitColumns(NamedTuple):
    """The trailing columns ``[n_d, n)`` of ``A[B, m, n]``, each with one
    nonzero in every lane: its row ``rows[b, k - n_d]`` (i32) and value
    ``vals[b, k - n_d]`` (f32), ``[B, n - n_d]`` each."""

    n_d: int
    rows: torch.Tensor
    vals: torch.Tensor


def unit_count(A) -> torch.Tensor:
    """The length of the longest run of trailing columns of ``A[B, m, n]``
    that hold exactly one nonzero in every lane, as a device int32 scalar:
    reductions over A, with no temporary of A's size and no host read."""
    nnz = torch.linalg.vector_norm(A, ord=0, dim=1)  # [B, n] nonzeros
    unit = (nnz == 1).all(dim=0)
    return unit.flip(0).to(torch.int32).cumprod(0).sum()


def unit_map(A, n_u: int) -> Optional[UnitColumns]:
    """The last ``n_u`` columns of ``A[B, m, n]`` (unit columns, from
    :func:`unit_count`) as :class:`UnitColumns`, their start rounded up to a
    multiple of 4 (so the held rows stay 16-byte aligned); None where that
    leaves no column."""
    B, m, n = A.shape
    n_d = _round4(n - n_u)
    if n_d >= n:
        return None
    tail = A[:, :, n_d:]
    vals = tail.sum(dim=1)  # the one nonzero, exactly
    rows = torch.where(vals > 0, tail.argmax(dim=1), tail.argmin(dim=1))
    return UnitColumns(n_d, rows.to(torch.int32).contiguous(),
                       vals.contiguous())


def unit_columns(A) -> Optional[UnitColumns]:
    """:func:`unit_map` of :func:`unit_count`: one host read."""
    return unit_map(A, host_read(int, unit_count(A)))


def unit_pays(B: int, m: int, n: int, n_d: int, device) -> bool:
    """Whether the unit layout that holds the leading ``n_d`` columns of
    ``B`` lanes of (m, n) takes fewer CTAs a lane on ``device`` than the
    dense launch.  Only then does it let the card hold more lanes; at the
    same cluster it trades the dense pass for the map's, and is no faster
    (at [1024, 256, 512] an iteration takes 0.457 against 0.448 ms).  False
    off a CUDA device, off the cluster-resident branch and for no lanes."""
    device = torch.device(device)
    if (device.type != "cuda" or B < 1 or n_d >= n
            or not resident(m, n, cluster_bytes)):
        return False
    index = cuda_index(device)
    dense = _choose_plan(B, m, n, False, index, True)
    return _choose_plan(B, m, n, False, index, True, n_d).cluster < dense.cluster


def cluster_bytes(m: int, n: int, cluster: int,
                  n_d: Optional[int] = None) -> int:
    """Dynamic shared memory of one CTA on the cluster-resident branch: its
    rows of A and of ``B^-T``; d, u, c_B, bfs and the basis whole; c, pen and
    the devex weights whole; its partials over n (pricing, the dual or devex
    row) and over m (the direction); three slices of m (every mode alike, so
    the branch does not depend on the mode).  In the unit layout (``n_d <
    n``) its rows of the leading ``n_d`` columns of A only, and the row and
    value of each of the ``n - n_d`` unit columns."""
    n_d = n if n_d is None else n_d
    ml = slice_len(m, cluster)
    return 4 * (_round4(ml * n_d) + _round4(ml * m)
                + _round4(6 * m + 5 * n + 3 * ml) + _round4(2 * (n - n_d)))


def _line(m: int, n: int, devex: bool) -> int:
    # the vectors of the block per lane (7m + 4n floats, 5n with devex)
    return 4 * (7 * m + (5 if devex else 4) * n) + RESIDENT_STATIC_BYTES


def in_reach(m: int, n: int, devex: bool = False,
             smem_limit: int = SMEM_LIMIT) -> bool:
    """The line up to which kernel 1's streaming branch is offered: that of
    the one-block-per-lane branch it replaced, whose vectors (7m + 4n
    floats, 5n with the devex weights) had to fit one block, m ~ 3850 at
    n = 2m.  The streaming branch's own vectors are smaller; raising the
    line takes a card test of its own."""
    return _line(m, n, devex) <= smem_limit


def large_vector_bytes(m: int, n: int, cluster: int,
                       devex: bool = False) -> int:
    """Dynamic shared memory of one CTA's vectors on kernel 1's streaming
    branch: d, u and c_B whole; its partials over ``max(m, n)`` and twice
    over n (the dual or devex row and split pricing's products); five
    slices of m (y, the entering column, the factor's column at the leaving
    row, bfs, the basis) and four of n (c, pen, r, the dual row), five with
    the devex weights; slices of whole bands of ``ceil(size / 8)``."""
    ml, nl = band_slice_len(m, cluster), band_slice_len(n, cluster)
    return 4 * _round4(3 * m + max(m, n) + 2 * n + 5 * ml
                       + (5 if devex else 4) * nl)


def large_scalar_plan(cluster: int, m: int, n: int, devex: bool = False,
                      smem_limit: int = SMEM_LIMIT
                      ) -> Optional[StreamingPlan]:
    """The scalar-load branch at a built cluster size, sized for as many
    CTAs an SM as the build allows and its vectors leave room for; None for
    a size the branch is not built at or vectors that do not fit."""
    if cluster not in LARGE_SCALAR_CLUSTERS:
        return None
    return packed_scalar_plan(cluster, LARGE_CTAS, large_vector_bytes(
        m, n, cluster, devex), smem_limit)


def _large_candidates(m: int, n: int, devex: bool,
                      smem_limit: int) -> List[StreamingPlan]:
    """The bulk-copy layouts that fit on an aligned shape; the scalar
    branch on another shape, or where no ring fits beside the vectors."""
    plans = []
    if slices_aligned(m, n):
        plans = [streaming_plan(cl, ctas, large_vector_bytes(m, n, cl, devex),
                                m, True, smem_limit)
                 for cl, ctas in LARGE_LAYOUTS]
    if not any(plans):
        plans = [large_scalar_plan(cl, m, n, devex, smem_limit)
                 for cl in LARGE_SCALAR_CLUSTERS]
    return [p for p in plans if p is not None]


def segment_plans(B: int, m: int, n: int, sm_count: int = SM_COUNT,
                  smem_limit: int = SMEM_LIMIT, devex: bool = False,
                  n_d: Optional[int] = None) -> list:
    """Candidate launch plans for ``B`` lanes of (m, n), best first.

    The branch follows from (m, n) alone (:func:`~.plans.resident`).  On
    the cluster-resident branch the candidates are
    :func:`~.plans.resident_plans` (in the unit layout each CTA's share of
    the leading ``n_d`` columns), which the wrapper settles with
    :func:`~.plans.fewest_waves`.  Past the largest cluster, up to
    :func:`in_reach`, the streaming branch's: on an aligned shape the
    layouts of ``LARGE_LAYOUTS`` that fit, else the scalar branch at 4 and 8
    CTAs a lane; the same set at every batch size, ordered by the fewest
    waves, then the most SMs (:func:`~.plans.estimated_held`,
    :func:`~.plans.plan_sms`), then that listing, which the wrapper settles
    with :func:`~.plans.first_granted`.  ``devex`` moves the reach line and
    the streaming plans' bytes (the weights' slice).  Raises ``ValueError``
    for a lane that fits neither branch.
    """
    if B < 1 or m < 1 or n < 1:
        raise ValueError("solve_segment: plans need B, m, n >= 1, got "
                         f"{(B, m, n)}")
    if resident(m, n, cluster_bytes, smem_limit):
        cbytes = functools.partial(cluster_bytes, n_d=n_d)
        return resident_plans(B, m, n, cbytes, sm_count, smem_limit)
    plans = (_large_candidates(m, n, devex, smem_limit)
             if in_reach(m, n, devex, smem_limit) else [])
    if not plans:
        raise ValueError(
            f"solve_segment: a lane of m={m}, n={n} is past the streaming "
            f"branch's line of {_line(m, n, devex)} bytes of shared memory "
            "(the vectors of the block per lane it replaced) and needs "
            f"{cluster_bytes(m, n, 16) + RESIDENT_STATIC_BYTES} per CTA of a "
            f"16-CTA cluster, past the {smem_limit} a block of the card may "
            "hold")
    return rank_plans(plans, B, lambda p: estimated_held(p, sm_count),
                      sm_count)


def built_stream_plans(B: int, m: int, n: int,
                       devex: bool = False) -> List[StreamingPlan]:
    """Every built layout of the streaming branch at (m, n): the candidates
    of :func:`segment_plans`, then on an aligned shape the scalar-load
    branch at each built cluster size (the card tests hold them against
    each other; ``tools/time_segment_plans.py`` times them)."""
    return built_streaming(
        "solve_segment", m, n, segment_plans(B, m, n, devex=devex),
        [large_scalar_plan(cl, m, n, devex) for cl in LARGE_SCALAR_CLUSTERS])


def clusters_held(plan) -> int:
    """Clusters of ``plan`` the current device holds at once, as the built
    kernel's occupancy query counts them (< 0: a negated CUDA error)."""
    lib = _build.library()
    if isinstance(plan, StreamingPlan):
        return lib.lp_solve_segment_large_max_clusters(
            plan.cluster, int(plan.aligned), plan.smem_bytes)
    return lib.lp_solve_segment_cluster_max_clusters(plan.cluster,
                                                     plan.smem_bytes)


@functools.lru_cache(maxsize=None)
def _choose_plan(B: int, m: int, n: int, devex: bool, device_index: int,
                 pointers_aligned: bool, n_d: Optional[int] = None):
    """:func:`~.plans.fewest_waves` on the cluster-resident branch,
    :func:`~.plans.first_granted` on the streaming branch, by the built
    kernel's occupancy query on this device; unaligned pointers take each
    streaming candidate's scalar branch."""
    props = torch.cuda.get_device_properties(device_index)
    plans = segment_plans(B, m, n, props.multi_processor_count, devex=devex,
                          n_d=n_d)
    held = held_on(device_index, clusters_held)
    if not isinstance(plans[0], StreamingPlan):
        return fewest_waves(plans, B, held, "solve_segment")
    if not pointers_aligned:
        plans = scalar_for_unaligned(
            plans, lambda cl: large_scalar_plan(cl, m, n, devex))
    return first_granted(plans, held, "solve_segment",
                         f" for m={m}, n={n}")


def pack_min_keys(vals, mask, idx, bits: int, negate: bool):
    """i32 keys whose min fuses value-min, argmin and any-eligible.

    ``negate=False`` for nonnegative ``vals``, ``negate=True`` for negative
    ones; masked-out entries get ``INT32_MAX``.
    """
    u = vals.view(torch.int32)
    if negate:
        u = torch.bitwise_not(u)
    key = torch.bitwise_or(torch.bitwise_and(u, -(1 << bits)), idx)
    return torch.where(mask, key, torch.full_like(key, INTMAX))


def _unpack_value(key, bits: int):
    return torch.bitwise_and(key, -(1 << bits)).view(torch.float32)


def _nonneg(x):
    """``max(x, 0)`` with ``-0.0 -> +0.0`` and NaN kept (XLA's maximum)."""
    return torch.clamp_min(x, 0.0) + 0.0


def _take(v, idx):
    """``v[b, idx[b]]`` per lane, read as the reference's masked sum reads
    it (``-0.0`` comes back ``+0.0``)."""
    out = torch.gather(v, 1, idx.long()[:, None])[:, 0]
    return out + 0 if out.dtype == torch.int32 else out + 0.0


def _column(M, idx):
    """``M[b, :, idx[b]]`` per lane: ``[B, rows]``."""
    B, rows, _ = M.shape
    return torch.gather(M, 2, idx.long()[:, None, None].expand(B, rows, 1))[:, :, 0]


def _direction(a, invBT, factor_rb: int):
    """``d[b, i] = sum_j a[b, j] invBT[b, j, i]``; with ``factor_rb > 0`` the
    sum runs block by block over ``factor_rb`` rows of the factor."""
    if factor_rb <= 0:
        return torch.einsum("bj,bji->bi", a, invBT)
    d = torch.zeros_like(a)
    for k0 in range(0, a.shape[1], factor_rb):
        d = d + torch.einsum("bj,bji->bi", a[:, k0:k0 + factor_rb],
                             invBT[:, k0:k0 + factor_rb])
    return d


def bf16_halves(x):
    """``(hi, lo)`` in f32 with ``hi = bf16(x)`` and ``lo = bf16(x - hi)``,
    both rounded to nearest even."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def split_price(y, A):
    """``(yh Ah + yh Al) + yl Ah`` of the bf16 halves of ``y[B, m]`` and
    ``A[B, m, n]``, each product in f32 (exact per term)."""
    yh, yl = bf16_halves(y)
    Ah, Al = bf16_halves(A)
    prod = lambda u, M: torch.einsum("bj,bjk->bk", u, M)  # noqa: E731
    return (prod(yh, Ah) + prod(yh, Al)) + prod(yl, Ah)


def check_modes(dual: bool, pricing: int, split: bool, ablate: int,
                what: str = "solve_segment") -> None:
    """Raise for a mode the kernel does not run: split pricing outside
    primal bland/dantzig (as the reference's wrapper raises), an unknown
    ablation mode."""
    if split and (dual or pricing == 2):
        raise ValueError(
            f"{what}: split pricing requires primal mode, bland/dantzig "
            "pricing (the reference's exact column and pivot-row paths are "
            "primal only; devex reads the pivot row of A)")
    if ablate not in range(8):
        raise ValueError(f"{what}: unknown ablation mode {ablate}")


def solve_segment_plain(A, c, apen, maxiters: int, state: SegmentState, *,
                        seg_len: int, pricing: int, opt_tol: float,
                        pivot_tol: float, dual: bool = False,
                        feas_tol: float = 1e-6, stall_limit: int = 0,
                        packed: bool = False, factor_rb: int = 0,
                        split: bool = False, ablate: int = 0,
                        n_blk: int = 0) -> SegmentState:
    """The plain PyTorch version, batched over lanes; updates ``state`` in
    place and returns it.  Each pass of the loop is one gated iteration of
    every lane (the reference's ``unroll > 1`` form).  ``factor_rb > 0``
    accumulates the direction ``d = B^-1 a`` over row blocks of that many
    factor rows, in the summation order of the streaming kernel's
    blocked-factor mode.  ``split`` and ``ablate`` as in
    :func:`solve_segment`.  ``n_blk > 0`` (primal, bland or dantzig) is the
    streaming kernel's sectional pricing: each iteration prices the section
    of ``n_blk`` columns it is in, stays there while the section yields an
    entering column, moves to the next when it comes up empty (an iteration
    without a pivot), and the lane is OPTIMAL once ``n / n_blk`` sections in
    a row came up empty; the section's packed keys carry its local index in
    ``(n_blk - 1).bit_length()`` bits, and a stalled lane takes the first
    eligible column of the section."""
    check_modes(dual, pricing, split, ablate)
    invBT, bfs, cB, basis, pen, gamma, iters, status = (
        t.clone() for t in state
    )
    B, m, n = A.shape
    dev = A.device
    inf = float("inf")
    lane_n = torch.arange(n, dtype=torch.int32, device=dev)
    lane_m = torch.arange(m, dtype=torch.int32, device=dev)
    bits_n = max(1, (n - 1).bit_length())
    bits_m = max(1, (m - 1).bit_length())
    lo_n = (1 << bits_n) - 1
    lo_m = (1 << bits_m) - 1
    dantzig = pricing >= 1
    track_stall = stall_limit > 0 and pricing >= 1
    zero_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_i = torch.full((B,), n, dtype=torch.int32, device=dev)
    m_i = torch.full((B,), m, dtype=torch.int32, device=dev)

    def first_where(mask, lanes, size):
        return torch.where(mask, lanes, size).min(dim=1).values

    z = (cB * bfs).sum(dim=1) if track_stall else torch.zeros_like(bfs[:, 0])
    dz_prev = torch.full_like(z, inf)
    stall = zero_i.clone()
    bland = torch.zeros((B,), dtype=torch.bool, device=dev)
    if n_blk:
        if dual or pricing == 2 or n % n_blk:
            raise ValueError("sectional pricing: primal bland/dantzig with "
                             f"n % n_blk == 0 (n={n}, n_blk={n_blk})")
        n_sec = n // n_blk
        lane_b = torch.arange(n_blk, dtype=torch.int32, device=dev)
        bits_b = max(1, (n_blk - 1).bit_length())
        sec = zero_i.clone()
        empty = zero_i.clone()
        nb_i = torch.full((B,), n_blk, dtype=torch.int32, device=dev)

    for it in range(seg_len):
        run = (status == st.RUNNING) & (iters < maxiters)
        if not bool(run.any()):
            break
        if track_stall:
            progressed = torch.abs(dz_prev) > 1e-6 * (torch.abs(z) + 1.0)
            stall_new = torch.where(progressed, zero_i, stall + 1)
            bland_new = ~progressed & ((stall_new >= stall_limit) | bland)
            stall = torch.where(run, stall_new, stall)
            bland = torch.where(run, bland_new, bland)
        use_bland = bland if track_stall else torch.zeros_like(bland)

        r = None
        if dual:
            neg = bfs < -feas_tol
            first = first_where(neg, lane_m, m)
            if dantzig and packed:
                k0 = pack_min_keys(bfs, neg, lane_m, bits_m, True).min(dim=1).values
                viable = k0 != INTMAX
                leave = torch.where(use_bland, first,
                                    torch.bitwise_and(k0, lo_m))
            elif dantzig:
                worst = bfs.min(dim=1).values
                viable = worst < -feas_tol
                hot = first_where(bfs == worst[:, None], lane_m, m)
                leave = torch.where(use_bland, first, hot)
            else:
                leave = first
                viable = leave < m
            leave = torch.where(viable, leave, zero_i)
            w = _column(invBT, leave)  # row `leave` of B^-1
            urow = torch.einsum("bj,bjk->bk", w, A)
            y = torch.einsum("bi,bji->bj", cB, invBT)
            r = c - torch.einsum("bj,bjk->bk", y, A)
            cand = (urow < -pivot_tol) & (pen == 0.0)
            theta_d = torch.where(
                cand, -r / torch.where(cand, urow, -1.0), inf
            )
            if packed:
                d0 = pack_min_keys(_nonneg(theta_d), cand, lane_n, bits_n,
                                   False).min(dim=1).values
                any_cand = d0 != INTMAX
                enter = torch.where(any_cand, torch.bitwise_and(d0, lo_n),
                                    zero_i)
                best_d = torch.where(any_cand, _unpack_value(d0, bits_n), inf)
            else:
                best_d = theta_d.min(dim=1).values
                any_cand = best_d < inf
                enter = first_where(cand & (theta_d == best_d[:, None]),
                                    lane_n, n)
                enter = torch.where(any_cand, enter, zero_i)
            do_pivot = viable & any_cand & run
            stop_status = torch.where(
                ~viable, st.OPTIMAL,
                torch.where(~any_cand, st.DUAL_UNBOUNDED, st.RUNNING),
            ).to(torch.int32)
            d = _direction(_column(A, enter), invBT, factor_rb)
        else:
            y = torch.einsum("bi,bji->bj", cB, invBT)
            swept = torch.ones_like(bland)  # every column priced
            if n_blk:  # the section's columns only; local indices
                cols = ((sec * n_blk)[:, None] + lane_b[None, :]).long()
                A_sec = torch.gather(A, 2, cols[:, None, :].expand(B, m,
                                                                   n_blk))
                r = (torch.gather(c, 1, cols)
                     - torch.einsum("bj,bjk->bk", y, A_sec)
                     + torch.gather(pen, 1, cols))
                neg = r < -opt_tol
                first = first_where(neg, lane_b, n_blk)
                if dantzig and packed:
                    k0 = pack_min_keys(r, neg, lane_b, bits_b,
                                       True).min(dim=1).values
                    eligible = k0 != INTMAX
                    loc = torch.where(use_bland, first,
                                      torch.bitwise_and(k0, (1 << bits_b) - 1))
                elif dantzig:
                    best = r.min(dim=1).values
                    eligible = best < -opt_tol
                    loc = torch.where(use_bland, first, first_where(
                        r == best[:, None], lane_b, n_blk))
                else:
                    loc = first
                    eligible = loc < nb_i
                loc = torch.where(eligible, loc, zero_i)
                enter = sec * n_blk + loc
                # an empty section: move on; every section empty in a row
                # under this basis proves optimality
                empty = torch.where(run, torch.where(eligible, zero_i,
                                                     empty + 1), empty)
                sec = torch.where(run & ~eligible, (sec + 1) % n_sec, sec)
                swept = empty >= n_sec
            else:
                if ablate == 1:  # the pricing product dropped
                    r = c - y.sum(dim=1)[:, None] + pen
                elif split:
                    r = c - split_price(y, A) + pen
                else:
                    r = c - torch.einsum("bj,bjk->bk", y, A) + pen
                neg = r < -opt_tol
                first = first_where(neg, lane_n, n)
                if ablate == 4:  # the entering selection skipped
                    enter = torch.full_like(zero_i, it % n)
                    eligible = torch.ones_like(bland)
                elif packed and pricing == 1:
                    k0 = pack_min_keys(r, neg, lane_n, bits_n,
                                       True).min(dim=1).values
                    eligible = k0 != INTMAX
                    enter = torch.where(use_bland, first,
                                        torch.bitwise_and(k0, lo_n))
                else:
                    if pricing == 2:  # devex: maximize r^2 / gamma
                        score = torch.where(neg, (r * r) / gamma, -inf)
                        best_s = score.max(dim=1).values
                        eligible = best_s > -inf
                        hot = first_where(score == best_s[:, None], lane_n,
                                          n)
                    elif dantzig:
                        best = r.min(dim=1).values
                        eligible = best < -opt_tol
                        hot = first_where(r == best[:, None], lane_n, n)
                    else:
                        hot = first
                        eligible = hot < n
                    enter = torch.where(use_bland, first, hot)
                enter = loc = torch.where(eligible, enter, zero_i)
            if ablate == 2:  # the direction product dropped: d = a
                d = _column(A, enter)
            else:
                d = _direction(_column(A, enter), invBT, factor_rb)
            pos = d > pivot_tol
            theta = torch.where(
                pos, _nonneg(bfs) / torch.where(pos, d, 1.0), inf
            )
            if ablate == 5:  # the ratio-test reductions skipped
                any_pos = torch.ones_like(bland)
                leave = torch.full_like(zero_i, it % m)
                best_t = torch.zeros_like(z)
            elif packed:
                t0 = pack_min_keys(theta, pos, lane_m, bits_m,
                                   False).min(dim=1).values
                any_pos = t0 != INTMAX
                leave = torch.where(any_pos, torch.bitwise_and(t0, lo_m),
                                    zero_i)
                best_t = torch.where(any_pos, _unpack_value(t0, bits_m), inf)
            else:
                best_t = theta.min(dim=1).values
                any_pos = best_t < inf
                leave = first_where(pos & (theta == best_t[:, None]),
                                    lane_m, m)
                leave = torch.where(any_pos, leave, zero_i)
            do_pivot = eligible & any_pos & run
            stop_status = torch.where(
                ~eligible & swept, st.OPTIMAL,
                torch.where(eligible & ~any_pos, st.PRIMAL_UNBOUNDED,
                            st.RUNNING),
            ).to(torch.int32)
            r_enter = _take(r, loc)

        at_leave = lane_m[None, :] == leave[:, None]
        at_enter = lane_n[None, :] == enter[:, None]
        if ablate == 6:  # the masked scalar extracts skipped
            d_l = torch.ones_like(z)
            bfs_l = torch.zeros_like(z)
            leaving_col = zero_i
            c_enter = torch.zeros_like(z)
            r_enter = torch.zeros_like(z)
        else:
            d_l = _take(d, leave)
            bfs_l = _take(bfs, leave)
            leaving_col = _take(basis, leave)
            c_enter = _take(c, enter)
        safe = torch.where(d_l == 0, 1.0, d_l)
        u = -d / safe[:, None]
        u = torch.where(at_leave, (1.0 / safe - 1.0)[:, None], u)
        u = torch.where(do_pivot[:, None], u, 0.0)

        col_l = _column(invBT, leave)  # column `leave` of B^-T
        if ablate != 3:  # 3: the factor's update skipped
            invBT = invBT + col_l[:, :, None] * u[:, None, :]
        bfs = bfs + u * bfs_l[:, None]
        piv = do_pivot[:, None] & (ablate != 7)  # 7: no bookkeeping writes
        basis = torch.where(at_leave & piv, enter[:, None], basis)
        cB = torch.where(piv & at_leave, c_enter[:, None], cB)
        pen_new = torch.where(
            at_enter, inf,
            torch.where(lane_n[None, :] == leaving_col[:, None], apen, pen),
        )
        pen = torch.where(piv, pen_new, pen)

        if pricing == 2:
            # devex reference weights from the pivot row of the old tableau
            w = torch.einsum("bj,bjk->bk", col_l, A)
            gamma_q = torch.clamp_min(_take(gamma, enter), 1.0)
            ratio2 = (w / safe[:, None]) * (w / safe[:, None])
            gamma_new = torch.maximum(gamma, ratio2 * gamma_q[:, None])
            g_leave = torch.clamp_min(gamma_q / (safe * safe), 1.0)
            gamma_new = torch.where(
                lane_n[None, :] == leaving_col[:, None], g_leave[:, None],
                gamma_new,
            )
            gamma_new = torch.clamp_max(gamma_new, 1e12)
            gamma = torch.where(piv, gamma_new, gamma)

        if track_stall:
            if dual:
                dz = -best_d * bfs_l
            else:
                dz = best_t * r_enter
            dz = torch.where(do_pivot, dz, 0.0)
        else:
            dz = torch.zeros_like(z)
        status = torch.where(run, stop_status, status)
        iters = iters + run.to(torch.int32)
        z = z + dz
        dz_prev = dz

    for dst, src in zip(state, (invBT, bfs, cB, basis, pen, gamma, iters,
                                status)):
        dst.copy_(src)
    return state


def check_tensors(what: str, want: dict, device) -> None:
    """Raise unless every ``name: (tensor, shape, dtype)`` of ``want`` has
    that shape and type, lies on ``device`` and is contiguous (the kernels
    index raw pointers, and update their state in place)."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_segment_args(A, c, apen, state: SegmentState,
                       what: str = "solve_segment") -> None:
    """Raise unless the arguments have the kernels' shapes, types, device
    and contiguity."""
    B, m, n = A.shape
    f32, i32 = torch.float32, torch.int32
    check_tensors(what, {
        "A": (A, (B, m, n), f32),
        "c": (c, (B, n), f32),
        "apen": (apen, (B, n), f32),
        "invBT": (state.invBT, (B, m, m), f32),
        "bfs": (state.bfs, (B, m), f32),
        "cB": (state.cB, (B, m), f32),
        "basis": (state.basis, (B, m), i32),
        "pen": (state.pen, (B, n), f32),
        "gamma": (state.gamma, (B, n), f32),
        "iters": (state.iters, (B,), i32),
        "status": (state.status, (B,), i32),
    }, A.device)


def _unit_layout(unit: Optional[UnitColumns], A, split: bool,
                 ablate: int) -> Optional[UnitColumns]:
    """``unit`` where a launch takes the unit layout: the cluster-resident
    branch, neither split pricing nor an ablation mode, and a map that
    leaves some column out of shared memory; None for the dense launch.
    Raises for a map of the wrong shape, type or device."""
    B, m, n = A.shape
    if (unit is None or unit.n_d >= n or split or ablate
            or not resident(m, n, cluster_bytes)):
        return None
    if unit.n_d < 0:
        raise ValueError(f"solve_segment: unit columns from {unit.n_d}")
    check_tensors("solve_segment", {
        "unit.rows": (unit.rows, (B, n - unit.n_d), torch.int32),
        "unit.vals": (unit.vals, (B, n - unit.n_d), torch.float32),
    }, A.device)
    return unit


def solve_segment(A, c, apen, maxiters: int, state: SegmentState, *,
                  seg_len: int, pricing: int, opt_tol: float,
                  pivot_tol: float, dual: bool = False,
                  feas_tol: float = 1e-6, stall_limit: int = 0,
                  unroll: int = 1, packed: bool = False, split: bool = False,
                  ablate: int = 0,
                  unit: Optional[UnitColumns] = None) -> SegmentState:
    """Run up to ``seg_len`` simplex iterations per lane; updates ``state``
    in place and returns it.

    ``A[B, m, n]``, ``c[B, n]``, ``apen[B, n]`` (+inf on columns that may
    never enter), ``maxiters`` (host int), ``pricing`` 0 = bland,
    1 = dantzig, 2 = devex.  ``split`` prices with bf16 halves (primal
    bland/dantzig only; otherwise ``ValueError``), ``ablate`` 1..7 drops
    one stage for profiling (see the module docstring).  ``unit`` (from
    :func:`unit_columns`) lets the cluster-resident branch take the unit
    layout, with the same bits, where it takes fewer CTAs a lane
    (:func:`unit_pays`); the other launches and the plain version ignore
    it.  ``unroll`` is accepted for parity with the reference and
    ignored: it never changed results.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.
    """
    del unroll
    check_segment_args(A, c, apen, state)
    if pricing not in (0, 1, 2):
        raise ValueError(f"solve_segment: unknown pricing code {pricing}")
    check_modes(dual, pricing, split, ablate)
    kw = dict(seg_len=seg_len, pricing=pricing, opt_tol=opt_tol,
              pivot_tol=pivot_tol, dual=dual, feas_tol=feas_tol,
              stall_limit=stall_limit, packed=packed, split=bool(split),
              ablate=int(ablate))
    if A.device.type == "cpu":
        return solve_segment_plain(A, c, apen, maxiters, state, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"solve_segment: unsupported device {A.device}")
    B, m, n = A.shape
    if B == 0 or seg_len <= 0:
        # a lane too large raises all the same
        segment_plans(max(B, 1), m, n, devex=pricing == 2)
        return state
    unit = _unit_layout(unit, A, split, ablate)
    if unit is not None and not unit_pays(B, m, n, unit.n_d, A.device):
        unit = None
    plan = _choose_plan(B, m, n, pricing == 2, cuda_index(A.device),
                        aligned_pointers(A, state.invBT),
                        None if unit is None else unit.n_d)
    return launch_with_plan(plan, A, c, apen, maxiters, state, unit=unit,
                            **kw)


def launch_with_plan(plan, A, c, apen, maxiters: int,
                     state: SegmentState, *, seg_len: int, pricing: int,
                     opt_tol: float, pivot_tol: float, dual: bool = False,
                     feas_tol: float = 1e-6, stall_limit: int = 0,
                     packed: bool = False, split: bool = False,
                     ablate: int = 0,
                     unit: Optional[UnitColumns] = None) -> SegmentState:
    """Launch the CUDA kernel under ``plan`` (one of :func:`segment_plans`,
    or a variation of one: the card tests hold cluster sizes, load
    branches and layouts against each other); a cluster-resident plan takes
    the unit layout where :func:`solve_segment` would (``plan`` then from
    ``segment_plans(..., n_d=unit.n_d)``).  CUDA tensors only; the C entry
    point refuses a plan that does not fit the shape."""
    global launches, launches_dual, launches_split, last_plan
    global launches_streaming, launches_streaming_dual, launches_unit
    check_segment_args(A, c, apen, state)
    if A.device.type != "cuda":
        raise ValueError("launch_with_plan needs CUDA tensors")
    if pricing not in (0, 1, 2):
        raise ValueError(f"solve_segment: unknown pricing code {pricing}")
    check_modes(dual, pricing, split, ablate)
    B, m, n = A.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    args = (
        A.data_ptr(), c.data_ptr(), apen.data_ptr(),
        state.invBT.data_ptr(), state.bfs.data_ptr(), state.cB.data_ptr(),
        state.basis.data_ptr(), state.pen.data_ptr(), state.gamma.data_ptr(),
        state.iters.data_ptr(), state.status.data_ptr(),
        B, m, n, min(int(seg_len), 0x7FFFFFFF), int(maxiters),
        float(opt_tol), float(pivot_tol), float(feas_tol),
        int(bool(dual)), int(pricing), int(bool(packed)), int(stall_limit),
        int(bool(split)), int(ablate),
    )
    streaming = isinstance(plan, StreamingPlan)
    unit = None if streaming else _unit_layout(unit, A, split, ablate)
    n_d = n if unit is None else unit.n_d
    with torch.cuda.device(A.device):
        if streaming:
            code = lib.lp_solve_segment_large(
                *args, plan.cluster, int(plan.aligned), plan.stages,
                plan.stage_floats, plan.warp_stages, plan.chunk_floats,
                plan.smem_bytes, stream)
        else:
            aligned = (slices_aligned(m, n) and n_d % 4 == 0
                       and aligned_pointers(A, state.invBT))
            code = lib.lp_solve_segment_cluster(
                *args, None if unit is None else unit.rows.data_ptr(),
                None if unit is None else unit.vals.data_ptr(), n_d,
                plan.cluster, int(aligned), plan.smem_bytes, stream)
    _build.check(code, "solve_segment launch")
    launches += 1
    launches_dual += int(bool(dual))
    launches_split += int(bool(split))
    launches_streaming += int(streaming)
    launches_streaming_dual += int(streaming and bool(dual))
    launches_unit += int(unit is not None)
    if ablate:
        launches_ablate[ablate] += 1
    last_plan = plan
    note("segment", held_cols=n_d, cluster=plan.cluster,
         branch="stream" if streaming else "resident")
    return state
