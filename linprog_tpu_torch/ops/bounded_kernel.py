"""Whole-segment bounded-variable simplex kernel: up to ``seg_len``
iterations of ``min c'x, Ax = b, lb <= x <= ub`` per lane in one launch,
with the lane's state updated in place.

Replaces the Pallas kernel ``linprog_tpu/ops/bounded_kernel.py ::
solve_bounded_segment`` (body ``_bounded_kernel``).  One iteration: duals
``y = c_B B^-1``; bound-aware reduced costs (``yA - c`` for a variable at
its lower bound, ``c - yA`` at its upper bound, basic columns at ``-inf``);
the Dantzig entering column; the direction ``d = B^-1 a``; the three-way
ratio test (a basic variable drops to its lower bound, a basic variable
hits its upper bound, or the entering variable crosses to its other
bound); then either a bound flip (no basis change) or a pivot with a
rank-1 eta update of ``B^-T``, and the incremental bfs, c_B, lb_B, ub_B,
basis and variable-state updates.

What must carry over exactly, and does here in both versions:

* pricing is always Dantzig on the bound-aware reduced costs, with the
  ABSOLUTE ``opt_tol``; there is no stall escalation and no Bland;
* the rooms ``bfs - lb_B`` and ``ub_B - bfs`` clamp to ``+0.0`` (a ``-0.0``
  key would win every tie at zero);
* infinite upper bounds pass through: ``gamma3 = ub_e - lb_e`` may be
  ``inf``, and the step length is selected, never multiplied by a flag;
* packed mode compares the two ratio KEYS (index bits included) to decide
  which bound the leaving variable lands on and re-reads the step length
  exactly at the chosen row; unpacked mode compares the two values;
* a flip counts as an iteration; a lane that is not RUNNING, or has
  reached ``maxiters``, is untouched;
* ``unroll`` never changes results (accepted and ignored), and the port
  takes A only: ``use_at`` chose a VMEM layout and is accepted and ignored.

Variable states are int8 codes (``AT_LB`` 0, ``AT_UB`` 1, ``BASIC`` 2); the
reference's kernel carries them as f32 only because of a Mosaic rule.

On the H100 (``csrc/solve_bounded_segment.cu``) the two branches of the
whole-segment kernel, chosen by (m, n) alone.  Where A and ``B^-T`` fit a
cluster of at most 16 CTAs, the lane's cluster loads them into shared
memory once and runs the segment on chip (band partials added through
distributed shared memory in one fixed tree, the duals from each pivot's
eta pass; the bits do not depend on the cluster size).  Past it the
streaming branch, in kernel 3's design (``csrc/stream_ring.cuh``): a
cluster of 4 or 8 CTAs splits the lane by rows in 8 fixed bands, streams
its rows of A and ``B^-T`` from device memory each pass (bulk-copy rings on
aligned shapes, scalar loads otherwise), adds the partials through
distributed shared memory in the same fixed tree, prices and selects over
a slice of the columns per CTA, and takes the next duals from each pivot's
eta pass; a lane's bits do not depend on the cluster size nor on the load
branch.  It is bound by device-memory bandwidth: a pivot moves A once and
``B^-T`` three times.  :func:`segment_plans` lays the launch out.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import torch

from .. import status as st
from ..observability import note
from . import _build
from .plans import (RESIDENT_STATIC_BYTES, SM_COUNT, SMEM_LIMIT, SegmentPlan,
                    StreamingPlan, _round4, aligned_pointers, band_slice_len,
                    best_ranked, built_streaming, cuda_index, estimated_held,
                    fewest_waves, held_on, packed_scalar_plan, rank_plans,
                    resident, resident_plans, scalar_for_unaligned, slice_len,
                    slices_aligned, streaming_plan)
from .solve_kernel import INTMAX, _nonneg, check_tensors, pack_min_keys

AT_LB, AT_UB, BASIC = 0, 1, 2

launches = 0  # CUDA launches of the kernel (never the plain version)
last_plan = None  # the plan of the last launch

# The streaming branch's builds (csrc/solve_bounded_segment.cu:
# LP_STREAM_SIZES, kStreamCtas): 4 and 8 CTAs a lane on both load branches,
# each instantiation capped at the registers of two CTAs an SM.
STREAM_CLUSTERS = (4, 8)
STREAM_CTAS = 2
# (CTAs a lane, CTAs an SM) of the bulk-copy candidates: a ring that fills
# the SM, or half of it so that two CTAs share the SM.  Listed best first
# where waves and SMs tie: two CTAs an SM hide more of each pass's latency
# (at [16, 1280, 2560] on an H100, 8 CTAs a lane two to an SM beat 4 a lane
# one to an SM, both in one wave on 64 SMs; see PERF.md)
STREAM_LAYOUTS = ((8, 2), (4, 1), (8, 1))


class BoundedSegmentState(NamedTuple):
    """The kernel's in-place state: ``invBT[B, m, m]`` (the TRANSPOSED basis
    inverse), ``bfs[B, m]``, ``cB[B, m]``, ``basis[B, m]`` i32,
    ``vstate[B, n]`` i8 (0 = AT_LB, 1 = AT_UB, 2 = BASIC), ``lbB[B, m]`` and
    ``ubB[B, m]`` (the bounds of the basic variables), ``iters[B]`` i32,
    ``status[B]`` i32."""

    invBT: torch.Tensor
    bfs: torch.Tensor
    cB: torch.Tensor
    basis: torch.Tensor
    vstate: torch.Tensor
    lbB: torch.Tensor
    ubB: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor


def cluster_bytes(m: int, n: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA on the cluster-resident branch: its
    rows of A and of ``B^-T``; d, u, c_B, bfs, lbB, ubB and the basis whole;
    c, lb and ub whole; its partials over n (pricing) and over m (the
    direction); three slices of m; then the variable states whole, one byte
    each."""
    ml = slice_len(m, cluster)
    return (4 * (_round4(ml * n) + _round4(ml * m)
                 + _round4(8 * m + 4 * n + 3 * ml)) + -(-n // 16) * 16)


def stream_vector_bytes(m: int, n: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA's vectors on the streaming branch:
    d, u and c_B whole, its partial over ``max(m, n)`` entries, seven slices
    of m (y, the entering column, the factor's column at the leaving row,
    bfs, lbB, ubB, the basis) and five of n (c, lb, ub, the reduced costs,
    the variable states), slices of whole bands of ``ceil(size / 8)``."""
    ml, nl = band_slice_len(m, cluster), band_slice_len(n, cluster)
    return 4 * _round4(3 * m + max(m, n) + 7 * ml + 5 * nl)


def scalar_plan(cluster: int, m: int, n: int,
                smem_limit: int = SMEM_LIMIT) -> Optional[StreamingPlan]:
    """The scalar-load branch at ``cluster`` CTAs a lane, sized for as many
    CTAs an SM as the build allows and its vectors leave room for."""
    return packed_scalar_plan(cluster, STREAM_CTAS,
                              stream_vector_bytes(m, n, cluster), smem_limit)


def _stream_candidates(m: int, n: int,
                       smem_limit: int) -> List[StreamingPlan]:
    if slices_aligned(m, n):
        plans = [streaming_plan(cl, ctas, stream_vector_bytes(m, n, cl), m,
                                True, smem_limit)
                 for cl, ctas in STREAM_LAYOUTS]
    else:
        plans = [scalar_plan(cl, m, n, smem_limit) for cl in STREAM_CLUSTERS]
    return [p for p in plans if p is not None]


def _line(m: int, n: int) -> int:
    # the vectors of the block per lane (9m + 5n floats)
    return 4 * (9 * m + 5 * n) + RESIDENT_STATIC_BYTES


def in_reach(m: int, n: int, smem_limit: int = SMEM_LIMIT) -> bool:
    """The line up to which the streaming branch is offered: that of the
    one-block-per-lane branch it replaced, whose vectors (9m + 5n floats)
    had to fit one block, m ~ 3000 at n = 2m.  The streaming branch's own
    vectors are smaller; raising the line takes a card test of its own."""
    return _line(m, n) <= smem_limit


def has_plan(m: int, n: int, smem_limit: int = SMEM_LIMIT) -> bool:
    """Whether a lane of (m, n) fits one of the kernel's branches (where it
    does not, :func:`segment_plans` raises): the cluster-resident branch, or
    the streaming branch up to :func:`in_reach`."""
    return (resident(m, n, cluster_bytes, smem_limit)
            or (in_reach(m, n, smem_limit)
                and bool(_stream_candidates(m, n, smem_limit))))


def segment_plans(B: int, m: int, n: int, sm_count: int = SM_COUNT,
                  smem_limit: int = SMEM_LIMIT) -> list:
    """Candidate launch plans for ``B`` lanes of (m, n), best first.

    The branch follows from (m, n) alone (:func:`~.plans.resident`).  On
    the cluster-resident branch the candidates are
    :func:`~.plans.resident_plans`, which the wrapper settles with
    :func:`~.plans.fewest_waves`.  Past it, up to :func:`in_reach`, the
    streaming branch's: on an aligned shape 8 CTAs a lane with half an
    SM's ring (two CTAs an SM), and 4 and 8 with a ring that fills the SM;
    on another shape the scalar branch at 8 and 4.  The same set at every
    batch size; ordered by the fewest waves, then the most SMs
    (:func:`~.plans.estimated_held`, :func:`~.plans.plan_sms`), then that
    listing, which the wrapper settles with :func:`~.plans.best_ranked`.
    Raises ``ValueError`` for a lane that fits neither branch.
    """
    if B < 1 or m < 1 or n < 1:
        raise ValueError("solve_bounded_segment: plans need B, m, n >= 1, "
                         f"got {(B, m, n)}")
    if resident(m, n, cluster_bytes, smem_limit):
        return resident_plans(B, m, n, cluster_bytes, sm_count, smem_limit)
    plans = (_stream_candidates(m, n, smem_limit)
             if in_reach(m, n, smem_limit) else [])
    if not plans:
        raise ValueError(
            f"solve_bounded_segment: a lane of m={m}, n={n} is past the "
            f"streaming branch's line of {_line(m, n)} bytes of shared memory"
            f" (9m + 5n floats in one block) and needs "
            f"{cluster_bytes(m, n, 16) + RESIDENT_STATIC_BYTES} per CTA of a "
            f"16-CTA cluster, past the {smem_limit} a block of the card may "
            "hold")
    return rank_plans(plans, B, lambda p: estimated_held(p, sm_count),
                      sm_count)


def built_stream_plans(B: int, m: int, n: int) -> List[StreamingPlan]:
    """Every built layout of the streaming branch at (m, n): the candidates
    of :func:`segment_plans`, then on an aligned shape the scalar-load
    branch at each built cluster size (the card tests hold them against
    each other; ``tools/time_segment_plans.py --bounded`` times them)."""
    return built_streaming(
        "solve_bounded_segment", m, n, segment_plans(B, m, n),
        [scalar_plan(cl, m, n) for cl in STREAM_CLUSTERS])


def clusters_held(plan) -> int:
    """Clusters of ``plan`` the current device holds at once, as the built
    kernel's occupancy query counts them (< 0: a negated CUDA error)."""
    lib = _build.library()
    if isinstance(plan, StreamingPlan):
        return lib.lp_solve_bounded_stream_max_clusters(
            plan.cluster, int(plan.aligned), plan.smem_bytes)
    return lib.lp_solve_bounded_cluster_max_clusters(plan.cluster,
                                                     plan.smem_bytes)


@functools.lru_cache(maxsize=None)
def _choose_plan(B: int, m: int, n: int, device_index: int,
                 pointers_aligned: bool):
    """:func:`~.plans.fewest_waves` on the cluster-resident branch,
    :func:`~.plans.best_ranked` on the streaming branch, by the built
    kernel's occupancy query on this device; unaligned pointers take each
    streaming candidate's scalar branch."""
    props = torch.cuda.get_device_properties(device_index)
    plans = segment_plans(B, m, n, props.multi_processor_count)
    held = held_on(device_index, clusters_held)
    if not isinstance(plans[0], StreamingPlan):
        return fewest_waves(plans, B, held, "solve_bounded_segment")
    if not pointers_aligned:
        plans = scalar_for_unaligned(plans,
                                     lambda cl: scalar_plan(cl, m, n))
    return best_ranked(plans, B, held, props.multi_processor_count,
                       "solve_bounded_segment", f" for m={m}, n={n}")


def _pick(v, at):
    """``v[b, k]`` at the one position where ``at[b, k]`` holds, read as the
    reference's masked sum reads it: ``-0.0`` comes back ``+0.0``, ``inf``
    passes through, and no position gives 0."""
    return torch.where(at, v, torch.zeros_like(v)).sum(dim=1, dtype=v.dtype)


def solve_bounded_segment_plain(A, c, lb, ub, maxiters: int,
                                state: BoundedSegmentState, *, seg_len: int,
                                opt_tol: float, pivot_tol: float,
                                packed: bool = False) -> BoundedSegmentState:
    """The plain PyTorch version, batched over lanes; updates ``state`` in
    place and returns it.  Each pass of the loop is one gated iteration of
    every lane."""
    invBT, bfs, cB, basis, vstate, lbB, ubB, iters, status = (
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
    zero_i = torch.zeros((B,), dtype=torch.int32, device=dev)

    def first_where(mask, lanes, size):
        return torch.where(mask, lanes, size).min(dim=1).values

    for _ in range(seg_len):
        run = (status == st.RUNNING) & (iters < maxiters)
        if not bool(run.any()):
            break

        # ---- bound-aware Dantzig pricing ---------------------------------
        y = torch.einsum("bi,bji->bj", cB, invBT)
        zc = torch.einsum("bj,bjk->bk", y, A) - c
        rc = torch.where(vstate == AT_UB, -zc, zc)
        rc = torch.where(vstate == BASIC, -inf, rc)
        if packed:
            kr = pack_min_keys(-rc, rc > opt_tol, lane_n, bits_n,
                               True).min(dim=1).values
            eligible = kr != INTMAX
            enter = torch.where(eligible, torch.bitwise_and(kr, lo_n), zero_i)
        else:
            best = rc.max(dim=1).values
            eligible = best > opt_tol
            enter = first_where(rc == best[:, None], lane_n, n)
            enter = torch.where(eligible, enter, zero_i)
        at_enter = lane_n[None, :] == enter[:, None]
        vs_enter = _pick(vstate, at_enter)
        lb_e = _pick(lb, at_enter)
        ub_e = _pick(ub, at_enter)
        c_e = _pick(c, at_enter)
        sigma = torch.where(vs_enter == AT_LB, 1.0, -1.0).to(A.dtype)

        # ---- direction ----------------------------------------------------
        a_col = torch.gather(
            A, 2, enter.long()[:, None, None].expand(B, m, 1))[:, :, 0]
        d = torch.einsum("bj,bji->bi", a_col, invBT)
        sd = sigma[:, None] * d

        # ---- three-way ratio test -----------------------------------------
        room_lo = _nonneg(bfs - lbB)
        room_hi = _nonneg(ubB - bfs)
        pos = sd > pivot_tol
        neg = -sd > pivot_tol
        g1v = torch.where(pos, room_lo / torch.where(pos, sd, 1.0), inf)
        g2v = torch.where(neg, room_hi / torch.where(neg, -sd, 1.0), inf)
        gamma3 = ub_e - lb_e
        if packed:
            k1 = pack_min_keys(g1v, pos, lane_m, bits_m, False).min(dim=1).values
            k2 = pack_min_keys(g2v, neg, lane_m, bits_m, False).min(dim=1).values
            leave_to_lb = k1 < k2
            ksel = torch.minimum(k1, k2)
            leave_pre = torch.bitwise_and(ksel, lo_m)
            delta = _pick(torch.where(leave_to_lb[:, None], g1v, g2v),
                          lane_m[None, :] == leave_pre[:, None])
            delta = torch.where(ksel != INTMAX, delta, inf)
        else:
            g1 = g1v.min(dim=1).values
            g2 = g2v.min(dim=1).values
            delta = torch.minimum(g1, g2)
            leave_to_lb = g1 < g2

        unbounded = eligible & torch.isinf(delta) & torch.isinf(gamma3)
        traverse = gamma3 <= delta
        flip = eligible & ~unbounded & traverse & run
        piv = eligible & ~unbounded & ~traverse & run

        if packed:
            leave = torch.where(piv, leave_pre, zero_i)
        else:
            leave1 = first_where(g1v == g1[:, None], lane_m, m)
            leave2 = first_where(g2v == g2[:, None], lane_m, m)
            leave = torch.where(leave_to_lb, leave1, leave2)
            leave = torch.where(piv, leave, zero_i)
        at_leave = lane_m[None, :] == leave[:, None]

        # ---- incremental bfs: every basic moves by -step * sd; a pivot then
        # seats the entering variable's value in the leaving slot
        step_len = torch.where(flip, gamma3,
                               torch.where(piv, delta, torch.zeros_like(delta)))
        bfs_new = bfs - step_len[:, None] * sd
        enter_from = torch.where(sigma > 0.0, lb_e, ub_e)
        enter_val = enter_from + sigma * delta
        bfs_new = torch.where(piv[:, None] & at_leave, enter_val[:, None],
                              bfs_new)

        # ---- masked rank-1 eta update of B^-T -----------------------------
        d_l = _pick(d, at_leave)
        leaving_col = _pick(basis, at_leave)
        safe = torch.where(d_l == 0, 1.0, d_l)
        u = -d / safe[:, None]
        u = torch.where(at_leave, (1.0 / safe - 1.0)[:, None], u)
        u = torch.where(piv[:, None], u, 0.0)
        col_l = torch.gather(
            invBT, 2, leave.long().clamp_max(m - 1)[:, None, None]
            .expand(B, m, 1))[:, :, 0]  # column `leave` of B^-T
        invBT_new = invBT + col_l[:, :, None] * u[:, None, :]

        # ---- bookkeeping ---------------------------------------------------
        seat = at_leave & piv[:, None]
        basis_new = torch.where(seat, enter[:, None], basis)
        cB_new = torch.where(seat, c_e[:, None], cB)
        lbB_new = torch.where(seat, lb_e[:, None], lbB)
        ubB_new = torch.where(seat, ub_e[:, None], ubB)
        at_leaving_col = lane_n[None, :] == leaving_col[:, None]
        vs_flip = torch.where(at_enter & flip[:, None], 1 - vstate, vstate)
        vs_piv = torch.where(at_enter, BASIC, vstate)
        landed = torch.where(leave_to_lb, AT_LB, AT_UB).to(vstate.dtype)
        vs_piv = torch.where(at_leaving_col, landed[:, None], vs_piv)
        vstate_new = torch.where(piv[:, None], vs_piv, vs_flip)

        stop_status = torch.where(
            ~eligible, st.OPTIMAL,
            torch.where(unbounded, st.PRIMAL_UNBOUNDED, st.RUNNING),
        ).to(torch.int32)

        # a lane that may not act this pass is left exactly as it was
        r1, r2 = run[:, None], run[:, None, None]
        invBT = torch.where(r2, invBT_new, invBT)
        bfs = torch.where(r1, bfs_new, bfs)
        cB = torch.where(r1, cB_new, cB)
        basis = torch.where(r1, basis_new, basis)
        vstate = torch.where(r1, vstate_new.to(vstate.dtype), vstate)
        lbB = torch.where(r1, lbB_new, lbB)
        ubB = torch.where(r1, ubB_new, ubB)
        status = torch.where(run, stop_status, status)
        iters = iters + run.to(torch.int32)

    for dst, src in zip(state, (invBT, bfs, cB, basis, vstate, lbB, ubB,
                                iters, status)):
        dst.copy_(src)
    return state


def check_bounded_args(A, c, lb, ub, state: BoundedSegmentState) -> None:
    """Raise unless the arguments have the kernel's shapes, types, device
    and contiguity."""
    B, m, n = A.shape
    f32, i32 = torch.float32, torch.int32
    check_tensors("solve_bounded_segment", {
        "A": (A, (B, m, n), f32),
        "c": (c, (B, n), f32),
        "lb": (lb, (B, n), f32),
        "ub": (ub, (B, n), f32),
        "invBT": (state.invBT, (B, m, m), f32),
        "bfs": (state.bfs, (B, m), f32),
        "cB": (state.cB, (B, m), f32),
        "basis": (state.basis, (B, m), i32),
        "vstate": (state.vstate, (B, n), torch.int8),
        "lbB": (state.lbB, (B, m), f32),
        "ubB": (state.ubB, (B, m), f32),
        "iters": (state.iters, (B,), i32),
        "status": (state.status, (B,), i32),
    }, A.device)


def solve_bounded_segment(A, c, lb, ub, maxiters: int,
                          state: BoundedSegmentState, *, seg_len: int,
                          opt_tol: float, pivot_tol: float,
                          use_at: bool = False, unroll: int = 1,
                          packed: bool = False) -> BoundedSegmentState:
    """Run up to ``seg_len`` bounded-variable iterations per lane; updates
    ``state`` in place and returns it.

    ``A[B, m, n]``, ``c/lb/ub[B, n]`` (``ub`` may hold ``+inf``),
    ``maxiters`` (host int).  ``use_at`` and ``unroll`` are accepted for
    parity with the reference and ignored: neither changes results.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    del use_at, unroll
    check_bounded_args(A, c, lb, ub, state)
    kw = dict(seg_len=seg_len, opt_tol=opt_tol, pivot_tol=pivot_tol,
              packed=packed)
    if A.device.type == "cpu":
        return solve_bounded_segment_plain(A, c, lb, ub, maxiters, state, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"solve_bounded_segment: unsupported device {A.device}")
    B, m, n = A.shape
    if B == 0 or seg_len <= 0:
        segment_plans(max(B, 1), m, n)  # a lane too large raises all the same
        return state
    plan = _choose_plan(B, m, n, cuda_index(A.device),
                        aligned_pointers(A, state.invBT))
    return launch_with_plan(plan, A, c, lb, ub, maxiters, state, **kw)


def launch_with_plan(plan: SegmentPlan, A, c, lb, ub, maxiters: int,
                     state: BoundedSegmentState, *, seg_len: int,
                     opt_tol: float, pivot_tol: float,
                     packed: bool = False) -> BoundedSegmentState:
    """Launch the CUDA kernel under ``plan`` (one of :func:`segment_plans`,
    or a variation of one: the card tests hold cluster sizes and load
    branches against each other).  CUDA tensors only; the C entry point
    refuses a plan that does not fit the shape."""
    global launches, last_plan
    check_bounded_args(A, c, lb, ub, state)
    if A.device.type != "cuda":
        raise ValueError("launch_with_plan needs CUDA tensors")
    B, m, n = A.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    args = (
        A.data_ptr(), c.data_ptr(), lb.data_ptr(), ub.data_ptr(),
        state.invBT.data_ptr(), state.bfs.data_ptr(), state.cB.data_ptr(),
        state.basis.data_ptr(), state.vstate.data_ptr(),
        state.lbB.data_ptr(), state.ubB.data_ptr(),
        state.iters.data_ptr(), state.status.data_ptr(),
        B, m, n, min(int(seg_len), 0x7FFFFFFF), int(maxiters),
        float(opt_tol), float(pivot_tol), int(bool(packed)),
    )
    with torch.cuda.device(A.device):
        if isinstance(plan, StreamingPlan):
            code = lib.lp_solve_bounded_stream(
                *args, plan.cluster, int(plan.aligned), plan.stages,
                plan.stage_floats, plan.warp_stages, plan.chunk_floats,
                plan.smem_bytes, stream)
        else:
            aligned = (slices_aligned(m, n)
                       and aligned_pointers(A, state.invBT))
            code = lib.lp_solve_bounded_cluster(
                *args, plan.cluster, int(aligned), plan.smem_bytes, stream)
    _build.check(code, "solve_bounded_segment launch")
    launches += 1
    last_plan = plan
    note("segment", held_cols=n, cluster=plan.cluster,
         branch="stream" if isinstance(plan, StreamingPlan) else "resident")
    return state
