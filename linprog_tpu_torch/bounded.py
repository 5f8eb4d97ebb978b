"""Bounded-variable primal simplex, batched: ``min c'x  s.t. Ax = b,
lb <= x <= ub`` (counterpart of :mod:`linprog_tpu.bounded`).

Every variable carries a state in ``var_state[B, n]`` (``AT_LB`` / ``AT_UB``
/ ``BASIC``).  Two engines run the same iteration (bound-aware Dantzig
pricing, three-way ratio test, bound flips):

* the whole-segment kernel
  :func:`linprog_tpu_torch.ops.bounded_kernel.solve_bounded_segment`,
  driven in segments with exact refactorizations in between by
  :func:`run_bounded_batched`;
* the per-lane engine :func:`run_bounded` over :func:`bounded_step` (the
  reference's vmapped ``run_bounded``), written with the batch dimension
  explicit: each lane runs until it is terminal or at ``maxiters`` and
  refactorizes on its own cadence.  It is the plain-PyTorch parity engine
  behind ``kernels="torch"``, and with :func:`solve_bounded_two_phase` the
  two-phase solve that needs no starting basis.

The per-lane engine reports ``PRIMAL_UNBOUNDED`` only when no finite step
of any kind exists (a finite bound flip is a step), as the reference's
does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import status as st
from .config import SolverConfig
from .engine import (
    _eta,
    _gather_cols,
    _lane_pick,
    _rank1,
    _set_basis,
    basis_matrix,
    duals,
    inv_or_nan,
    run_lanes,
    tree_select,
)
from .engine_batched import (_finite_lanes, refresh_running_lanes,
                             segment_launch)
from .observability import host_read
from .ops.bounded_kernel import (
    AT_LB,
    AT_UB,
    BASIC,
    BoundedSegmentState,
    solve_bounded_segment,
)
from .utils.math import primal_simplex_div

__all__ = ["AT_LB", "AT_UB", "BASIC", "BoundedState", "nonbasic_values",
           "compute_bfs", "make_bounded_state", "run_bounded_batched",
           "expand_bounded_bfs", "bounded_reduced_costs", "bounded_step",
           "refactorize_bounded", "run_bounded", "solve_bounded_two_phase"]


class BoundedState(NamedTuple):
    """Batched state of the bounded-variable engine: ``basis[B, m]`` i32,
    ``inv_B[B, m, m]``, ``bfs[B, m]`` (values of the basic variables),
    ``var_state[B, n]`` i8 (AT_LB / AT_UB / BASIC), ``iters[B]`` i32,
    ``status[B]`` i32."""

    basis: torch.Tensor
    inv_B: torch.Tensor
    bfs: torch.Tensor
    var_state: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor


def nonbasic_values(var_state, lb, ub):
    """x_N: ``lb`` for AT_LB variables, ``ub`` for AT_UB ones, 0 on basic
    positions."""
    return torch.where(var_state == AT_LB, lb,
                       torch.where(var_state == AT_UB, ub,
                                   torch.zeros_like(lb)))


def compute_bfs(A, b, inv_B, var_state, lb, ub):
    """``x_B = inv_B (b - A_N x_N)`` per lane."""
    x_n = nonbasic_values(var_state, lb, ub)
    rhs = b - torch.einsum("bmn,bn->bm", A, x_n)
    return torch.einsum("bmk,bk->bm", inv_B, rhs)


def make_bounded_state(A, b, lb, ub, basis, var_state) -> BoundedState:
    """State from starting bases and variable states (one batched
    inversion); lanes whose basis matrix is singular start as
    ``NUMERICAL_ERROR``."""
    basis = basis.to(torch.int32)
    var_state = var_state.to(torch.int8)
    inv_B = inv_or_nan(basis_matrix(A, basis))
    bfs = compute_bfs(A, b, inv_B, var_state, lb, ub)
    ok = _finite_lanes(inv_B, bfs)
    B = A.shape[0]
    return BoundedState(
        basis=basis,
        inv_B=inv_B,
        bfs=bfs,
        var_state=var_state,
        iters=torch.zeros((B,), dtype=torch.int32, device=A.device),
        status=torch.where(ok, st.RUNNING, st.NUMERICAL_ERROR).to(torch.int32),
    )


def _bounded_pack(c, lb, ub, state: BoundedState) -> BoundedSegmentState:
    """Arrange state in the kernel's layout: the transposed factor and the
    cost and bound rows of the basic variables."""
    idx = state.basis.long()
    return BoundedSegmentState(
        invBT=state.inv_B.transpose(1, 2).contiguous(),
        bfs=state.bfs.contiguous().clone(),
        cB=torch.gather(c, 1, idx).contiguous(),
        basis=state.basis.to(torch.int32).contiguous().clone(),
        vstate=state.var_state.to(torch.int8).contiguous().clone(),
        lbB=torch.gather(lb, 1, idx).contiguous(),
        ubB=torch.gather(ub, 1, idx).contiguous(),
        iters=state.iters.to(torch.int32).contiguous().clone(),
        status=state.status.to(torch.int32).contiguous().clone(),
    )


def run_bounded_batched(c, A, b, lb, ub, state: BoundedState, maxiters: int,
                        cfg: SolverConfig) -> BoundedState:
    """Segment loop on the bounded-variable kernel (counterpart of
    ``run_bounded_batched_pallas``): each outer step runs up to
    ``cfg.refactor_every`` iterations per lane in one launch, then
    refactorizes the still-running lanes exactly against the rhs
    ``b - A x_N`` of their current variable states.  With
    ``refactor_every == 0`` one unbounded segment runs."""
    A, c = A.contiguous(), c.contiguous()
    lb, ub = lb.contiguous(), ub.contiguous()
    seg_len = cfg.refactor_every if cfg.refactor_every > 0 else (1 << 30)
    seg = _bounded_pack(c, lb, ub, state)
    kw = dict(seg_len=seg_len, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              unroll=cfg.unroll, packed=cfg.packed_select)

    if cfg.refactor_every > 0:
        while host_read(bool, ((seg.status == st.RUNNING)
                               & (seg.iters < maxiters)).any()):
            segment_launch(4, "primal", seg, solve_bounded_segment, A, c, lb,
                           ub, maxiters, seg, **kw)
            x_n = nonbasic_values(seg.vstate, lb, ub)
            rhs = b - torch.einsum("bmn,bn->bm", A, x_n)
            refresh_running_lanes(A, rhs, seg,
                                  compact=cfg.compact_refactor)
    else:
        segment_launch(4, "primal", seg, solve_bounded_segment, A, c, lb, ub,
                       maxiters, seg, **kw)

    return BoundedState(
        basis=seg.basis,
        inv_B=seg.invBT.transpose(1, 2),
        bfs=seg.bfs,
        var_state=seg.vstate,
        iters=seg.iters,
        status=seg.status,
    )


def expand_bounded_bfs(state: BoundedState, lb, ub):
    """Full ``x[B, n]``: bound values on nonbasic positions, ``bfs``
    scattered on the basis."""
    x = nonbasic_values(state.var_state, lb, ub)
    return x.scatter(1, state.basis.long(), state.bfs)


# ---------------------------------------------------------------------------
# The per-lane engine, batch dimension explicit
# ---------------------------------------------------------------------------


def bounded_reduced_costs(c, A, state: BoundedState):
    """Bound-aware reduced costs ``[B, n]``: ``z - c`` at a lower bound,
    ``c - z`` at an upper bound (``z = c_B inv_B A``), 0 on basic columns.
    Positive means improving under the Dantzig ``argmax`` either way."""
    zc = torch.einsum("bm,bmn->bn", duals(c, state), A) - c
    rc = torch.where(state.var_state == AT_UB, -zc, zc)
    return torch.where(state.var_state == BASIC, 0.0, rc)


def bounded_step(c, A, b, lb, ub, state: BoundedState, cfg: SolverConfig,
                 allowed=None) -> BoundedState:
    """One bounded-variable iteration on every lane.

    Dantzig entering column on the bound-aware reduced costs with the
    absolute ``opt_tol``; ``allowed`` (optional bool ``[n]`` or ``[B, n]``)
    masks the columns that may enter.  Three-way ratio test: a basic
    variable drops to its lower bound (``g1``), one hits its upper bound
    (``g2``), or the entering variable crosses to its other bound
    (``gamma3``, a bound flip without a basis change when
    ``gamma3 <= min(g1, g2)``).  The basic values move incrementally."""
    rc = bounded_reduced_costs(c, A, state)
    if allowed is not None:
        rc = torch.where(allowed, rc, float("-inf"))
    enter = rc.argmax(dim=1)  # the first maximum, as the reference takes
    not_optimal = rc.max(dim=1).values > cfg.opt_tol

    vs_enter = _lane_pick(state.var_state, enter)
    sigma = torch.where(vs_enter == AT_LB, 1.0, -1.0).to(c.dtype)
    d = torch.einsum("bmk,bk->bm", state.inv_B, _gather_cols(A, enter))
    sd = sigma[:, None] * d

    idx = state.basis.long()
    lb_B, ub_B = torch.gather(lb, 1, idx), torch.gather(ub, 1, idx)
    gammas1 = primal_simplex_div(state.bfs - lb_B, sd, cfg.pivot_tol)
    gammas2 = primal_simplex_div(ub_B - state.bfs, -sd, cfg.pivot_tol)
    g1, g2 = gammas1.min(dim=1).values, gammas2.min(dim=1).values
    lb_e, ub_e = _lane_pick(lb, enter), _lane_pick(ub, enter)
    gamma3 = ub_e - lb_e
    delta = torch.minimum(g1, g2)

    unbounded = not_optimal & torch.isinf(delta) & torch.isinf(gamma3)
    bound_flip = not_optimal & ~unbounded & (gamma3 <= delta)
    do_pivot = not_optimal & ~unbounded & ~bound_flip

    # the bound flip: the entering variable jumps to its other bound
    other = torch.where(vs_enter == AT_LB, AT_UB, AT_LB).to(torch.int8)
    e_col = enter[:, None]
    flipped_vs = state.var_state.scatter(1, e_col, other[:, None])

    # the pivot: the leaving variable lands on the bound it reached
    leave_to_lb = g1 < g2
    leave = torch.where(leave_to_lb, gammas1.argmin(dim=1),
                        gammas2.argmin(dim=1))
    leaving_col = _lane_pick(state.basis, leave).long()
    lands = torch.where(leave_to_lb, AT_LB, AT_UB).to(torch.int8)
    pivot_vs = state.var_state.scatter(1, leaving_col[:, None],
                                       lands[:, None])
    pivot_vs = pivot_vs.scatter(
        1, e_col, torch.full_like(lands[:, None], BASIC))
    d_l = _lane_pick(d, leave)
    safe = torch.where(d_l == 0, 1.0, d_l)
    u = torch.where(do_pivot[:, None], _eta(d, leave, safe), 0.0)
    inv_B, _ = _rank1(state.inv_B, state.bfs, u, leave)
    basis = torch.where(do_pivot[:, None],
                        _set_basis(state.basis, leave, enter), state.basis)

    # incremental basic values: every basic moves by -step * sigma * d; on
    # a pivot the leaving slot then holds the entering variable's value
    step_len = torch.where(bound_flip, gamma3,
                           torch.where(do_pivot, delta, 0.0))
    bfs_moved = state.bfs - step_len[:, None] * sd
    enter_val = torch.where(sigma > 0, lb_e, ub_e) + sigma * delta
    bfs = torch.where(
        do_pivot[:, None],
        bfs_moved.scatter(1, leave[:, None], enter_val[:, None]), bfs_moved)
    var_state = torch.where(
        do_pivot[:, None], pivot_vs,
        torch.where(bound_flip[:, None], flipped_vs, state.var_state))

    status = torch.where(~not_optimal, st.OPTIMAL,
                         torch.where(unbounded, st.PRIMAL_UNBOUNDED,
                                     st.RUNNING))
    return BoundedState(basis=basis, inv_B=inv_B, bfs=bfs,
                        var_state=var_state, iters=state.iters + 1,
                        status=status.to(torch.int32))


def refactorize_bounded(A, b, lb, ub, state: BoundedState) -> BoundedState:
    """Fresh ``inv_B`` and exact ``bfs`` on every lane; a lane whose fresh
    factors are not finite keeps its old ones and becomes
    ``NUMERICAL_ERROR``."""
    inv_B = inv_or_nan(basis_matrix(A, state.basis))
    bfs = compute_bfs(A, b, inv_B, state.var_state, lb, ub)
    ok = _finite_lanes(inv_B, bfs)
    fresh = state._replace(inv_B=inv_B, bfs=bfs)
    guarded = state._replace(
        status=torch.full_like(state.status, st.NUMERICAL_ERROR))
    return tree_select(ok, fresh, guarded)


def run_bounded(c, A, b, lb, ub, state: BoundedState, maxiters,
                cfg: SolverConfig, allowed=None) -> BoundedState:
    """Drive every lane to a terminal status or ``maxiters`` (the
    reference's vmapped ``run_bounded``), refactorizing each lane every
    ``cfg.refactor_every`` of its own iterations when that is positive."""
    return run_lanes(
        lambda s: bounded_step(c, A, b, lb, ub, s, cfg, allowed),
        lambda s: refactorize_bounded(A, b, lb, ub, s), state, maxiters,
        cfg.refactor_every)


def solve_bounded_two_phase(c, A, b, lb, ub, maxiters1, maxiters2,
                            cfg: SolverConfig):
    """Two-phase bounded-variable solve of every lane, no starting basis.

    ``c[B, n], A[B, m, n], b[B, m]`` with ``b >= 0``, ``lb[B, n]`` (0
    expected: finite lower bounds shift into the rhs) and ``ub[B, n]``
    (``inf`` where there is none), handled natively.  Phase I appends ``m``
    artificial columns and starts from the slack crash (a unit column with
    no upper bound serves its row); Phase II pins the artificials to
    ``ub = 0`` and locks them out of pricing.  Returns
    ``(x[B, n], basis, iters_total, status, y)``: ``y = c_B inv_B`` at the
    terminal basis, the Phase-I duals (a Farkas certificate) on infeasible
    lanes."""
    B, m, n = A.shape
    dt, dev = A.dtype, A.device
    A1 = torch.cat([A, torch.eye(m, dtype=dt, device=dev).expand(B, m, m)],
                   dim=2)
    c1 = torch.cat([torch.zeros(n, dtype=dt, device=dev),
                    torch.ones(m, dtype=dt, device=dev)]).expand(B, n + m)
    lb1 = torch.cat([lb, torch.zeros((B, m), dtype=dt, device=dev)], dim=1)
    ub1 = torch.cat([ub, torch.full((B, m), float("inf"), dtype=dt,
                                    device=dev)], dim=1)

    absv = torch.abs(A)
    other_mass = absv.sum(dim=1)[:, None, :] - absv
    unit = (A > 0) & (other_mass == 0.0) & torch.isinf(ub)[:, None, :]
    has_unit = unit.any(dim=2)
    unit_col = unit.to(torch.int8).argmax(dim=2)
    art = torch.arange(n, n + m, device=dev).expand(B, m)
    basis0 = torch.where(has_unit, unit_col, art).to(torch.int32)
    piv = torch.gather(A, 2, unit_col[:, :, None])[:, :, 0]
    inv_diag = 1.0 / torch.where(has_unit, piv, torch.ones_like(b))
    var_state = torch.full((B, n + m), AT_LB, dtype=torch.int8, device=dev)
    var_state.scatter_(1, basis0.long(), BASIC)
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    state = BoundedState(basis=basis0, inv_B=torch.diag_embed(inv_diag),
                         bfs=b * inv_diag, var_state=var_state,
                         iters=zeros, status=zeros)
    state = run_bounded(c1, A1, b, lb1, ub1, state, maxiters1, cfg)

    art_cost = torch.where(state.basis >= n, state.bfs, 0.0).sum(dim=1)
    scale = torch.clamp_min(torch.abs(b).max(dim=1).values, 1.0) * m
    infeasible = ((state.status == st.OPTIMAL)
                  & (art_cost > cfg.feas_tol * scale))
    p1_stalled = state.status == st.RUNNING
    phase1_iters = state.iters
    y_farkas = duals(c1, state)

    # Phase II: artificials pinned to 0 and locked out of pricing
    c2 = torch.cat([c, torch.zeros((B, m), dtype=dt, device=dev)], dim=1)
    ub2 = ub1.clone()
    ub2[:, n:] = 0.0
    allowed2 = torch.arange(n + m, device=dev) < n
    status = torch.where(infeasible, st.PRIMAL_INFEASIBLE,
                         torch.where(p1_stalled, st.ITER_LIMIT, st.RUNNING))
    state = state._replace(status=status.to(torch.int32),
                           iters=torch.zeros_like(state.iters))
    state = run_bounded(c2, A1, b, lb1, ub2, state, maxiters2, cfg,
                        allowed=allowed2)

    # exact terminal basic values
    inv_fresh = inv_or_nan(basis_matrix(A1, state.basis))
    bfs_fresh = compute_bfs(A1, b, inv_fresh, state.var_state, lb1, ub2)
    ok = _finite_lanes(inv_fresh, bfs_fresh)
    state = tree_select(
        ok, state._replace(inv_B=inv_fresh, bfs=bfs_fresh),
        state._replace(status=torch.full_like(state.status,
                                              st.NUMERICAL_ERROR)))

    x_full = expand_bounded_bfs(state, lb1, ub2)
    y = torch.where(infeasible[:, None], y_farkas, duals(c2, state))
    status = torch.where(state.status == st.RUNNING, st.ITER_LIMIT,
                         state.status).to(torch.int32)
    return x_full[:, :n], state.basis, phase1_iters + state.iters, status, y
