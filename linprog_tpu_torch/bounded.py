"""Bounded-variable primal simplex, batched: ``min c'x  s.t. Ax = b,
lb <= x <= ub`` (counterpart of the batched half of
:mod:`linprog_tpu.bounded`).

Every variable carries a state in ``var_state[B, n]`` (``AT_LB`` / ``AT_UB``
/ ``BASIC``); the iteration itself (bound-aware pricing, three-way ratio
test, bound flips) lives in the whole-segment kernel
:func:`linprog_tpu_torch.ops.bounded_kernel.solve_bounded_segment`, and
:func:`run_bounded_batched` drives it in segments with exact
refactorizations in between.  The reference's per-lane engine
(``bounded_step``, ``run_bounded``, ``solve_bounded_two_phase``) belongs to
the general-form surface and is not part of the port yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import status as st
from .config import SolverConfig
from .engine import basis_matrix, inv_or_nan
from .engine_batched import _finite_lanes, refresh_running_lanes
from .ops.bounded_kernel import (
    AT_LB,
    AT_UB,
    BASIC,
    BoundedSegmentState,
    solve_bounded_segment,
)

__all__ = ["AT_LB", "AT_UB", "BASIC", "BoundedState", "nonbasic_values",
           "compute_bfs", "make_bounded_state", "run_bounded_batched",
           "expand_bounded_bfs"]


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
        while bool(((seg.status == st.RUNNING) & (seg.iters < maxiters)).any()):
            solve_bounded_segment(A, c, lb, ub, maxiters, seg, **kw)
            x_n = nonbasic_values(seg.vstate, lb, ub)
            rhs = b - torch.einsum("bmn,bn->bm", A, x_n)
            refresh_running_lanes(A, rhs, seg)
    else:
        solve_bounded_segment(A, c, lb, ub, maxiters, seg, **kw)

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
