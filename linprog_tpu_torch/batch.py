"""Batched two-phase and bounded-variable simplex (counterpart of those
halves of :mod:`linprog_tpu.batch`).

Two-phase: Phase I keeps the artificial columns in the matrix for Phase II
and masks them out of pricing; redundant rows keep their artificial basic
at zero level.  Both phases run on the segment kernel through
:func:`linprog_tpu_torch.engine_batched.run_batched`.  Bounded variables:
:func:`solve_batch_bounded` runs the bounded-variable kernel from a given
basis and bound assignment.
"""

from __future__ import annotations

import torch

from . import engine
from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .engine import basis_matrix, solve_or_nan
from .results import BatchResult


def _run_chunked(c, A, b, states, allowed, maxiters: int, cfg: SolverConfig,
                 mode: str):
    """Drive the batch to termination (primal or dual mode)."""
    from .engine_batched import run_batched

    return run_batched(c, A, b, states, allowed, maxiters, cfg, mode)


def solve_batch_two_phase(c, A, b, maxiters1: int = 1000,
                          maxiters2: int = 1000,
                          cfg: SolverConfig = DEFAULT_CONFIG) -> BatchResult:
    """Two-phase solve of standard-form LPs ``c[B, n], A[B, m, n], b[B, m]``
    with ``b >= 0`` (see :func:`linprog_tpu_torch.generators
    .device_standard_form_batch`)."""
    B, m, n = A.shape
    dt, dev = A.dtype, A.device

    eye = torch.eye(m, dtype=dt, device=dev).expand(B, m, m)
    A1 = torch.cat([A, eye], dim=2)  # [B, m, n+m]
    c1 = torch.cat([torch.zeros(n, dtype=dt, device=dev),
                    torch.ones(m, dtype=dt, device=dev)]).expand(B, n + m)
    c1 = c1.contiguous()
    c2 = torch.cat([c, torch.zeros((B, m), dtype=dt, device=dev)], dim=1)

    # ---- Phase I: slack crash basis, everything allowed to enter ---------
    states = engine.slack_crash_state(A1, b, n)
    allowed1 = torch.ones((n + m,), dtype=torch.bool, device=dev)
    states = _run_chunked(c1, A1, b, states, allowed1, maxiters1, cfg,
                          "primal")

    art_cost = torch.where(states.basis >= n, states.bfs, 0.0).sum(dim=1)
    scale = torch.clamp_min(torch.abs(b).max(dim=1).values, 1.0) * m
    infeasible = (states.status == st.OPTIMAL) & (art_cost > cfg.feas_tol * scale)
    p1_stalled = states.status == st.RUNNING  # phase-I iteration cap
    phase1_iters = states.iters
    # Phase-I duals at an infeasible optimum are a Farkas certificate
    y_farkas = engine.duals(c1, states)

    # ---- Phase II: structural columns only; artificials stay masked ------
    new_status = torch.where(
        infeasible, st.PRIMAL_INFEASIBLE,
        torch.where(p1_stalled, st.ITER_LIMIT, st.RUNNING),
    ).to(torch.int32)
    states = states._replace(status=new_status,
                             iters=torch.zeros_like(states.iters))
    allowed2 = torch.arange(n + m, device=dev) < n
    states = _run_chunked(c2, A1, b, states, allowed2, maxiters2, cfg,
                          "primal")

    # exact terminal solve at the final basis
    bfs_exact = solve_or_nan(basis_matrix(A1, states.basis), b)
    ok = torch.isfinite(bfs_exact).all(dim=1)
    states = states._replace(
        bfs=torch.where(ok[:, None], bfs_exact, states.bfs),
        status=torch.where(ok, states.status,
                           st.NUMERICAL_ERROR).to(torch.int32),
    )

    if cfg.polish_pivots > 0:
        from .refine import dd_dot, dd_residual, polish_batch

        act = states.status == st.OPTIMAL
        pbasis, pxB, _, pinv, _ = polish_batch(
            c2, A1, b, states.basis, allowed2, act,
            max_pivots=cfg.polish_pivots, pivot_tol=cfg.pivot_tol,
            inv_B=states.inv_B,
        )
        states = states._replace(
            basis=torch.where(act[:, None], pbasis, states.basis),
            bfs=torch.where(act[:, None], pxB, states.bfs),
            inv_B=torch.where(act[:, None, None], pinv, states.inv_B),
        )
        # exact + dd-refined solve at the polished basis, and the duality
        # objective correction  cost += y'(b - B x_B)
        B_pol = basis_matrix(A1, states.basis)
        xB = solve_or_nan(B_pol, b)
        r_dd = dd_residual(b, B_pol, xB)
        xB = xB + solve_or_nan(B_pol, r_dd)
        good = act & torch.isfinite(xB).all(dim=1)
        states = states._replace(
            bfs=torch.where(good[:, None], xB, states.bfs)
        )
        cB_pol = torch.gather(c2, 1, states.basis.long())
        y_pol = solve_or_nan(B_pol.transpose(1, 2), cB_pol)
        r2 = dd_residual(b, B_pol, states.bfs)
        obj_corr = torch.where(good, dd_dot(y_pol, r2), 0.0)
        obj_corr = torch.where(torch.isfinite(obj_corr), obj_corr, 0.0)
    else:
        obj_corr = None

    res = _to_result(c2, states, n + m)
    x = res.x[:, :n]
    y = torch.where(infeasible[:, None], y_farkas, res.y)
    if obj_corr is not None:
        cost = dd_dot(c, x) + obj_corr
    else:
        cost = (c * x).sum(dim=1)
    return BatchResult(
        x=x,
        basis=res.basis,
        cost=cost,
        iters=phase1_iters + res.iters,
        status=res.status,
        y=y,
    )


def solve_batch_bounded(c, A, b, lb, ub, basis, var_state, maxiters: int,
                        cfg: SolverConfig = DEFAULT_CONFIG) -> BatchResult:
    """Batched bounded-variable simplex: ``min c'x, Ax = b, lb <= x <= ub``.

    ``c[B, n], A[B, m, n], b[B, m], lb[B, n], ub[B, n], basis[B, m]``,
    ``var_state[B, n]`` (int8 in {AT_LB = 0, AT_UB = 1, BASIC = 2}): a
    starting basis with a bound assignment whose basic solution is within
    its bounds.  A variable at an infinite upper bound counts as zero.
    """
    from . import bounded as bnd
    from .engine_batched import _mega_kernel_fits
    from .refine import (
        dd_dot,
        dd_residual,
        polish_bounded_batch,
        refine_bfs,
    )

    B, m, n = A.shape
    if cfg.kernels != "cuda" or not _mega_kernel_fits(m, n, with_at=False):
        raise NotImplementedError(
            f"solve_batch_bounded at m={m}, n={n} with kernels="
            f"{cfg.kernels!r}: the reference leaves its bounded kernel there "
            "for the vmapped per-lane bounded engine (bounded.run_bounded), "
            "which is not ported (ROADMAP Queue 1 item 9)"
        )
    states = bnd.make_bounded_state(A, b, lb, ub, basis, var_state)
    out = bnd.run_bounded_batched(c, A, b, lb, ub, states, maxiters, cfg)
    basis_out, var_out = out.basis, out.var_state
    status = torch.where(out.status == st.RUNNING, st.ITER_LIMIT, out.status)

    # terminal accuracy pass: re-solve B x_B = b - A x_N exactly at the
    # terminal basis, with the rhs itself computed double-word
    def rhs_of(vs):
        x_n = torch.where(
            vs == bnd.AT_LB, lb,
            torch.where((vs == bnd.AT_UB) & torch.isfinite(ub), ub,
                        torch.zeros_like(lb)))
        return x_n, dd_residual(b, A, x_n)

    Bmat = basis_matrix(A, basis_out)
    _, rhs = rhs_of(var_out)
    inv_B = engine.inv_or_nan(Bmat)
    xB = torch.einsum("bmk,bk->bm", inv_B, rhs)
    ok = (torch.isfinite(inv_B).all(dim=2).all(dim=1)
          & torch.isfinite(xB).all(dim=1))
    xB = torch.where(ok[:, None], refine_bfs(Bmat, rhs, inv_B, xB), out.bfs)
    status = torch.where(ok, status, st.NUMERICAL_ERROR).to(torch.int32)

    obj_corr = None
    if cfg.polish_pivots > 0:
        # bound-aware dd polish, then the duality objective correction
        # y'(rhs - B x_B)
        act = (status == st.OPTIMAL) & ok
        pbasis, pvs, pxB, py, _ = polish_bounded_batch(
            c, A, b, lb, ub, basis_out, var_out, act,
            max_pivots=cfg.polish_pivots, pivot_tol=cfg.pivot_tol,
            inv_B=inv_B,
        )
        basis_out = torch.where(act[:, None], pbasis, basis_out)
        var_out = torch.where(act[:, None], pvs, var_out)
        xB = torch.where(act[:, None], pxB, xB)
        Bmat = basis_matrix(A, basis_out)
        _, rhs = rhs_of(var_out)
        corr = dd_dot(py, dd_residual(rhs, Bmat, xB))
        obj_corr = torch.where(act & torch.isfinite(corr), corr, 0.0)

    x_n, _ = rhs_of(var_out)
    x = x_n.scatter(1, basis_out.long(), xB)
    if obj_corr is not None:
        cost = dd_dot(c, x) + obj_corr
    else:
        cost = (c * x).sum(dim=1)
    return BatchResult(x=x, basis=basis_out, cost=cost, iters=out.iters,
                       status=status)


def _to_result(c, states: engine.SimplexState, n: int) -> BatchResult:
    x = engine.expand_bfs(states, n)
    status = torch.where(states.status == st.RUNNING, st.ITER_LIMIT,
                         states.status).to(torch.int32)
    return BatchResult(
        x=x,
        basis=states.basis,
        cost=(c * x).sum(dim=1),
        iters=states.iters,
        status=status,
        y=engine.duals(c, states),
    )
