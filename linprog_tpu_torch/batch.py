"""Batched two-phase simplex (counterpart of the two-phase half of
:mod:`linprog_tpu.batch`).

Phase I keeps the artificial columns in the matrix for Phase II and masks
them out of pricing; redundant rows keep their artificial basic at zero
level.  Both phases run on the segment kernel through
:func:`linprog_tpu_torch.engine_batched.run_batched`.
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
