"""Interior point -> simplex crossover (counterpart of
:mod:`linprog_tpu.crossover`).

Guess the optimal basis as the ``m`` largest entries of an indicator over
``[x; s]``, factorize it, and clean up with batched dual-then-primal
simplex phases on the segment kernel.  Lanes whose guess is singular, or
that exhaust the pivot budget, report ``crossed == False``; the caller
decides on a fallback.
"""

from __future__ import annotations

import torch

from . import engine
from . import status as st
from .batch import _run_chunked, _to_result
from .config import DEFAULT_CONFIG, SolverConfig
from .engine import basis_matrix, inv_or_nan
from .observability import by_status, current, host_read, span, spanned
from .ops.solve_kernel import _nonneg
from .refine import solve_dd
from .results import BatchResult


def _finite_rows(*ts):
    ok = None
    for t in ts:
        f = torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)
        ok = f if ok is None else ok & f
    return ok


@spanned("crossover")
def crossover_batch_canonical(c, G, h, x, maxiters: int = 512,
                              cfg: SolverConfig = DEFAULT_CONFIG,
                              indicator=None, repair_rounds: int = 2):
    """Snap approximate points ``x[B, n]`` of ``min c'x, Gx <= h, x >= 0``
    to verified optimal vertices.

    Returns ``(BatchResult, crossed[B])``; ``basis`` indexes ``[G | I]``.
    ``indicator[B, n + m]`` (optional) replaces the ``[x; h - Gx]``
    magnitudes as the basis-guess ranking.  Each repair round runs a dual
    phase (repairs primal infeasibility), an exact refactorization, a primal
    phase, and an exact terminal solve that verifies primal feasibility;
    later rounds take only the lanes the previous round reopened.
    """
    B, m, n = G.shape
    dt, dev = G.dtype, G.device
    if cfg.refactor_every == 0:
        cfg = cfg.replace(refactor_every=128)  # bound eta drift on bad guesses
    eye = torch.eye(m, dtype=dt, device=dev).expand(B, m, m)
    As = torch.cat([G, eye], dim=2)  # [B, m, n+m]
    cs = torch.cat([c, torch.zeros((B, m), dtype=dt, device=dev)], dim=1)

    s = h - torch.einsum("bmn,bn->bm", G, x)
    xs = torch.cat([torch.clamp_min(x, 0.0), torch.clamp_min(s, 0.0)], dim=1)
    if indicator is not None:
        xs = indicator

    # ---- basis guess: the m largest components ---------------------------
    with span("xover.guess"):
        idx = torch.topk(xs, m, dim=1).indices
        basis = torch.sort(idx, dim=1).values.to(torch.int32)

        inv_B = inv_or_nan(basis_matrix(As, basis))
        bfs0 = torch.einsum("bij,bj->bi", inv_B, h)
        finite = _finite_rows(inv_B, bfs0)
        scale = torch.clamp_min(torch.abs(h).max(dim=1).values, 1.0)
        feasible = finite & (bfs0 >= -cfg.feas_tol * scale[:, None]).all(
            dim=1)
    allowed = torch.ones((n + m,), dtype=torch.bool, device=dev)

    states = engine.SimplexState(
        basis=basis,
        inv_B=inv_B,
        bfs=bfs0,
        iters=torch.zeros((B,), dtype=torch.int32, device=dev),
        status=torch.where(
            finite, torch.where(feasible, st.OPTIMAL, st.RUNNING),
            st.BASIS_PRIMAL_INFEASIBLE,
        ).to(torch.int32),
    )

    verified = torch.zeros((B,), dtype=torch.bool, device=dev)
    participate = finite
    rounds = max(1, repair_rounds)
    busy_rounds = 0
    for rnd in range(rounds):
        states = _run_chunked(cs, As, h, states, allowed, maxiters, cfg,
                              "dual")
        # primal-feasible lanes continue from an exact refactorization;
        # DUAL_UNBOUNDED means the guess has no primal-feasible completion
        to_primal = (states.status == st.OPTIMAL) & participate
        any_p = host_read(bool, participate.any())
        busy_rounds += any_p
        with span("xover.refactor"):
            if any_p:
                inv_fresh = inv_or_nan(basis_matrix(As, states.basis))
                bfs_fresh = torch.einsum("bij,bj->bi", inv_fresh, h)
            else:
                inv_fresh = torch.zeros_like(states.inv_B)
                bfs_fresh = torch.zeros_like(states.bfs)
            fresh_ok = _finite_rows(inv_fresh, bfs_fresh)
        status = torch.where(
            participate,
            torch.where(
                to_primal,
                torch.where(fresh_ok, st.RUNNING, st.NUMERICAL_ERROR),
                torch.where(
                    states.status == st.DUAL_UNBOUNDED,
                    st.BASIS_PRIMAL_INFEASIBLE,
                    torch.where(states.status == st.RUNNING, st.ITER_LIMIT,
                                states.status),
                ),
            ),
            states.status,
        ).to(torch.int32)
        take = to_primal & fresh_ok
        states = states._replace(
            inv_B=torch.where(take[:, None, None], inv_fresh, states.inv_B),
            bfs=torch.where(take[:, None], torch.clamp_min(bfs_fresh, 0.0),
                            states.bfs),
            status=status,
        )

        states = _run_chunked(cs, As, h, states, allowed, maxiters, cfg,
                              "primal")

        # terminal solve plus primal-feasibility verification, dd-refined
        # past the whole-segment regime: there a plain f32 solve (~1e-4
        # relative error at m = 2048) passes bases whose basic values the
        # certificate finds negative
        with span("xover.verify"):
            if any_p:
                bfs_exact = solve_dd(basis_matrix(As, states.basis), h)
            else:
                bfs_exact = torch.zeros_like(states.bfs)
            ok = torch.isfinite(bfs_exact).all(dim=1)
            verified_new = ok & (bfs_exact >= -cfg.feas_tol
                                 * scale[:, None]).all(dim=1)
            verified = torch.where(participate, verified_new, verified)
        states = states._replace(
            bfs=torch.where((participate & ok)[:, None], bfs_exact,
                            states.bfs),
            status=torch.where(participate & ~ok, st.NUMERICAL_ERROR,
                               states.status).to(torch.int32),
        )
        reopen = torch.zeros((B,), dtype=torch.bool, device=dev)
        if rnd + 1 < rounds:
            # OPTIMAL-but-unverified lanes go round again from the exact bfs
            reopen = ((states.status == st.OPTIMAL) & ~verified & ok
                      & participate)
            states = states._replace(
                status=torch.where(reopen, st.RUNNING,
                                   states.status).to(torch.int32),
            )
        participate = reopen

    if cfg.polish_pivots > 0:
        from .refine import polish_batch

        act = (states.status == st.OPTIMAL) & verified
        pbasis, pxB, _, pinv, _ = polish_batch(
            cs, As, h, states.basis, allowed, act,
            max_pivots=cfg.polish_pivots, pivot_tol=cfg.pivot_tol,
            inv_B=states.inv_B,
        )
        states = states._replace(
            basis=torch.where(act[:, None], pbasis, states.basis),
            bfs=torch.where(act[:, None], pxB, states.bfs),
            inv_B=torch.where(act[:, None, None], pinv, states.inv_B),
        )

    res = _to_result(cs, states, n + m)
    crossed = (res.status == st.OPTIMAL) & verified
    sp = current()
    if sp:
        sp.set(rounds=busy_rounds, uncrossed=by_status(res.status, ~crossed))
    if cfg.polish_pivots > 0:
        from .refine import dd_dot

        cost = dd_dot(c, res.x[:, :n])
    else:
        cost = (c * res.x[:, :n]).sum(dim=1)
    return (
        BatchResult(x=res.x[:, :n], basis=res.basis, cost=cost,
                    iters=res.iters, status=res.status, y=res.y),
        crossed,
    )


def ipm_crossover_batch_canonical(c, G, h, ipm_cfg=None,
                                  crossover_maxiters: int = 512,
                                  cfg: SolverConfig = DEFAULT_CONFIG,
                                  guess: str = "tapia"):
    """Batched IPM, then crossover at the interior point.

    ``guess``: ``"tapia"`` ranks the basis guess by ``x / s`` (primal over
    dual slack), ``"magnitude"`` by ``[x; h - Gx]``, ``"slack"`` by
    ``[max(x, 0); max(h - Gx, 0) + 1e-3 max(1, max|h|)]`` (magnitude with
    the slack columns winning near ties; the reference measured it far
    worse and keeps it as an experiment).  Where the crossover verifies an
    optimal basis its vertex replaces the interior answer.  Returns
    ``(BatchResult, crossed)``.
    """
    from .ipm import DEFAULT_IPM_CONFIG, ipm_canonical_state

    if guess not in ("tapia", "magnitude", "slack"):
        raise ValueError(f"unknown basis guess {guess!r}")
    ipm_cfg = ipm_cfg or DEFAULT_IPM_CONFIG
    B, m, n = G.shape
    dt = G.dtype
    cs = torch.cat([c, torch.zeros((B, m), dtype=dt, device=G.device)], dim=1)
    state = ipm_canonical_state(cs, G, h, ipm_cfg)
    x = state.x[:, :n].to(dt)
    x = torch.where(_finite_rows(x)[:, None], x, 0.0)
    ind = None
    if guess == "tapia":
        ind = state.x / torch.clamp_min(state.s, 1e-30)
        ind = torch.where(_finite_rows(ind)[:, None], ind, 0.0).to(dt)
    elif guess == "slack":
        s_pr = _nonneg(h - torch.einsum("bmn,bn->bm", G, x))
        scale = torch.clamp_min(torch.abs(h).amax(dim=1), 1.0)[:, None]
        ind = torch.cat([_nonneg(x), s_pr + 1e-3 * scale], dim=1)
    res, crossed = crossover_batch_canonical(
        c, G, h, x, maxiters=crossover_maxiters, cfg=cfg, indicator=ind,
    )
    ipm_cost = (cs * state.x).sum(dim=1).to(dt)
    merged = BatchResult(
        x=torch.where(crossed[:, None], res.x, x),
        basis=res.basis,  # meaningful only where crossed
        cost=torch.where(crossed, res.cost, ipm_cost),
        iters=state.iters + res.iters,
        status=torch.where(crossed, res.status, state.status).to(torch.int32),
        y=res.y,
    )
    return merged, crossed


def pdhg_crossover_batch_canonical(c, G, h, pdhg_maxiters: int = 20_000,
                                   crossover_maxiters: int = 512,
                                   cfg: SolverConfig = DEFAULT_CONFIG,
                                   pdhg_cfg=None):
    """Batched PDHG, then crossover at the first-order points.

    Runs :func:`linprog_tpu_torch.pdhg.pdhg_solve_batch_canonical`
    (Ruiz-equilibrated, fixed-cadence restarts unless ``pdhg_cfg`` says
    otherwise: the lanes run in lockstep, and the crossover needs only an
    approximate support), then :func:`crossover_batch_canonical` at every
    lane with a finite iterate, ITER_LIMIT lanes included.  Where the
    crossover verifies an optimal basis its vertex replaces the PDHG
    answer.  Returns ``(BatchResult, crossed)``.
    """
    from .pdhg import PDHGConfig, pdhg_solve_batch_canonical

    pdhg_cfg = pdhg_cfg or PDHGConfig(adaptive=False)
    x, cost, status, iters = pdhg_solve_batch_canonical(
        c, G, h, maxiters=pdhg_maxiters, cfg=pdhg_cfg)
    x = torch.where(_finite_rows(x)[:, None], x, 0.0)
    res, crossed = crossover_batch_canonical(
        c, G, h, x, maxiters=crossover_maxiters, cfg=cfg)
    merged = BatchResult(
        x=torch.where(crossed[:, None], res.x, x),
        basis=res.basis,  # meaningful only where crossed
        cost=torch.where(crossed, res.cost, cost),
        iters=iters + res.iters,
        status=torch.where(crossed, res.status, status).to(torch.int32),
        y=res.y,
    )
    return merged, crossed
