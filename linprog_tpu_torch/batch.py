"""Batched simplex entry points (counterpart of :mod:`linprog_tpu.batch`).

Two-phase: Phase I keeps the artificial columns in the matrix for Phase II
and masks them out of pricing; redundant rows keep their artificial basic
at zero level.  Both phases run on the segment kernel through
:func:`linprog_tpu_torch.engine_batched.run_batched`.  Warm starts:
:func:`solve_batch_from_basis` runs one phase from given bases and
:func:`reoptimize_batch_new_rhs` re-solves after the right-hand side
changed (dual phase, then primal).  Certificates: infeasible lanes carry a
Farkas vector in ``y``, unbounded lanes get their improving ray from
:func:`unbounded_rays`.  Bounded variables: :func:`solve_batch_bounded`
runs the bounded-variable kernel (or, with ``kernels="torch"``, the
per-lane bounded engine) from a given basis and bound assignment.
Heterogeneous general-form instances: :func:`solve_batch_general`
canonicalizes host arrays, pads them to one shape and runs the two-phase
solve on the device.
"""

from __future__ import annotations

import torch

from . import engine
from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .engine import basis_matrix, noting_lu, solve_or_nan
from .observability import host_read, spanned
from .results import BatchResult


def _run_chunked(c, A, b, states, allowed, maxiters: int, cfg: SolverConfig,
                 mode: str):
    """Drive the batch to termination (primal or dual mode)."""
    from .engine_batched import run_batched

    return run_batched(c, A, b, states, allowed, maxiters, cfg, mode)


def solve_batch_from_basis(c, A, b, basis, maxiters: int,
                           cfg: SolverConfig = DEFAULT_CONFIG,
                           mode: str = "primal") -> BatchResult:
    """Solve standard-form LPs ``c[B, n], A[B, m, n], b[B, m]`` from the
    starting bases ``basis[B, m]`` in one phase (``mode`` primal or dual)."""
    n = c.shape[-1]
    states = engine.make_state(A, b, basis)
    allowed = torch.ones((n,), dtype=torch.bool, device=A.device)
    states = _run_chunked(c, A, b, states, allowed, maxiters, cfg, mode)
    return _to_result(c, states, n)


# dual rounds the repair gives a lane: past a few hundred rows the kernel's
# f32 eta updates can call a basis feasible that float64 does not
# (ineq_m2048.exact: x_B -4.3e-4 relative after one round, repaired by the
# second), so such a lane goes round once more from its float64 x_B
REPAIR_ROUNDS = 2


def _repair_infeasible(c, A, b, states, allowed, maxiters: int,
                       cfg: SolverConfig):
    """Dual simplex from exact factors for the OPTIMAL lanes whose basis
    is primal infeasible: ``x_B`` below ``-feas_tol max(1, max|b|)`` in the
    terminal f32 solve, confirmed by a float64 solve (past a few hundred
    rows an f32 solve can put a feasible vertex below the tolerance).

    A long unrefactored segment's f32 factors can end a lane at a basis
    they call feasible and an exact solve does not
    (``tests/data/two_phase_lane973.npz``: ``x_B`` -3.08e-4 exactly).  The
    reference's path is exposed alike: its f32 rounding differs from the
    port's, so the two part at some near-tie, and chance decides which one
    reaches such a basis.  Such a basis is still dual feasible, so dual
    pivots from a fresh factor and the solved ``x_B`` restore primal
    feasibility.  A lane whose dual phase ends OPTIMAL at a basis that
    float64 still finds infeasible goes round again from that basis and
    its float64 ``x_B``, up to ``REPAIR_ROUNDS`` rounds in all.  A lane
    takes the repaired basis only where a round ends OPTIMAL at a basis
    that float64 finds feasible; every other lane is left as it was."""
    tol = cfg.feas_tol * torch.clamp_min(torch.abs(b).amax(dim=1), 1.0)
    bad = ((states.status == st.OPTIMAL)
           & (states.bfs.min(dim=1).values < -tol))
    if not host_read(bool, bad.any()):
        return states
    idx = host_read(torch.nonzero, bad, as_tuple=True)[0]

    def x64(Ai, bi, basis):
        return solve_or_nan(basis_matrix(Ai, basis).double(), bi.double())

    xb = x64(A[idx], b[idx], states.basis[idx])
    idx = host_read(torch.masked_select, idx,
                    xb.min(dim=1).values < -tol[idx])
    if not idx.numel():
        return states
    basis, inv_B, bfs, iters = (t.clone() for t in (
        states.basis, states.inv_B, states.bfs, states.iters))
    # the first round from the terminal solve's x_B (not from the f32
    # inverse, whose product with b can put the lane above zero again)
    lane_basis, start = states.basis[idx], states.bfs[idx]
    spent = torch.zeros_like(states.iters[idx])
    for rnd in range(REPAIR_ROUNDS):
        Ai, bi = A[idx], b[idx]
        sub = engine.make_state(Ai, bi, lane_basis)._replace(bfs=start)
        sub = _run_chunked(c[idx], Ai, bi, sub, allowed, maxiters, cfg,
                           "dual")
        spent = spent + sub.iters
        xb = x64(Ai, bi, sub.basis)
        good = (sub.status == st.OPTIMAL) & torch.isfinite(xb).all(dim=1)
        feasible = xb.min(dim=1).values >= -tol[idx]
        again = (good & ~feasible if rnd + 1 < REPAIR_ROUNDS
                 else torch.zeros_like(good))
        # 1 repaired, 2 another round, 0 left as it was: the lanes sorted
        # by code (in index order within one) and one read of how many of
        # each, so the indices stay on the device
        code = (good & feasible).to(torch.int8) + 2 * again.to(torch.int8)
        order = torch.sort(code, stable=True).indices
        n1, n2 = host_read(torch.Tensor.tolist, torch.stack(
            [(code == 1).sum(), (code == 2).sum()]))
        n0 = code.numel() - n1 - n2
        keep, again = order[n0:n0 + n1], order[n0 + n1:]
        lanes = idx[keep]
        basis[lanes] = sub.basis[keep]
        inv_B[lanes] = sub.inv_B[keep]
        bfs[lanes] = xb[keep].to(bfs.dtype)
        iters[lanes] = iters[lanes] + spent[keep]
        if not again.numel():
            break
        idx, lane_basis = idx[again], sub.basis[again]
        start, spent = xb[again].to(bfs.dtype), spent[again]
    return states._replace(basis=basis, inv_B=inv_B, bfs=bfs, iters=iters)


@spanned("solve_batch_two_phase")
@noting_lu
def solve_batch_two_phase(c, A, b, maxiters1: int = 1000,
                          maxiters2: int = 1000,
                          cfg: SolverConfig = DEFAULT_CONFIG) -> BatchResult:
    """Two-phase solve of standard-form LPs ``c[B, n], A[B, m, n], b[B, m]``
    with ``b >= 0`` (see :func:`linprog_tpu_torch.generators
    .device_standard_form_batch`)."""
    B, m, n = A.shape
    dt, dev = A.dtype, A.device

    c_orig = c
    if cfg.scaling:
        from .presolve import ruiz_equilibrate

        c, A, b, scaling = ruiz_equilibrate(c, A, b)

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
    states = _repair_infeasible(c2, A1, b, states, allowed2, maxiters2, cfg)

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

    # x and cost in the structural space and the original scaling
    res = _to_result(c2, states, n + m)
    x = res.x[:, :n]
    y = torch.where(infeasible[:, None], y_farkas, res.y)
    if cfg.scaling:
        from .presolve import unscale_duals, unscale_solution

        x = unscale_solution(x, scaling)
        y = unscale_duals(y, scaling)
    if obj_corr is not None:
        # the objective is invariant under the scaling, so the duality
        # correction from the scaled system applies as it is
        cost = dd_dot(c_orig, x) + obj_corr
    else:
        cost = (c_orig * x).sum(dim=1)
    return BatchResult(
        x=x,
        basis=res.basis,
        cost=cost,
        iters=phase1_iters + res.iters,
        status=res.status,
        y=y,
    )


def _bound_rows(red):
    """The finite upper bounds and positive lower bounds a host presolve
    left on its reduced problem, as inequality rows ``(G, h)`` (appended
    to the reduced problem's own)."""
    import numpy as np

    nr = red.c.shape[0]
    ub_idx = np.flatnonzero(np.isfinite(red.ub))
    lb_idx = np.flatnonzero(red.lb > 0)
    rows = np.zeros((ub_idx.size + lb_idx.size, nr))
    rows[np.arange(ub_idx.size), ub_idx] = 1.0
    rows[ub_idx.size + np.arange(lb_idx.size), lb_idx] = -1.0
    rhs = np.concatenate([red.ub[ub_idx], -red.lb[lb_idx]])
    if not rows.shape[0]:
        return red.G, red.h
    if red.G is None:
        return rows, rhs
    return (np.concatenate([red.G, rows]), np.concatenate([red.h, rhs]))


def solve_batch_general(problems, maxiters1: int = 1000,
                        maxiters2: int = 1000,
                        cfg: SolverConfig = DEFAULT_CONFIG,
                        presolve: bool = False, device="cuda"):
    """Solve a heterogeneous batch of general-form LPs in one device batch.

    ``problems`` is a sequence of dicts with key ``c`` and any of
    ``A, b, G, h`` (host arrays, the inputs of
    :class:`~linprog_tpu_torch.api.SimplexSolver` without bounds).  Each
    instance is canonicalized on the host in ``cfg.dtype``, padded in f32
    to the common shape (:func:`linprog_tpu_torch.forms.pad_problem`:
    ``m_pad`` the most rows, ``n_pad`` the most columns plus ``m_pad``) and
    the batch
    runs :func:`solve_batch_two_phase` on ``device`` (a card by default:
    kernel 1 or 3, by ``run_batched``'s rules; ``device="cpu"`` runs on the
    host).  Returns one :class:`~linprog_tpu_torch.results.LinProgResult`
    per instance, ``x`` in its own variable space.

    ``presolve=True`` runs the host presolve
    (:func:`linprog_tpu_torch.presolve_host.presolve_problem`) on each
    instance first: the instances it decides (infeasible, unbounded,
    completely fixed) never reach the device, the others solve reduced and
    are postsolved back.  Bounds the presolve tightened become inequality
    rows (this surface has no native bounds).
    """
    import numpy as np

    from . import forms
    from .ipm_sparse import resolve_device
    from .results import LinProgResult

    dev = resolve_device(device)
    dtype = np.dtype(cfg.dtype)

    direct = {}  # index -> LinProgResult decided by presolve
    posts = {}  # index -> Postsolve
    canon = []
    canon_idx = []
    for i, p in enumerate(problems):
        c_in, A_in, b_in = p["c"], p.get("A"), p.get("b")
        G_in, h_in = p.get("G"), p.get("h")
        c_orig = np.asarray(c_in, np.float64)
        if presolve:
            from .presolve_host import presolve_problem

            red = presolve_problem(c_in, A_in, b_in, G_in, h_in)
            if red.post.status in (st.PRIMAL_INFEASIBLE,
                                   st.PRIMAL_UNBOUNDED):
                direct[i] = LinProgResult(
                    x=np.full(c_orig.shape, np.nan), basis=None,
                    cost=float("nan"), iters=0, optimum=False,
                    status=int(red.post.status),
                )
                continue
            if red.post.keep_cols.size == 0:
                x = red.post.expand(None)
                direct[i] = LinProgResult(
                    x=x, basis=None, cost=float(c_orig @ x), iters=0,
                    optimum=True, status=st.OPTIMAL,
                )
                continue
            G_in, h_in = _bound_rows(red)
            c_in, A_in, b_in = red.c, red.A, red.b
            posts[i] = red.post
        c_std, A_std, b_std, _ = forms.general_to_standard(
            c_in, A=A_in, b=b_in, G=G_in, h=h_in, dtype=dtype,
        )
        canon.append((c_std, A_std, b_std, np.asarray(c_in).shape[0]))
        canon_idx.append(i)

    if not canon:  # every instance decided by presolve
        return [direct[i] for i in range(len(problems))]

    m_pad = max(A.shape[0] for _, A, _, _ in canon)
    n_pad = max(A.shape[1] for _, A, _, _ in canon) + m_pad
    # the batch itself is f32, as the reference pads it (the kernels
    # take f32)
    padded = [forms.pad_problem(c_std, A_std, b_std, m_pad, n_pad)[:3]
              for c_std, A_std, b_std, _ in canon]
    cs, As, bs = (torch.as_tensor(np.stack(a), device=dev)
                  for a in zip(*padded))
    res = solve_batch_two_phase(cs, As, bs, maxiters1, maxiters2, cfg)
    x = res.x.cpu().numpy()
    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    solved = {}
    for k, (_, _, _, n_orig) in enumerate(canon):
        i = canon_idx[k]
        xi = x[k, :n_orig]
        if i in posts:  # eliminated variables scattered back
            xi = posts[i].expand(xi)
        solved[i] = LinProgResult(
            x=xi,
            basis=None,
            cost=float(np.asarray(problems[i]["c"], np.float64) @ xi),
            iters=int(iters[k]),
            optimum=bool(status[k] == st.OPTIMAL),
            status=int(status[k]),
        )
    return [direct[i] if i in direct else solved[i]
            for i in range(len(problems))]


def reoptimize_batch_new_rhs(c, A, b_new, basis, maxiters: int,
                             cfg: SolverConfig = DEFAULT_CONFIG
                             ) -> BatchResult:
    """Warm-started re-solve after the right-hand side changed.

    An optimal basis stays dual feasible when ``b`` changes, so the dual
    simplex restores primal feasibility from it in a few pivots.
    ``c[B, n], A[B, m, n], b_new[B, m], basis[B, m]``; ``basis`` typically
    comes from :func:`solve_batch_two_phase` on the same ``(c, A)`` and must
    index structural columns (``< n``).  A lane whose old basis is still
    primal feasible ends in one iteration; ``DUAL_UNBOUNDED`` means the
    perturbed instance is primal infeasible.  A singular starting basis
    gives ``NUMERICAL_ERROR``.
    """
    n = c.shape[-1]
    states = engine.make_state(A, b_new, basis)
    allowed = torch.ones((n,), dtype=torch.bool, device=A.device)
    states = _run_chunked(c, A, b_new, states, allowed, maxiters, cfg, "dual")

    # primal cleanup: the dual phase's f32 pricing can stop a pivot or two
    # short of optimal.  Refactor exactly, reopen the OPTIMAL lanes and let
    # the primal phase verify or finish them (one iteration where optimal).
    inv = engine.inv_or_nan(basis_matrix(A, states.basis))
    bfs = torch.einsum("bmk,bk->bm", inv, b_new)
    reopen = states.status == st.OPTIMAL
    states = states._replace(
        inv_B=torch.where(reopen[:, None, None], inv, states.inv_B),
        bfs=torch.where(reopen[:, None], bfs, states.bfs),
        status=torch.where(reopen, st.RUNNING, states.status).to(torch.int32),
    )
    states = _run_chunked(c, A, b_new, states, allowed, maxiters, cfg,
                          "primal")

    # exact solve at the terminal basis, unguarded as in the reference: a
    # singular terminal basis reports NaN values under its own status
    states = states._replace(
        bfs=solve_or_nan(basis_matrix(A, states.basis), b_new))

    if cfg.polish_pivots > 0:
        from .refine import dd_dot, polish_batch

        act = states.status == st.OPTIMAL
        pbasis, pxB, _, pinv, _ = polish_batch(
            c, A, b_new, states.basis, allowed, act,
            max_pivots=cfg.polish_pivots, pivot_tol=cfg.pivot_tol,
            inv_B=states.inv_B,
        )
        states = states._replace(
            basis=torch.where(act[:, None], pbasis, states.basis),
            bfs=torch.where(act[:, None], pxB, states.bfs),
            inv_B=torch.where(act[:, None, None], pinv, states.inv_B),
        )
        res = _to_result(c, states, n)
        return res._replace(cost=dd_dot(c, res.x))
    return _to_result(c, states, n)


@spanned("solve_batch_bounded")
@noting_lu
def solve_batch_bounded(c, A, b, lb, ub, basis, var_state, maxiters: int,
                        cfg: SolverConfig = DEFAULT_CONFIG) -> BatchResult:
    """Batched bounded-variable simplex: ``min c'x, Ax = b, lb <= x <= ub``.

    ``c[B, n], A[B, m, n], b[B, m], lb[B, n], ub[B, n], basis[B, m]``,
    ``var_state[B, n]`` (int8 in {AT_LB = 0, AT_UB = 1, BASIC = 2}): a
    starting basis with a bound assignment whose basic solution is within
    its bounds.  A variable at an infinite upper bound counts as zero.

    ``kernels="cuda"`` runs the bounded-variable kernel wherever it has a
    launch plan (the cluster-resident branch, else a streaming cluster a
    lane, up to m ~ 3000 at n = 2m) and raises ``NotImplementedError`` past
    it, naming ``kernels="torch"``; ``"torch"`` runs the per-lane engine
    :func:`linprog_tpu_torch.bounded.run_bounded` in plain PyTorch.
    """
    from . import bounded as bnd
    from .ops.bounded_kernel import has_plan
    from .refine import (
        dd_dot,
        dd_residual,
        polish_bounded_batch,
        refine_bfs,
    )

    B, m, n = A.shape
    if cfg.kernels == "cuda" and not has_plan(m, n):
        raise NotImplementedError(
            f"solve_batch_bounded at m={m}, n={n}: a lane is past the "
            "bounded kernel's streaming branch, so no kernel of "
            "kernels='cuda' runs it; ask for kernels='torch' to run the "
            "per-lane bounded engine in plain PyTorch"
        )
    states = bnd.make_bounded_state(A, b, lb, ub, basis, var_state)
    if cfg.kernels == "cuda":
        out = bnd.run_bounded_batched(c, A, b, lb, ub, states, maxiters, cfg)
    else:
        out = bnd.run_bounded(c, A, b, lb, ub, states, maxiters, cfg)
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


def unbounded_rays(c, A, states: engine.SimplexState,
                   cfg: SolverConfig = DEFAULT_CONFIG, allowed=None):
    """Improving rays for the ``PRIMAL_UNBOUNDED`` lanes: ``d[B, n]`` with
    ``A d = 0``, ``d >= 0``, ``c'd < 0`` (entering coordinate 1, basic
    coordinates ``-inv_B a_j`` for the first column ``j`` with a negative
    reduced cost and no positive direction entry); zero on every other
    lane.

    ``c``, ``A`` and ``states`` are the arrays the engine ran on (for the
    two-phase pipeline the Phase-II ``[A | I]`` and padded cost: see
    :func:`unbounded_rays_from_result`).
    """
    B, m, n = A.shape
    if allowed is None:
        allowed = torch.ones((n,), dtype=torch.bool, device=A.device)
    lanes = torch.arange(B, device=A.device)
    r = c - torch.einsum("bm,bmn->bn", engine.duals(c, states), A)
    r = torch.where(engine.in_basis_mask(states.basis, n), 0.0, r)
    D = torch.matmul(states.inv_B, A)  # [B, m, n]: every candidate direction
    no_ascent = ~(D > cfg.pivot_tol).any(dim=1)
    cand = (r < -cfg.opt_tol) & no_ascent & allowed[None, :]
    j = cand.to(torch.int8).argmax(dim=1)  # first certificate column
    ok = cand[lanes, j] & (states.status == st.PRIMAL_UNBOUNDED)
    Dj = D[lanes, :, j]
    basics = torch.where(Dj < 0.0, -Dj, 0.0)  # clip tolerance noise
    ray = torch.zeros((B, n), dtype=A.dtype, device=A.device)
    ray.scatter_(1, states.basis.long(), basics)
    ray[lanes, j] = 1.0
    return torch.where(ok[:, None], ray, 0.0)


def unbounded_rays_from_result(c, A, result: BatchResult,
                               cfg: SolverConfig = DEFAULT_CONFIG):
    """Improving rays for a :func:`solve_batch_two_phase` result, in the
    original structural space (``[B, n]``; zero where the lane is not
    ``PRIMAL_UNBOUNDED``).  Rebuilds the Phase-II arrays from ``c[B, n]``,
    ``A[B, m, n]`` and the result's terminal basis."""
    B, m, n = A.shape
    dt, dev = A.dtype, A.device
    eye = torch.eye(m, dtype=dt, device=dev).expand(B, m, m)
    A1 = torch.cat([A, eye], dim=2)
    c2 = torch.cat([c.to(dt), torch.zeros((B, m), dtype=dt, device=dev)],
                   dim=1)
    states = engine.make_state(A1, torch.zeros((B, m), dtype=dt, device=dev),
                               result.basis)
    states = states._replace(status=result.status)
    allowed = torch.arange(n + m, device=dev) < n  # no ray on artificials
    return unbounded_rays(c2, A1, states, cfg, allowed=allowed)[:, :n]


def batch_summary(result: BatchResult) -> dict:
    """Host-side lane counts by status, and the pivots."""
    status = result.status.cpu().numpy()
    iters = result.iters.cpu().numpy()
    return {
        "lanes": int(status.shape[0]),
        "optimal": int((status == st.OPTIMAL).sum()),
        "infeasible": int((status == st.PRIMAL_INFEASIBLE).sum()),
        "unbounded": int((status == st.PRIMAL_UNBOUNDED).sum()),
        "iter_limit": int((status == st.ITER_LIMIT).sum()),
        "total_pivots": int(iters.sum()),
        "max_pivots": int(iters.max()),
    }
