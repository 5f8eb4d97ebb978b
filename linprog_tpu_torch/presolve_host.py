"""Host-side structural presolve for the general-form surface
(counterpart of :mod:`linprog_tpu.presolve_host`; NumPy, the same
reductions with the same results).

It shrinks ``min c'x s.t. Ax = b, Gx <= h, lb <= x <= ub`` before the
shapes go to the device, where row and column elimination cannot happen
(a batch has one static shape).  It is the host companion of the device
Ruiz equilibration in :mod:`linprog_tpu_torch.presolve`.

Reductions, iterated to a fixpoint:

1. inconsistent bounds ``lb_j > ub_j``  -> PRIMAL_INFEASIBLE;
2. fixed variables ``lb_j == ub_j``     -> substituted into b/h, dropped;
3. empty rows: zero A row with ``b != 0`` / zero G row with ``h < 0``
   -> PRIMAL_INFEASIBLE, otherwise dropped;
4. singleton A rows ``a x_j = b_i``     -> fixes ``x_j`` (case 2);
5. singleton G rows ``a x_j <= h_i``    -> tightened bound, row dropped;
6. empty columns (zero in A and G): ``x_j`` sits at the bound its cost
   prefers; a missing finite bound there -> PRIMAL_UNBOUNDED (reported
   as unbounded without checking the rest for feasibility, which is what
   Phase II would conclude).

``Postsolve.expand`` scatters eliminated variables back, so callers see
the full-length solution.  Duals are not mapped back through the
reductions (that needs the reduction trail): :func:`solve_with_presolve`
returns primal results only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import status as st


@dataclasses.dataclass
class Postsolve:
    """Mapping from the reduced problem's x back to the original space."""

    n_orig: int
    keep_cols: np.ndarray  # indices of surviving columns, in order
    fixed_vals: np.ndarray  # [n_orig] values of eliminated vars (0 if kept)
    fixed_mask: np.ndarray  # [n_orig] True where eliminated
    status: int = st.RUNNING  # terminal verdict reached during presolve

    def expand(self, x_reduced: Optional[np.ndarray]) -> np.ndarray:
        x = np.array(self.fixed_vals, dtype=np.float64, copy=True)
        if x_reduced is not None and self.keep_cols.size:
            x[self.keep_cols] = np.asarray(x_reduced, dtype=np.float64)
        return x


@dataclasses.dataclass
class ReducedProblem:
    c: np.ndarray
    A: Optional[np.ndarray]
    b: Optional[np.ndarray]
    G: Optional[np.ndarray]
    h: Optional[np.ndarray]
    lb: np.ndarray
    ub: np.ndarray
    post: Postsolve
    c_offset: float = 0.0  # cost contribution of eliminated variables


def presolve_problem(c, A=None, b=None, G=None, h=None, lb=None, ub=None,
                     tol: float = 1e-9, max_rounds: int = 20
                     ) -> ReducedProblem:
    """Run the reductions to a fixpoint; never raises -- verdicts land in
    ``result.post.status`` (RUNNING means: solve the reduced problem)."""
    c = np.asarray(c, np.float64).copy()
    n = c.shape[0]
    A = (np.zeros((0, n)) if A is None
         else np.atleast_2d(np.asarray(A, np.float64)).copy())
    b = (np.zeros((0,)) if b is None
         else np.atleast_1d(np.asarray(b, np.float64)).copy())
    G = (np.zeros((0, n)) if G is None
         else np.atleast_2d(np.asarray(G, np.float64)).copy())
    h = (np.zeros((0,)) if h is None
         else np.atleast_1d(np.asarray(h, np.float64)).copy())
    lb = (np.zeros(n) if lb is None
          else np.asarray(lb, np.float64).copy())
    ub = (np.full(n, np.inf) if ub is None
          else np.asarray(ub, np.float64).copy())

    fixed_vals = np.zeros(n)
    fixed_mask = np.zeros(n, bool)
    col_alive = np.ones(n, bool)
    status = st.RUNNING
    c_offset = 0.0

    def fix(j, v):
        nonlocal c_offset
        fixed_vals[j] = v
        fixed_mask[j] = True
        col_alive[j] = False
        c_offset += c[j] * v
        b[:] -= A[:, j] * v
        h[:] -= G[:, j] * v
        A[:, j] = 0.0
        G[:, j] = 0.0

    for _ in range(max_rounds):
        changed = False

        # 1. inconsistent bounds
        bad = col_alive & (lb > ub + tol)
        if bad.any():
            status = st.PRIMAL_INFEASIBLE
            break

        # 2. fixed variables
        for j in np.flatnonzero(col_alive & (ub - lb <= tol)
                                & np.isfinite(lb)):
            fix(j, lb[j])
            changed = True

        # 3/4. A rows: empty -> verdict/drop; singleton -> fix
        nzA = np.abs(A) > tol
        cntA = nzA.sum(axis=1)
        empty = cntA == 0
        if empty.any():
            if (np.abs(b[empty]) > 1e-7).any():
                status = st.PRIMAL_INFEASIBLE
                break
            keep = ~empty
            A, b = A[keep], b[keep]
            changed = changed or empty.any()
            nzA, cntA = nzA[keep], cntA[keep]
        for i in np.flatnonzero(cntA == 1):
            j = int(np.flatnonzero(nzA[i])[0])
            if not col_alive[j]:
                continue
            v = b[i] / A[i, j]
            if v < lb[j] - 1e-7 or v > ub[j] + 1e-7:
                status = st.PRIMAL_INFEASIBLE
                break
            fix(j, v)
            changed = True
        if status != st.RUNNING:
            break

        # 3/5. G rows: empty -> verdict/drop; singleton -> bound tighten
        nzG = np.abs(G) > tol
        cntG = nzG.sum(axis=1)
        empty = cntG == 0
        if empty.any():
            if (h[empty] < -1e-7).any():
                status = st.PRIMAL_INFEASIBLE
                break
            keep = ~empty
            G, h = G[keep], h[keep]
            changed = True
            nzG, cntG = nzG[keep], cntG[keep]
        singles = np.flatnonzero(cntG == 1)
        if singles.size:
            drop = np.zeros(G.shape[0], bool)
            for i in singles:
                j = int(np.flatnonzero(nzG[i])[0])
                if not col_alive[j]:
                    continue
                a = G[i, j]
                if a > 0:
                    ub[j] = min(ub[j], h[i] / a)
                else:
                    lb[j] = max(lb[j], h[i] / a)
                drop[i] = True
                changed = True
            if drop.any():
                G, h = G[~drop], h[~drop]

        # 6. empty columns
        colA = (np.abs(A) > tol).any(axis=0)
        colG = (np.abs(G) > tol).any(axis=0)
        for j in np.flatnonzero(col_alive & ~colA & ~colG):
            if c[j] > tol:
                if not np.isfinite(lb[j]):
                    status = st.PRIMAL_UNBOUNDED
                    break
                fix(j, lb[j])
            elif c[j] < -tol:
                if not np.isfinite(ub[j]):
                    status = st.PRIMAL_UNBOUNDED
                    break
                fix(j, ub[j])
            else:
                fix(j, lb[j] if np.isfinite(lb[j]) else 0.0)
            changed = True
        if status != st.RUNNING or not changed:
            break

    keep_cols = np.flatnonzero(col_alive)
    post = Postsolve(
        n_orig=n, keep_cols=keep_cols, fixed_vals=fixed_vals,
        fixed_mask=fixed_mask, status=status,
    )
    return ReducedProblem(
        c=c[keep_cols],
        A=A[:, keep_cols] if A.shape[0] else None,
        b=b if A.shape[0] else None,
        G=G[:, keep_cols] if G.shape[0] else None,
        h=h if G.shape[0] else None,
        lb=lb[keep_cols],
        ub=ub[keep_cols],
        post=post,
        c_offset=c_offset,
    )


def solve_with_presolve(c, A=None, b=None, G=None, h=None, lb=None, ub=None,
                        config=None, maxiters1: int = 1000,
                        maxiters2: int = 1000, device="cuda"):
    """Presolve, solve the reduced problem with
    :class:`~linprog_tpu_torch.api.SimplexSolver` on ``device`` (a card by
    default; ``device="cpu"`` runs on the host), postsolve.  Returns a
    :class:`~linprog_tpu_torch.results.LinProgResult` in the original
    variable space (``basis`` and ``y`` are None: they refer to the reduced
    space and are not mapped back)."""
    from .ipm_sparse import resolve_device
    from .results import LinProgResult

    dev = resolve_device(device)
    red = presolve_problem(c, A, b, G, h, lb, ub)
    c_np = np.asarray(c, np.float64)

    if red.post.status == st.PRIMAL_INFEASIBLE:
        raise st.PrimalIsInfeasibleError("presolve: infeasible")
    if red.post.status == st.PRIMAL_UNBOUNDED:
        raise st.PrimalIsUnboundedError("presolve: unbounded")

    if red.post.keep_cols.size == 0:
        # fully determined by presolve; verify remaining constraints
        x = red.post.expand(None)
        ok = True
        if A is not None and b is not None:
            ok &= bool(np.allclose(np.atleast_2d(A) @ x, b, atol=1e-6))
        if G is not None and h is not None:
            ok &= bool((np.atleast_2d(G) @ x <= np.asarray(h) + 1e-6).all())
        if not ok:
            raise st.PrimalIsInfeasibleError("presolve: fixed point violates "
                                             "remaining constraints")
        return LinProgResult(x=x, basis=None, cost=float(c_np @ x), iters=0,
                             optimum=True, status=st.OPTIMAL, y=None)

    from .api import SimplexSolver

    solver = SimplexSolver(
        red.c, A=red.A, b=red.b, G=red.G, h=red.h, lb=red.lb, ub=red.ub,
        config=config, device=dev,
    )
    res = solver.solve(maxiters1=maxiters1, maxiters2=maxiters2)
    x = red.post.expand(res.x)
    return LinProgResult(
        x=x, basis=None, cost=float(c_np @ x), iters=res.iters,
        optimum=res.optimum, status=res.status, y=None,
    )
