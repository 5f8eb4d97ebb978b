"""The solver classes of the general-form surface (counterpart of
:mod:`linprog_tpu.api`): the same class names, constructor signatures,
statuses and exceptions.

* ``PrimalNaiveSimplexSolver`` / ``PrimalRevisedSimplexSolver`` and
  ``DualNaiveSimplexSolver`` / ``DualRevisedSimplexSolver``: one instance
  in standard form from a given starting basis;
* ``BoundedVariablePrimalSimplexSolver``: native bounds ``lb <= x <= ub``;
* ``PhaseOneSimplexSolver``: a starting basis from Phase I;
* ``SimplexSolver``: the general form ``Ax = b, Gx <= h, lb <= x <= ub``
  with no starting basis (free variables, lower-bound shifts, sign-flipped
  rows and redundant rows mapped back in ``x`` and ``y``).

The naive/revised and primal/dual axes are configuration: every class
binds the per-lane engine (:func:`linprog_tpu_torch.engine.run`,
:func:`linprog_tpu_torch.bounded.run_bounded`) at a batch of one with a
``(mode, update)`` pair.  The state stays on the device between calls, so
``solve(maxiters=1)`` resumes where the last call stopped.  Terminal error
statuses are raised as the reference's exceptions.  Every class takes host
arrays and runs on ``device``: a card by default, ``device="cpu"`` on the
host; without a card ``"cuda"`` raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import engine, forms, phase1
from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .ipm_sparse import resolve_device
from .results import LinProgResult


def _lane(t):
    """The only lane of a batch of one, on the host."""
    return t[0].cpu().numpy()


class _SimplexSolverBase:
    """Shared host wrapper: the problem as tensors on the device and the
    solver state, a batch of one."""

    _mode = "primal"  # "primal" | "dual"
    _update = "eta"  # "eta" | "naive"

    def __init__(self, c, A, b, basis, config: Optional[SolverConfig] = None,
                 device="cuda"):
        """Standard form ``min c'x  s.t. Ax = b, x >= 0`` from a starting
        basis.  A singular basis matrix raises ``ValueError``; a basis that
        is not feasible for the class's mode raises
        ``BasisIsPrimalInfeasibleError`` (``BasisIsDualInfeasibleError``)."""
        cfg = config or DEFAULT_CONFIG
        self.config = cfg.replace(update=self._update)
        self.device = resolve_device(device)
        dtype = np.dtype(self.config.dtype)
        c, A, b = forms.preprocess_problem(c, A, b, dtype)
        self.c = torch.tensor(c, device=self.device)
        self.A = torch.tensor(A, device=self.device)
        self.b = torch.tensor(b, device=self.device)
        self.m, self.n = A.shape
        self._allowed = torch.ones((self.n,), dtype=torch.bool,
                                   device=self.device)
        basis = torch.tensor(np.asarray(basis, np.int32), device=self.device)
        self._state = engine.make_state(self.A[None], self.b[None],
                                        basis[None])
        if int(self._state.status[0]) == st.NUMERICAL_ERROR:
            raise ValueError("starting basis matrix A[:, basis] is singular")
        self.counter: Optional[int] = None
        self.optimum: Optional[bool] = None
        self._check_basis_feasibility()

    # -- feasibility gates (raised at construction) -------------------------
    def _check_basis_feasibility(self):
        if not bool(engine.basis_is_primal_feasible(
                self.A[None], self.b[None], self._state.basis,
                self.config.feas_tol)[0]):
            raise st.BasisIsPrimalInfeasibleError(
                "starting basis is not primal feasible"
            )

    # -- state views --------------------------------------------------------
    @property
    def basis(self) -> np.ndarray:
        return _lane(self._state.basis)

    @property
    def inv_basis_matrix(self) -> np.ndarray:
        return _lane(self._state.inv_B)

    @property
    def bfs(self) -> np.ndarray:
        return _lane(self._state.bfs)

    @property
    def state(self) -> engine.SimplexState:
        """The solver state of this instance (unbatched tensors on the
        device)."""
        return engine.SimplexState(*(t[0] for t in self._state))

    def ranging(self):
        """Sensitivity intervals at the current basis
        (:class:`linprog_tpu_torch.ranging.RangingResult` of tensors on the
        device); call after ``solve()`` reached OPTIMAL."""
        from .ranging import ranging as _ranging

        return _ranging(self.c, self.A, self.b, self.state)

    # -- operations ---------------------------------------------------------
    def pivot(self, col_in_basis_to_leave_basis: int,
              col_in_A_to_enter_basis: int):
        """One explicit pivot: basis position ``col_in_basis_to_leave_basis``
        takes column ``col_in_A_to_enter_basis``."""
        leave = torch.tensor([col_in_basis_to_leave_basis], device=self.device)
        enter = torch.tensor([col_in_A_to_enter_basis], device=self.device)
        self._state = engine.pivot(self.A[None], self.b[None], self._state,
                                   leave, enter, self.config)

    def solve(self, maxiters: int = 100) -> LinProgResult:
        """Run up to ``maxiters`` iterations; resumable across calls (the
        counter and status restart on every call)."""
        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        state = self._state._replace(iters=zero, status=zero)
        state = engine.run(self.c[None], self.A[None], self.b[None], state,
                           self._allowed, maxiters, self.config, self._mode)
        self._state = state
        code = int(state.status[0])
        self.counter = int(state.iters[0])
        self.optimum = code == st.OPTIMAL
        if code != st.RUNNING:
            # the iteration cap is a soft failure: the state stays
            # resumable and optimum is False
            st.raise_for_status(code)
        return self._result(state)

    def _result(self, state: engine.SimplexState) -> LinProgResult:
        x = engine.expand_bfs(state, self.n)
        return LinProgResult(
            x=_lane(x),
            basis=_lane(state.basis),
            cost=float((self.c * x[0]).sum()),
            iters=int(state.iters[0]),
            optimum=bool(state.status[0] == st.OPTIMAL),
            status=int(state.status[0]),
            y=_lane(engine.duals(self.c[None], state)),
        )


class PrimalNaiveSimplexSolver(_SimplexSolverBase):
    """Primal simplex, Bland's rule by default, the basis re-inverted at
    every pivot (a correctness oracle; the eta-update variant is the fast
    one)."""

    _mode = "primal"
    _update = "naive"


class PrimalRevisedSimplexSolver(_SimplexSolverBase):
    """Primal simplex with product-form (rank-1 eta) updates of the basis
    inverse."""

    _mode = "primal"
    _update = "eta"


class _DualGateMixin:
    def _check_basis_feasibility(self):
        if not bool(engine.basis_is_dual_feasible(
                self.c[None], self.A[None], self._state.basis,
                self.config.feas_tol)[0]):
            raise st.BasisIsDualInfeasibleError(
                "starting basis is not dual feasible")


class DualNaiveSimplexSolver(_DualGateMixin, _SimplexSolverBase):
    """Dual simplex, the basis re-inverted at every pivot."""

    _mode = "dual"
    _update = "naive"


class DualRevisedSimplexSolver(_DualGateMixin, _SimplexSolverBase):
    """Dual simplex with eta updates."""

    _mode = "dual"
    _update = "eta"


class BoundedVariablePrimalSimplexSolver:
    """Primal simplex with native variable bounds ``lb <= x <= ub``.

    The constructor takes the starting basis and the index sets of the
    nonbasic variables at their lower and upper bounds; they become one
    state per variable (:mod:`linprog_tpu_torch.bounded`).  Infinite bounds
    are clamped to ``-/+ M``, the overflow-safe bound on the magnitude of a
    basic feasible solution (:func:`linprog_tpu_torch.utils.get_bounds_on_bfs`).
    """

    def __init__(self, c, A, b, lb, ub, basis, lb_nonbasic_vars,
                 ub_nonbasic_vars, config: Optional[SolverConfig] = None,
                 device="cuda"):
        from . import bounded
        from .utils import get_bounds_on_bfs

        self.config = config or DEFAULT_CONFIG
        self.device = resolve_device(device)
        dtype = np.dtype(self.config.dtype)
        c, A, b = forms.preprocess_problem(c, A, b, dtype)
        lb = np.asarray(lb, dtype=dtype).copy()
        ub = np.asarray(ub, dtype=dtype).copy()
        M = float(get_bounds_on_bfs(torch.as_tensor(A), torch.as_tensor(b)))
        lb[np.isneginf(lb)] = -M
        ub[np.isposinf(ub)] = M
        self.m, self.n = A.shape

        var_state = np.full(self.n, int(bounded.AT_LB), dtype=np.int8)
        var_state[np.asarray(ub_nonbasic_vars, dtype=int)] = int(bounded.AT_UB)
        var_state[np.asarray(basis, dtype=int)] = int(bounded.BASIC)

        def dev(a):
            return torch.tensor(a, device=self.device)

        self.c, self.A, self.b, self.lb, self.ub = (
            dev(a) for a in (c, A, b, lb, ub))
        self._state = bounded.make_bounded_state(
            self.A[None], self.b[None], self.lb[None], self.ub[None],
            dev(np.asarray(basis, np.int32))[None], dev(var_state)[None])
        self.counter: Optional[int] = None
        self.optimum: Optional[bool] = None

    @property
    def basis(self) -> np.ndarray:
        return _lane(self._state.basis)

    @property
    def bfs(self) -> np.ndarray:
        return _lane(self._state.bfs)

    @property
    def var_state(self) -> np.ndarray:
        return _lane(self._state.var_state)

    def pivot(self, *args, **kwargs):
        raise NotImplementedError(
            "`pivot` is fused into `solve` for the bounded-variable engine."
        )

    def solve(self, maxiters: int = 100) -> LinProgResult:
        from . import bounded

        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        state = self._state._replace(iters=zero, status=zero)
        lb, ub = self.lb[None], self.ub[None]
        state = bounded.run_bounded(self.c[None], self.A[None], self.b[None],
                                    lb, ub, state, maxiters, self.config)
        self._state = state
        code = int(state.status[0])
        self.counter = int(state.iters[0])
        self.optimum = code == st.OPTIMAL
        st.raise_for_status(code)
        x = bounded.expand_bounded_bfs(state, lb, ub)
        return LinProgResult(
            x=_lane(x),
            basis=_lane(state.basis),
            cost=float((self.c * x[0]).sum()),
            iters=self.counter,
            optimum=self.optimum,
            status=code,
        )


class PhaseOneSimplexSolver:
    """Phase I on its own: after ``solve()``, ``self.basis`` holds the
    Phase-II starting basis and ``self.A`` / ``self.b`` the constraints
    with redundant rows removed."""

    def __init__(self, c, A, b, config: Optional[SolverConfig] = None,
                 device="cuda"):
        self.config = config or DEFAULT_CONFIG
        self.device = resolve_device(device)
        dtype = np.dtype(self.config.dtype)
        self.c, self.A, self.b = forms.preprocess_problem(c, A, b, dtype)
        self.m, self.n = self.A.shape
        self.basis: Optional[np.ndarray] = None

    def solve(self, maxiters: int = 100) -> None:
        res = phase1.solve_phase1(self.c, self.A, self.b, maxiters=maxiters,
                                  cfg=self.config, device=self.device)
        self.basis = res.basis
        self.A = np.asarray(res.A)
        self.b = np.asarray(res.b)
        self.m = self.A.shape[0]


class SimplexSolver:
    """General form ``min c'x  s.t. Ax = b, Gx <= h, lb <= x <= ub``, no
    starting basis needed.

    The constructor brings the problem to standard form on the host: a free
    variable with a finite upper bound is substituted (``x = ub - w``), a
    doubly free one split into two columns, a finite nonzero lower bound
    shifted out (``x = lb + w``), ``G`` given slack columns and rows with a
    negative right-hand side sign-flipped.  ``solve`` runs Phase I and then
    Phase II and maps ``x`` and the duals ``y`` back to the user's variables
    and rows (equality rows first, then inequality rows).  Finite upper
    bounds run natively on the bounded-variable engine
    (``bounds_mode="native"``, the default) or as extra rows
    (``bounds_mode="rows"``).
    """

    def __init__(self, c, A=None, b=None, G=None, h=None, lb=None, ub=None,
                 config: Optional[SolverConfig] = None,
                 bounds_mode: str = "native", device="cuda"):
        if bounds_mode not in ("native", "rows"):
            raise ValueError(f"unknown bounds_mode: {bounds_mode!r}")
        self._bounds_mode = bounds_mode
        self.config = config or DEFAULT_CONFIG
        self.device = resolve_device(device)
        dtype = np.dtype(self.config.dtype)
        c = np.asarray(c, dtype=dtype).copy()
        n_orig = c.shape[0]
        self.n_orig = n_orig
        self._c_orig = c.copy()

        if lb is None:
            lb = np.zeros(n_orig, dtype=dtype)
        lb = np.asarray(lb, dtype=dtype).copy()
        if ub is None:
            ub = np.full(n_orig, np.inf, dtype=dtype)
        ub = np.asarray(ub, dtype=dtype).copy()

        A = None if A is None else np.atleast_2d(np.asarray(A, dtype=dtype)).copy()
        b = None if b is None else np.asarray(b, dtype=dtype).copy()
        G = None if G is None else np.atleast_2d(np.asarray(G, dtype=dtype)).copy()
        h = None if h is None else np.asarray(h, dtype=dtype).copy()

        # ---- free variables (lb = -inf) ----------------------------------
        #  * lb = -inf, ub finite: substitute x_j = ub_j - w_j (column
        #    negated, rhs shifted), w_j >= 0;
        #  * lb = -inf, ub = +inf: split x_j = u_j - v_j, with a negated
        #    copy of the column appended for v_j.
        free = np.isneginf(lb)
        self._sub_idx = np.flatnonzero(free & np.isfinite(ub))
        self._split_idx = np.flatnonzero(free & ~np.isfinite(ub))
        self._sub_ub = ub[self._sub_idx].copy()
        for j in self._sub_idx:
            u_j = ub[j]
            if b is not None:
                b -= A[:, j] * u_j
            if h is not None:
                h -= G[:, j] * u_j
            if A is not None:
                A[:, j] *= -1
            if G is not None:
                G[:, j] *= -1
            c[j] *= -1
            lb[j], ub[j] = 0.0, np.inf
        k = self._split_idx.size
        if k:
            if A is not None:
                A = np.concatenate([A, -A[:, self._split_idx]], axis=1)
            if G is not None:
                G = np.concatenate([G, -G[:, self._split_idx]], axis=1)
            c = np.concatenate([c, -c[self._split_idx]])
            lb = np.concatenate([lb, np.zeros(k, dtype=dtype)])
            lb[self._split_idx] = 0.0
            ub = np.concatenate([ub, np.full(k, np.inf, dtype=dtype)])
        self.n_aug = n_orig + k

        # ---- finite nonzero lower bounds: shift x_j = lb_j + w_j ---------
        # the rhs moves by A[:, j] lb_j and the bounds become
        # [0, ub_j - lb_j]: negative lower bounds are right, and a tiny lb
        # such as 1e-9 is kept exactly
        shift_idx = np.flatnonzero(np.isfinite(lb) & (lb != 0.0))
        self._shift_idx = shift_idx
        self._shift_lb = lb[shift_idx].copy()
        if shift_idx.size:
            if b is not None:
                b = b - A[:, shift_idx] @ self._shift_lb
            if h is not None:
                h = h - G[:, shift_idx] @ self._shift_lb
            ub[shift_idx] = ub[shift_idx] - self._shift_lb
            lb[shift_idx] = 0.0

        # the user's rows for the duals: general_to_standard stacks
        # [A rows; G rows] and flips the rows with a negative rhs, whose
        # dual is then the negated standard-form dual
        m_eq = 0 if (A is None or b is None) else np.atleast_1d(b).shape[0]
        m_ineq = 0 if (G is None or h is None) else np.atleast_1d(h).shape[0]
        self._m_user = m_eq + m_ineq
        rhs_user = np.concatenate(
            [np.atleast_1d(b) if m_eq else np.zeros(0),
             np.atleast_1d(h) if m_ineq else np.zeros(0)]
        )
        self._row_flip = rhs_user < 0

        c_std, A_std, b_std, num_slack = forms.general_to_standard(
            c, A=A, b=b, G=G, h=h, dtype=dtype
        )
        self.num_slack_vars = num_slack
        self.lb = np.concatenate([lb, np.zeros(num_slack, dtype=dtype)])
        self.ub = np.concatenate([ub, np.full(num_slack, np.inf, dtype=dtype)])
        self.c, self.A, self.b = c_std, A_std, b_std
        self.num_vars = self.A.shape[1]

    def _reconstruct_x(self, x_aug: np.ndarray) -> np.ndarray:
        """The augmented solution in the original variable space."""
        x = x_aug[: self.n_orig].copy()
        if self._split_idx.size:
            x[self._split_idx] -= x_aug[self.n_orig : self.n_aug]
        if self._sub_idx.size:
            x[self._sub_idx] = self._sub_ub - x[self._sub_idx]
        if self._shift_idx.size:  # disjoint from sub/split (those set lb=0)
            x[self._shift_idx] += self._shift_lb
        return x

    def solve(self, maxiters1: int = 100, maxiters2: int = 100) -> LinProgResult:
        """Two-phase solve.  With ``bounds_mode="native"`` and a finite upper
        bound the bounded-variable engine runs both phases on
        ``0 <= x <= ub`` (the lower bounds are shifted to 0 already);
        otherwise the bounds become rows and Phase I is followed by the
        revised primal solver from its basis."""
        if self._bounds_mode == "native" and np.isfinite(self.ub).any():
            return self._solve_native_bounds(maxiters1, maxiters2)
        c1, A1, b1 = forms.bounds_to_rows(
            self.c, self.A, self.b, self.lb, self.ub,
            dtype=np.dtype(self.config.dtype),
        )
        p1 = phase1.solve_phase1(c1, A1, b1, maxiters=maxiters1,
                                 cfg=self.config, device=self.device)
        solver = PrimalRevisedSimplexSolver(
            c1, p1.A, p1.b, p1.basis, config=self.config, device=self.device
        )
        res = solver.solve(maxiters=maxiters2)
        res.x = self._reconstruct_x(res.x[: self.n_aug])
        res.cost = float(self._c_orig @ res.x)
        res.basis = None  # not meaningful in the original variable space
        # duals in the user's row space: zero on the rows Phase I dropped,
        # bound rows left out, sign-flipped rows negated back
        if res.y is not None:
            y_full = np.zeros(A1.shape[0])
            keep = np.setdiff1d(
                np.arange(A1.shape[0]), np.asarray(p1.dropped_rows)
            )
            y_full[keep] = res.y
            y_user = y_full[: self._m_user]
            res.y = np.where(self._row_flip, -y_user, y_user)
        return res

    def _solve_native_bounds(self, maxiters1: int, maxiters2: int
                             ) -> LinProgResult:
        """Both phases on the bounded-variable engine
        (:func:`linprog_tpu_torch.bounded.solve_bounded_two_phase`)."""
        from . import bounded as bnd

        def dev(a):
            return torch.tensor(a, device=self.device)[None]

        x_std, _, iters, status, y = bnd.solve_bounded_two_phase(
            dev(self.c), dev(self.A), dev(self.b), dev(self.lb),
            dev(self.ub), maxiters1, maxiters2, self.config)
        code = int(status[0])
        x = self._reconstruct_x(_lane(x_std)[: self.n_aug])
        # no bound rows were added and no rows dropped: only the sign-fix
        # flip is undone
        y_user = _lane(y)[: self._m_user]
        y_user = np.where(self._row_flip, -y_user, y_user)
        res = LinProgResult(
            x=x,
            basis=None,  # not meaningful in the original variable space
            cost=float(self._c_orig @ x),
            iters=int(iters[0]),
            optimum=code == st.OPTIMAL,
            status=code,
            y=y_user,
        )
        st.raise_for_status(code)
        return res
