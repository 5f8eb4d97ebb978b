"""Phase I: a basic feasible solution from artificial variables
(counterpart of :mod:`linprog_tpu.phase1`).

* ``m`` artificials are appended (``A <- [A | I]``, ``c <- [0..0, 1..1]``)
  and the primal per-lane engine runs from the all-artificial basis, whose
  start state needs no inversion (``inv_B = I``, ``bfs = b``);
* a positive optimal cost means the problem is primal infeasible, with the
  Phase-I duals as a Farkas certificate; a Phase I that does not converge
  raises ``ValueError``;
* artificials left basic at zero level are pivoted out wherever a nonbasic
  structural column has a positive entry in their row
  (:func:`drive_out_artificials`: a loop over basis positions, the batch
  dimension explicit);
* rows whose artificial cannot be driven out are redundant and dropped
  (the strict test ``basis >= n``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import engine
from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .ipm_sparse import resolve_device


def phase1_problem(c, A, b):
    """The Phase-I problem ``([A | I], [0..0, 1..1])`` of every lane:
    ``A[B, m, n]``, ``b[B, m]`` tensors; returns ``(c1[B, n + m],
    A1[B, m, n + m], b)``.  ``c`` is not read (the Phase-I cost is fixed)."""
    B, m, n = A.shape
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(B, m, m)
    A1 = torch.cat([A, eye], dim=2)
    c1 = torch.cat([torch.zeros(n, dtype=A.dtype, device=A.device),
                    torch.ones(m, dtype=A.dtype, device=A.device)])
    return c1.expand(B, n + m).contiguous(), A1, b


def drive_out_artificials(A1, b, state: engine.SimplexState,
                          n_structural: int, cfg: SolverConfig
                          ) -> engine.SimplexState:
    """Pivot zero-level artificials out of every lane's basis where
    possible.

    One pass over basis positions: at a position that holds an artificial,
    the entering column is the first nonbasic structural column with an
    entry above ``pivot_tol`` in that row of ``inv_B A1``.  The pivots are
    degenerate (the artificial is at zero), so feasibility holds without a
    ratio test.  A pivot changes only its own position, so only the
    positions that hold an artificial in some lane at the start are
    visited (the others would be left as they are)."""
    B, m, n_tot = A1.shape
    structural = torch.arange(n_tot, device=A1.device) < n_structural
    art_any = (state.basis >= n_structural).any(dim=0).cpu().numpy()
    for pos in np.flatnonzero(art_any):
        pos_t = torch.full((B,), int(pos), dtype=torch.long,
                           device=A1.device)
        is_art = state.basis[:, pos] >= n_structural
        row = torch.einsum("bm,bmn->bn", state.inv_B[:, pos], A1)
        nonbasic = ~engine.in_basis_mask(state.basis, n_tot)
        cand = (row > cfg.pivot_tol) & nonbasic & structural
        found = cand.any(dim=1)
        enter = cand.to(torch.int8).argmax(dim=1)
        pivoted = engine.apply_pivot(A1, b, state, pos_t, enter, cfg)
        state = engine.tree_select(is_art & found, pivoted, state)
    return state


class Phase1Result(NamedTuple):
    basis: np.ndarray  # starting basis for Phase II (len == rows kept)
    A: np.ndarray  # the constraint matrix, redundant rows removed
    b: np.ndarray  # the right-hand side, redundant rows removed
    iters: int
    dropped_rows: np.ndarray  # indices of the redundant rows removed


def solve_phase1(c, A, b, maxiters: int = 100,
                 cfg: SolverConfig = DEFAULT_CONFIG,
                 device="cuda") -> Phase1Result:
    """Phase I of one instance given as host arrays ``A[m, n]``,
    ``b[m] >= 0``, run on ``device`` (a card by default; ``device="cpu"``
    runs on the host).  Returns a Phase-II starting basis.

    Raises ``PrimalIsInfeasibleError`` (with ``.certificate``, the Farkas
    duals: ``y'A <= 0`` and ``y'b > 0``) if the optimal artificial cost is
    positive, ``ValueError`` if Phase I stops at ``maxiters`` short of it.
    """
    A = np.asarray(A)
    b = np.asarray(b)
    m, n = A.shape
    dev = resolve_device(device)
    At = torch.tensor(A, device=dev)[None]
    bt = torch.tensor(b, device=dev)[None]
    c1, A1, _ = phase1_problem(None, At, bt)
    state = engine.artificial_state(bt, n)
    allowed = torch.ones((n + m,), dtype=torch.bool, device=dev)
    state = engine.run(c1, A1, bt, state, allowed, maxiters, cfg, "primal")

    cost = float(engine.current_cost(c1, state)[0])
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    if cost > cfg.feas_tol * scale * max(1, m):
        if int(state.status[0]) == st.OPTIMAL:
            err = st.PrimalIsInfeasibleError(
                f"Phase I optimum {cost:.3e} > 0: no feasible point exists."
            )
            err.certificate = engine.duals(c1, state)[0].cpu().numpy()
            raise err
        raise ValueError("Phase one did not converge.")

    state = drive_out_artificials(A1, bt, state, n, cfg)

    basis = state.basis[0].cpu().numpy()
    art_pos = basis >= n
    dropped = np.array([], dtype=int)
    if art_pos.any():
        # an artificial still basic marks a linearly dependent row: drop
        # its own constraint row and its basis position
        dropped = np.sort(basis[art_pos] - n)
        keep_rows = np.ones(m, dtype=bool)
        keep_rows[dropped] = False
        A = A[keep_rows]
        b = b[keep_rows]
        basis = basis[~art_pos]
    return Phase1Result(
        basis=basis.astype(np.int32),
        A=A,
        b=b,
        iters=int(state.iters[0]),
        dropped_rows=dropped,
    )
