"""Sensitivity analysis (cost and right-hand-side ranging) at an optimal
basis (counterpart of :mod:`linprog_tpu.ranging`).

Given the terminal state of a standard-form solve ``min c'x s.t. Ax = b,
x >= 0``, every cost coefficient and every rhs entry gets the interval
over which it can move while the current basis stays optimal:

* nonbasic cost ``c_j``: the reduced cost ``r_j >= 0`` must stay
  nonnegative, so ``delta in [-r_j, +inf)``;
* basic cost ``c_{B(i)}``: the nonbasic reduced costs move by
  ``-delta W[i, j]`` with ``W = inv_B A``; keeping them nonnegative bounds
  ``delta`` by ratios over the sign of ``W[i, j]``;
* rhs ``b_i``: the basic values move along column ``i`` of ``inv_B``;
  keeping ``x_B + delta inv_B[:, i] >= 0`` bounds ``delta`` by ratios over
  the sign of ``inv_B[k, i]``.

At a degenerate vertex the intervals are those of this basis.  The batch
dimension is explicit: :func:`ranging_batch` is the computation, a few
batched contractions on the state the engine carries; :func:`ranging` is
one instance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .engine import SimplexState, in_basis_mask, reduced_costs


class RangingResult(NamedTuple):
    """``cost_lo``/``cost_hi`` ``[n]`` (``[B, n]``): ``c_j`` may move within
    ``[cost_lo_j, cost_hi_j]`` without changing the optimal basis;
    ``rhs_lo``/``rhs_hi`` ``[m]`` (``[B, m]``): the same for ``b_i``."""

    cost_lo: torch.Tensor
    cost_hi: torch.Tensor
    rhs_lo: torch.Tensor
    rhs_hi: torch.Tensor


def _ranging_lanes(c, A, b, states: SimplexState, nonneg_tol: float
                   ) -> RangingResult:
    inf = float("inf")
    B, m, n = A.shape
    r = reduced_costs(c, A, states)  # basis entries exactly 0
    in_basis = in_basis_mask(states.basis, n)
    basis = states.basis.long()

    # nonbasic costs: delta in [-r_j, inf)
    cost_lo = torch.where(in_basis, -inf, c - (torch.clamp_min(r, 0.0) + 0.0))
    cost_hi = torch.full_like(c, inf)

    # basic costs: ratios over the tableau rows W = inv_B A
    W = torch.matmul(states.inv_B, A)  # [B, m, n]
    Wn = torch.where(in_basis[:, None, :], 0.0, W)  # nonbasic columns only
    rn = torch.where(in_basis, inf, torch.clamp_min(r, nonneg_tol) + 0.0)
    pos = Wn > 1e-9
    neg = Wn < -1e-9
    # delta <= min over {j : W[i, j] > 0} of r_j / W[i, j]
    up = torch.where(pos, rn[:, None, :] / torch.where(pos, Wn, 1.0),
                     inf).amin(dim=2)
    # delta >= max over {j : W[i, j] < 0} of r_j / W[i, j]
    dn = torch.where(neg, rn[:, None, :] / torch.where(neg, Wn, 1.0),
                     -inf).amax(dim=2)
    cB = torch.gather(c, 1, basis)
    cost_lo = cost_lo.scatter(1, basis, cB + dn)
    cost_hi = cost_hi.scatter(1, basis, cB + up)

    # rhs: ratios over the columns of inv_B (inv_B[k, i] is the effect of
    # b_i on x_{B(k)}); x_B + delta inv_B[:, i] >= 0
    xB = (torch.clamp_min(states.bfs, 0.0) + 0.0)[:, :, None]
    col = states.inv_B
    posb = col > 1e-9
    negb = col < -1e-9
    up_b = torch.where(negb, xB / torch.where(negb, -col, 1.0),
                       inf).amin(dim=1)
    dn_b = torch.where(posb, -xB / torch.where(posb, col, 1.0),
                       -inf).amax(dim=1)
    return RangingResult(cost_lo=cost_lo, cost_hi=cost_hi,
                         rhs_lo=b + dn_b, rhs_hi=b + up_b)


def ranging(c, A, b, state: SimplexState,
            nonneg_tol: float = 0.0) -> RangingResult:
    """Cost and rhs ranging of one instance: ``c[n], A[m, n], b[m]`` and
    its state (``basis[m]``, ``inv_B[m, m]``, ``bfs[m]``, as a solver
    class's ``state`` gives it)."""
    states = SimplexState(*(torch.as_tensor(t)[None] for t in state))
    out = _ranging_lanes(c[None], A[None], b[None], states, nonneg_tol)
    return RangingResult(*(t[0] for t in out))


def ranging_batch(c, A, b, states: SimplexState) -> RangingResult:
    """Ranging of every lane: ``c[B, n], A[B, m, n], b[B, m]`` and the
    batched state."""
    return _ranging_lanes(c, A, b, states, 0.0)
