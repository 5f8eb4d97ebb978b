"""The comparison that decides ``correct``.

Each sampled answer of the program is judged by what it says, with the
reference's answer to the same LP beside it.  The numbers compared, each
against its cell's limit (``lpbench/workloads/<cell>.json``):

* ``status_mismatch`` -- answers whose outcome (optimal, infeasible,
  unbounded, or none: an iteration limit or a numerical failure) differs
  from the reference's;
* ``ref_unsolved`` -- sampled LPs the reference itself left without an
  answer (none is expected: the reference is float64);
* ``cost_gap`` -- the widest ``|cost - cost_ref| / max(1, |cost_ref|)``
  over the answers optimal on both sides: the optimum's value;
* ``infeasibility`` -- the widest violation, in float64, of ``A x = b``
  and of the bounds by the program's optimal ``x`` (implied slacks
  included where ``x`` holds the structural columns only), over ``max(1,
  max |b|, max |x|)``: the point is feasible;
* ``basis_gap`` -- the widest distance of the program's optimal ``x`` from
  the vertex of the basis it returned (``B x_B = b - A_N x_N`` solved in
  float64, every nonbasic variable at a bound), over ``max(1, max |x|)``:
  the point is that basis's vertex.

Optimal in value, feasible and a vertex: the answer is an optimal vertex
with its basis.  The reference's own vertex is not compared: on an LP with
two vertices whose costs lie within float32's reach of each other, a
float32 solver may rightly stop at either (``x_gap`` and
``basis_mismatch``, reported beside the compared numbers, count them).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

from .simplex import NO_ANSWER, OPTIMAL

NAMES = ("status_mismatch", "ref_unsolved", "cost_gap", "infeasibility",
         "basis_gap")
SEEN = ("x_gap", "basis_mismatch", "tie_cost_gap")


class Answers(NamedTuple):
    """One side's answers to the sampled LPs: ``outcome`` (list of class
    names), ``x[S, k]`` (the first ``k`` columns), ``cost[S]``,
    ``basis[S, m]`` (sorted column indices; ``>= n`` an artificial of its
    row, at zero), ``at_ub[S, k]`` (bool) or None."""

    outcome: List[str]
    x: torch.Tensor
    cost: torch.Tensor
    basis: torch.Tensor
    at_ub: Optional[torch.Tensor]


def _finite_max(t: torch.Tensor) -> float:
    if t.numel() == 0:
        return 0.0
    t = torch.where(torch.isnan(t), torch.full_like(t, math.inf), t)
    return float(t.max())


def point_checks(prob, x, basis):
    """Per lane: the infeasibility of ``x`` and its distance from the
    vertex of ``basis`` (see the module docstring), float64 on the
    problem's device."""
    A, b, lb, ub = prob.A, prob.b, prob.lb, prob.ub
    S, m, n = A.shape
    k = x.shape[1]
    x = x.to(A.device, torch.float64)
    full = torch.zeros((S, n), dtype=torch.float64, device=A.device)
    full[:, :k] = x
    if k < n:  # implied slacks: columns k.. are the rows' +-e_i
        rows = torch.arange(n - k, device=A.device)
        diag = A[:, rows, k + rows]
        full[:, k:] = (b - torch.einsum("bmk,bk->bm", A[:, :, :k], x)) / diag
    scale = torch.maximum(b.abs().amax(dim=1), full.abs().amax(dim=1))
    scale = scale.clamp_min(1.0)
    resid = (torch.einsum("bmn,bn->bm", A, full) - b).abs().amax(dim=1)
    below = (lb - full).clamp_min(0.0).amax(dim=1)
    above = (full - ub).clamp_min(0.0).amax(dim=1)
    infeas = torch.maximum(resid, torch.maximum(below, above)) / scale

    # the vertex of the returned basis, nonbasic variables at their values
    # (column n + i of the extended matrix is row i's artificial)
    basis = basis.to(A.device).long()
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(S, m, m)
    Bm = torch.gather(torch.cat([A, eye], dim=2), 2,
                      basis[:, None, :].expand(S, m, m))
    nonbasic = torch.ones((S, n + m), dtype=torch.bool, device=A.device)
    nonbasic.scatter_(1, basis, False)
    nonbasic = nonbasic[:, :n]
    x_n = torch.where(nonbasic, full, 0.0)
    xB, info = torch.linalg.solve_ex(
        Bm, b - torch.einsum("bmn,bn->bm", A, x_n))
    vertex = torch.cat([x_n, torch.zeros((S, m), dtype=x_n.dtype,
                                         device=A.device)], dim=1)
    vertex.scatter_(1, basis, xB)
    at_bound = torch.minimum((x_n - lb).abs(), (x_n - ub).abs())
    at_bound = torch.where(nonbasic, at_bound, 0.0)
    off = torch.maximum((vertex[:, :n] - full).abs().amax(dim=1),
                        vertex[:, n:].abs().amax(dim=1))
    off = torch.maximum(off, at_bound.amax(dim=1))
    off = torch.where(info == 0, off, math.inf)
    vscale = full.abs().amax(dim=1).clamp_min(1.0)
    return infeas.cpu(), (off / vscale).cpu()


def compare(got: Answers, ref: Answers, prob) -> Dict[str, float]:
    """The compared numbers of ``got`` against ``ref`` (same lanes, same
    order) on the problems ``prob``; then the numbers only reported."""
    solved = [r != NO_ANSWER for r in ref.outcome]
    mismatch = sum(1 for g, r, s in zip(got.outcome, ref.outcome, solved)
                   if s and g != r)
    mine = torch.tensor([g == OPTIMAL for g in got.outcome],
                        dtype=torch.bool)
    both = mine & torch.tensor([r == OPTIMAL for r in ref.outcome],
                               dtype=torch.bool)
    c_g, c_r = got.cost.double().cpu()[both], ref.cost.double().cpu()[both]
    cost_gap = (c_g - c_r).abs() / c_r.abs().clamp_min(1.0)
    infeas, off = point_checks(prob, got.x.double(), got.basis)

    x_g, x_r = got.x.double().cpu()[both], ref.x.double().cpu()[both]
    x_scale = x_r.abs().amax(dim=1).clamp_min(1.0) if x_r.numel() else x_r
    x_gap = ((x_g - x_r).abs().amax(dim=1) / x_scale if x_r.numel()
             else x_r)
    differs = (got.basis.cpu()[both] != ref.basis.cpu()[both]).any(dim=1)
    if got.at_ub is not None and ref.at_ub is not None:
        differs |= (got.at_ub.cpu()[both] != ref.at_ub.cpu()[both]).any(
            dim=1)
    return {
        "status_mismatch": float(mismatch),
        "ref_unsolved": float(len(solved) - sum(solved)),
        "cost_gap": _finite_max(cost_gap),
        "infeasibility": _finite_max(infeas[mine]),
        "basis_gap": _finite_max(off[mine]),
        "x_gap": _finite_max(x_gap),
        "basis_mismatch": float(differs.sum()),
        "tie_cost_gap": _finite_max(cost_gap[differs]),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """``correct``: every compared number within its limit."""
    return all(numbers[k] <= limits[k] for k in NAMES)
