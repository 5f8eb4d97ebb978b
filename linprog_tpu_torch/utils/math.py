"""Ratio-test divisions and the big-M bound (counterpart of
:mod:`linprog_tpu.utils.math`), on tensors.

The masked divisions are single ``torch.where`` expressions.  The
Papadimitriou-Steiglitz bound is computed in log space so that it cannot
overflow: ``m! alpha^(m-1) beta`` leaves float64 at m ~ 170 and float32 at
m ~ 10.
"""

from __future__ import annotations

import math

import torch


def _tensor(x):
    """``x`` as a tensor (float arrays keep their width)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def primal_simplex_div(numer, denom, pivot_tol: float = 0.0):
    """Elementwise ``numer / denom`` where ``denom > pivot_tol``, else
    ``+inf``: the primal ratio test."""
    numer, denom = _tensor(numer), _tensor(denom)
    mask = denom > pivot_tol
    safe = torch.where(mask, denom, torch.ones_like(denom))
    return torch.where(mask, numer / safe, float("inf"))


def dual_simplex_div(numer, denom, pivot_tol: float = 0.0):
    """Elementwise ``-numer / denom`` where ``denom < -pivot_tol``, else
    ``+inf``: the dual ratio test."""
    numer, denom = _tensor(numer), _tensor(denom)
    mask = denom < -pivot_tol
    safe = torch.where(mask, denom, -torch.ones_like(denom))
    return torch.where(mask, -numer / safe, float("inf"))


def get_bounds_on_bfs(A, b, cap: float | None = None):
    """Bound on ``|x_i|`` over all basic feasible solutions of one instance
    ``A[m, n], b[m]``, or of each lane of ``A[B, m, n], b[B, m]`` (Lemma
    2.1 of Papadimitriou & Steiglitz): ``M = m! alpha^(m-1) beta`` with
    ``alpha = max|A_ij|``, ``beta = max|b_i|``, computed as
    ``exp(lgamma(m+1) + (m-1) log alpha + log beta)`` and clamped to ``cap``
    (1e30 in float64, 1e7 otherwise).  ``beta == 0`` gives 0."""
    A, b = _tensor(A), _tensor(b)
    m = A.shape[-2]
    if cap is None:
        cap = 1e30 if A.dtype == torch.float64 else 1e7
    tiny = torch.finfo(A.dtype).tiny
    alpha = torch.abs(A).amax(dim=(-2, -1))
    beta = torch.abs(b).amax(dim=-1).to(A.dtype)
    log_alpha = torch.log(torch.clamp_min(alpha, tiny))
    log_beta = torch.log(torch.clamp_min(beta, tiny))
    log_m_fact = torch.lgamma(torch.tensor(float(m + 1), dtype=torch.float32,
                                           device=A.device)).to(A.dtype)
    log_M = log_m_fact + (m - 1) * log_alpha + log_beta
    M = torch.exp(torch.clamp_max(log_M, math.log(cap)))
    return torch.where(beta == 0, torch.zeros_like(M), M)
