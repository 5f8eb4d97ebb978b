"""Ruiz equilibration (counterpart of :mod:`linprog_tpu.presolve`).

    repeat k times:
        r_i <- 1 / sqrt(max_j |A_ij|)        (row scales)
        s_j <- 1 / sqrt(max_i |A_ij|)        (column scales)
        A <- diag(r) A diag(s)

drives every row and column inf-norm towards 1.  The scaled problem
``min (S c)' z  s.t. (R A S) z = R b, z >= 0`` maps back by ``x = S z``
(positive scales keep ``z >= 0`` equivalent) and ``y = R y_scaled``.
Elementwise operations and reductions only; leading batch dimensions pass
through.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Scaling(NamedTuple):
    """``row[.., m]`` (R) and ``col[.., n]`` (S)."""

    row: torch.Tensor
    col: torch.Tensor


def ruiz_equilibrate(c, A, b, iters: int = 6):
    """Equilibrate one instance, or a batch through leading dimensions.
    Returns ``(c_s, A_s, b_s, Scaling)``."""
    row = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    col = torch.ones(A.shape[:-2] + A.shape[-1:], dtype=A.dtype,
                     device=A.device)
    A_s = A
    for _ in range(iters):
        r = 1.0 / torch.sqrt(torch.clamp_min(
            torch.abs(A_s).amax(dim=-1), 1e-12))
        A_s = A_s * r[..., :, None]
        s = 1.0 / torch.sqrt(torch.clamp_min(
            torch.abs(A_s).amax(dim=-2), 1e-12))
        A_s = A_s * s[..., None, :]
        row, col = row * r, col * s
    return c * col, A_s, b * row, Scaling(row=row, col=col)


def unscale_solution(x, scaling: Scaling):
    """Primal solution of the original problem: ``x = S z``."""
    return x * scaling.col


def unscale_duals(y, scaling: Scaling):
    """Duals of the original problem: ``y = R y_scaled``."""
    return y * scaling.row
