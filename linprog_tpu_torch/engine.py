"""Simplex state helpers (counterpart of the state half of :mod:`linprog_tpu.engine`).

The reference writes these per lane and lifts them with ``vmap``; here they
take the batch dimension explicitly.  A singular basis gives a status,
never an exception: inversions go through :func:`inv_or_nan` and
:func:`solve_or_nan`, which turn a nonzero LAPACK ``info`` into NaN factors
that the finite-lane guards downstream catch (``jnp.linalg.inv`` returns
non-finite values where ``torch.linalg.inv`` would raise).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import status as st


class SimplexState(NamedTuple):
    """Batched solver state: ``basis[B, m]`` i32 (column of A at each basis
    position), ``inv_B[B, m, m]`` (inverse of ``A[:, basis]``), ``bfs[B, m]``
    (basic values), ``iters[B]`` i32, ``status[B]`` i32."""

    basis: torch.Tensor
    inv_B: torch.Tensor
    bfs: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor


def inv_or_nan(M):
    """Batched inverse; lanes whose factorization fails come back NaN."""
    inv, info = torch.linalg.inv_ex(M)
    return torch.where((info != 0)[:, None, None], float("nan"), inv)


def solve_or_nan(M, rhs):
    """Batched ``M x = rhs`` for ``rhs[B, m]``; failed lanes come back NaN."""
    x, info = torch.linalg.solve_ex(M, rhs[:, :, None])
    return torch.where((info != 0)[:, None], float("nan"), x[:, :, 0])


def basis_matrix(A, basis):
    """``A[b, :, basis[b]]`` for each lane: ``[B, m, m]``."""
    B, m, _ = A.shape
    idx = basis.long()[:, None, :].expand(B, m, basis.shape[1])
    return torch.gather(A, 2, idx)


def in_basis_mask(basis, n: int):
    """bool ``[B, n]``: columns currently in each lane's basis."""
    mask = torch.zeros((basis.shape[0], n), dtype=torch.bool,
                       device=basis.device)
    return mask.scatter_(1, basis.long(), True)


def make_state(A, b, basis, status: int = st.RUNNING) -> SimplexState:
    """State from starting bases (one batched inversion); lanes whose basis
    matrix is singular start as ``NUMERICAL_ERROR``."""
    basis = basis.to(torch.int32)
    inv_B = inv_or_nan(basis_matrix(A, basis))
    bfs = torch.einsum("bmk,bk->bm", inv_B, b)
    ok = torch.isfinite(inv_B).all(dim=2).all(dim=1)
    B = A.shape[0]
    return SimplexState(
        basis=basis,
        inv_B=inv_B,
        bfs=bfs,
        iters=torch.zeros((B,), dtype=torch.int32, device=A.device),
        status=torch.where(ok, status, st.NUMERICAL_ERROR).to(torch.int32),
    )


def slack_crash_state(A, b, n: int) -> SimplexState:
    """Crash basis from the unit columns of ``A[:, :, :n]``.

    Row ``i`` takes a structural column whose only nonzero is a positive
    entry in row ``i`` (the first such), else the artificial ``n + i``.  The
    basis matrix is diagonal, so ``inv_B`` and ``bfs`` need no inversion.
    ``A`` is the Phase-I matrix ``[A_struct | I]``; requires ``b >= 0``.
    """
    B, m, _ = A.shape
    struct = A[:, :, :n]
    absv = torch.abs(struct)
    other_mass = absv.sum(dim=1)[:, None, :] - absv
    unit = (struct > 0) & (other_mass == 0.0)
    has_unit = unit.any(dim=2)
    unit_col = unit.to(torch.int8).argmax(dim=2)
    art = torch.arange(n, n + m, device=A.device).expand(B, m)
    basis = torch.where(has_unit, unit_col, art).to(torch.int32)
    piv = torch.gather(struct, 2, unit_col[:, :, None])[:, :, 0]
    pivot_vals = torch.where(has_unit, piv, torch.ones_like(b))
    inv_diag = 1.0 / pivot_vals
    return SimplexState(
        basis=basis,
        inv_B=torch.diag_embed(inv_diag),
        bfs=b * inv_diag,
        iters=torch.zeros((B,), dtype=torch.int32, device=A.device),
        status=torch.zeros((B,), dtype=torch.int32, device=A.device),
    )


def duals(c, state: SimplexState):
    """Simplex multipliers ``y = c_B inv_B`` per lane: ``[B, m]``."""
    cB = torch.gather(c, 1, state.basis.long())
    return torch.bmm(cB[:, None, :], state.inv_B)[:, 0]


def expand_bfs(state: SimplexState, n: int):
    """Scatter ``bfs`` into full-length ``x[B, n]``."""
    x = torch.zeros((state.bfs.shape[0], n), dtype=state.bfs.dtype,
                    device=state.bfs.device)
    return x.scatter_(1, state.basis.long(), state.bfs)
