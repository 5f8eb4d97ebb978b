"""Problem canonicalization (counterpart of :mod:`linprog_tpu.forms`).

Host-side NumPy code, the same functions with the same results:

* ``preprocess_problem`` -- dtype cast and row sign-fix so that ``b >= 0``;
* ``canonical_to_standard`` -- a slack identity block turns ``Gx <= h``
  into ``Ax = b``;
* ``bounds_to_rows`` -- finite ``lb <= x <= ub`` as extra rows
  ``x_i -/+ s = bnd``, built in one vectorized shot;
* ``general_to_standard`` -- equality and inequality blocks combined;
* ``pad_problem`` -- padding to a common static shape for the batched path.

Shapes are decided here, on the host; the arrays go to the device as they
are (``torch.as_tensor``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _as2d(x, dtype) -> np.ndarray:
    return np.atleast_2d(np.asarray(x, dtype=dtype))


def preprocess_problem(c, A, b, dtype=np.float32):
    """Cast to ``dtype`` and flip rows where ``b < 0`` so ``b >= 0``."""
    c = np.asarray(c, dtype=dtype).copy()
    A = _as2d(A, dtype).copy()
    b = np.asarray(b, dtype=dtype).copy()
    neg = b < 0
    A[neg] *= -1
    b[neg] *= -1
    return c, A, b


def canonical_to_standard(c, G, h, dtype=np.float32):
    """``min c'x  s.t. Gx <= h``  ->  standard form via slack identity block."""
    c = np.asarray(c, dtype=dtype)
    G = _as2d(G, dtype)
    h = np.asarray(h, dtype=dtype)
    m = h.shape[0]
    A = np.concatenate([G, np.eye(m, dtype=dtype)], axis=1)
    c = np.concatenate([c, np.zeros(m, dtype=dtype)])
    return preprocess_problem(c, A, h, dtype)


def bounds_to_rows(c, A, b, lb=None, ub=None, dtype=np.float32):
    """Fold ``lb <= x <= ub`` into extra equality rows of ``A``.

    Adds ``x_i - s = lb_i`` for every finite ``lb_i`` not close to 0, then
    ``x_i + s = ub_i`` for every finite ``ub_i``.  Non-finite lower bounds
    are skipped (the variable keeps the implicit ``x >= 0`` of standard
    form).
    """
    c = np.asarray(c, dtype=dtype)
    A = _as2d(A, dtype)
    b = np.asarray(b, dtype=dtype)
    m, n = A.shape

    if lb is None:
        lb = np.zeros(n, dtype=dtype)
    else:
        lb = np.asarray(lb, dtype=dtype)
    if ub is None:
        ub = np.full(n, np.inf, dtype=dtype)
    else:
        ub = np.asarray(ub, dtype=dtype)

    # exact comparison: lb = 1e-9 is a real constraint, not 0 (the old
    # isclose() treated it as free and silently shifted the optimum)
    lb_idx = np.flatnonzero((lb != 0.0) & np.isfinite(lb))
    ub_idx = np.flatnonzero(np.isfinite(ub))
    k1, k2 = lb_idx.size, ub_idx.size
    k = k1 + k2

    A2 = np.zeros((m + k, n + k), dtype=dtype)
    A2[:m, :n] = A
    rows = m + np.arange(k)
    A2[rows, np.concatenate([lb_idx, ub_idx]).astype(int)] = 1.0
    A2[rows, n + np.arange(k)] = np.concatenate(
        [-np.ones(k1, dtype=dtype), np.ones(k2, dtype=dtype)]
    )
    b2 = np.concatenate([b, lb[lb_idx], ub[ub_idx]])
    c2 = np.concatenate([c, np.zeros(k, dtype=dtype)])
    return preprocess_problem(c2, A2, b2, dtype)


def general_to_standard(
    c,
    A=None,
    b=None,
    G=None,
    h=None,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Combine equality (``Ax = b``) and inequality (``Gx <= h``) blocks.

    Returns ``(c_std, A_std, b_std, num_slack)``; any of the three input
    combinations (equalities, inequalities, both) works.
    """
    has_eq = A is not None and b is not None
    has_ineq = G is not None and h is not None
    if not has_eq and not has_ineq:
        raise ValueError("Input polyhedron misspecified: need (A, b) and/or (G, h).")

    c = np.asarray(c, dtype=dtype)
    n = c.shape[0]
    num_slack = 0 if G is None else _as2d(G, dtype).shape[0]

    blocks_A = []
    blocks_b = []
    if has_eq:
        Ae = _as2d(A, dtype)
        if Ae.shape[1] != n:
            raise ValueError(f"A has {Ae.shape[1]} columns, c has {n} entries")
        blocks_A.append(
            np.concatenate([Ae, np.zeros((Ae.shape[0], num_slack), dtype=dtype)], axis=1)
        )
        blocks_b.append(np.asarray(b, dtype=dtype))
    if has_ineq:
        Gi = _as2d(G, dtype)
        if Gi.shape[1] != n:
            raise ValueError(f"G has {Gi.shape[1]} columns, c has {n} entries")
        blocks_A.append(
            np.concatenate([Gi, np.eye(num_slack, dtype=dtype)], axis=1)
        )
        blocks_b.append(np.asarray(h, dtype=dtype))

    A_std = np.concatenate(blocks_A, axis=0)
    b_std = np.concatenate(blocks_b)
    c_std = np.concatenate([c, np.zeros(num_slack, dtype=dtype)])
    c_std, A_std, b_std = preprocess_problem(c_std, A_std, b_std, dtype)
    return c_std, A_std, b_std, num_slack


def pad_problem(c, A, b, m_pad: int, n_pad: int, dtype=np.float32):
    """Pad ``(c, A, b)`` to static shape ``(m_pad, n_pad)``.

    Padding rows are ``s_i = 0`` identities on fresh padding columns; padding
    columns get zero cost, so the padded LP has the same optima.  Used by the
    batched path to give heterogeneous instances one compiled shape.

    Returns ``(c_pad, A_pad, b_pad, row_mask, col_mask)``.
    """
    c = np.asarray(c, dtype=dtype)
    A = _as2d(A, dtype)
    b = np.asarray(b, dtype=dtype)
    m, n = A.shape
    extra_rows = m_pad - m
    extra_cols = n_pad - n
    if extra_rows < 0 or extra_cols < extra_rows:
        raise ValueError(
            f"cannot pad ({m},{n}) to ({m_pad},{n_pad}): need n_pad-n >= m_pad-m >= 0"
        )
    A_pad = np.zeros((m_pad, n_pad), dtype=dtype)
    A_pad[:m, :n] = A
    # identity on the first `extra_rows` padding columns
    A_pad[m:, n : n + extra_rows] = np.eye(extra_rows, dtype=dtype)
    b_pad = np.concatenate([b, np.zeros(extra_rows, dtype=dtype)])
    c_pad = np.concatenate([c, np.zeros(extra_cols, dtype=dtype)])
    row_mask = np.arange(m_pad) < m
    col_mask = np.arange(n_pad) < n
    return c_pad, A_pad, b_pad, row_mask, col_mask
