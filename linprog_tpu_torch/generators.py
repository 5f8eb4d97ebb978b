"""Random LP instances (counterpart of :mod:`linprog_tpu.generators`).

Every instance is feasible and bounded by construction:
``h = G x0 + s0`` with ``x0, s0 >= 0`` and ``c = s - G' y0`` with
``y0, s >= 0``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def random_inequality_lps(
    batch: int,
    m: int,
    n: int,
    seed: int = 0,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host batch ``(c[B, n], G[B, m, n], h[B, m])`` of
    ``min c'x s.t. Gx <= h, x >= 0``; the same numbers as the reference's
    generator for the same seed."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal(size=(batch, m, n), dtype=np.float32).astype(dtype, copy=False)
    x0 = rng.random(size=(batch, n), dtype=np.float32).astype(dtype, copy=False)
    slack = rng.random(size=(batch, m), dtype=np.float32).astype(dtype, copy=False)
    h = np.einsum("bmn,bn->bm", G, x0) + slack

    y0 = rng.random(size=(batch, m), dtype=np.float32).astype(dtype, copy=False)
    s = 0.1 + 0.9 * rng.random(size=(batch, n), dtype=np.float32).astype(dtype, copy=False)
    c = s - np.einsum("bmn,bm->bn", G, y0)
    return c.astype(dtype, copy=False), G, h.astype(dtype, copy=False)


def to_standard_form_batch(c, G, h):
    """Host arrays: ``min c'x, Gx <= h`` -> ``[G | I] x = h`` with the rows
    of ``h < 0`` sign-flipped so that ``b >= 0`` (the numpy counterpart of
    :func:`device_standard_form_batch`)."""
    B, m, n = G.shape
    dtype = G.dtype
    eye = np.broadcast_to(np.eye(m, dtype=dtype), (B, m, m))
    A = np.concatenate([G, eye], axis=2).copy()
    b = h.copy()
    c_std = np.concatenate([c, np.zeros((B, m), dtype=dtype)], axis=1)
    neg = b < 0
    A[neg] *= -1
    b[neg] *= -1
    return c_std, A, b


def transportation_lps(
    batch: int,
    n_supply: int,
    n_demand: int,
    seed: int = 0,
    dtype=np.float32,
):
    """Host batch of balanced transportation problems (structured and
    degenerate): ``min sum c_ij x_ij  s.t.  sum_j x_ij = s_i,
    sum_i x_ij = d_j, x >= 0`` with ``sum s = sum d``; the same numbers as
    the reference's generator for the same seed.

    Returns ``(c[B, ns*nd], A[B, ns+nd, ns*nd], b[B, ns+nd])``.  One row is
    redundant (rank ns+nd-1): Phase I has to handle it.
    """
    rng = np.random.default_rng(seed)
    ns, nd = n_supply, n_demand
    n = ns * nd
    m = ns + nd
    # one incidence structure; costs, supplies and demands vary per lane
    A0 = np.zeros((m, n), dtype=dtype)
    for i in range(ns):
        A0[i, i * nd : (i + 1) * nd] = 1.0  # row sums = supply
    for j in range(nd):
        A0[ns + j, j::nd] = 1.0  # column sums = demand
    A = np.broadcast_to(A0, (batch, m, n)).copy()

    c = rng.uniform(1.0, 10.0, size=(batch, n)).astype(dtype)
    # integer supplies and demands: the balance sum(s) == sum(d) must hold
    # exactly, or every instance is infeasible at float64 tolerances
    s = rng.integers(2, 10, size=(batch, ns)).astype(np.int64)
    d = np.empty((batch, nd), dtype=np.int64)
    for k in range(batch):
        total = int(s[k].sum())
        d[k] = 1 + rng.multinomial(total - nd, np.full(nd, 1.0 / nd))
    b = np.concatenate([s, d], axis=1).astype(dtype)
    return c, A, b


def device_inequality_lps(gen: torch.Generator, batch: int, m: int, n: int,
                          device):
    """The same construction made on ``device`` from the generator ``gen``
    (which must live on that device); only the seed crosses to the card."""
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    G = torch.randn((batch, m, n), **kw)
    x0 = torch.rand((batch, n), **kw)
    slack = torch.rand((batch, m), **kw)
    h = torch.einsum("bmn,bn->bm", G, x0) + slack
    y0 = torch.rand((batch, m), **kw)
    s = 0.1 + 0.9 * torch.rand((batch, n), **kw)
    c = s - torch.einsum("bmn,bm->bn", G, y0)
    return c, G, h


def device_bounded_lps(gen: torch.Generator, batch: int, m: int, n: int,
                       device, ub_hi: float = 2.0):
    """Batch of bounded-variable LPs with a known feasible start, made on
    ``device`` from the generator ``gen`` (which must live there).

    ``min c'z  s.t.  [G' | I] z = b,  0 <= x <= ub (in [0.5, ub_hi)),
    0 <= s < inf`` where ``G'`` is row-sign-fixed so that ``b >= 0``: the
    all-slack basis with every structural variable at its lower bound is
    feasible (``bfs = b``), and the feasible region is compact, so every
    instance is bounded.

    Returns ``(c[B, n+m], A[B, m, n+m], b[B, m], lb[B, n+m], ub[B, n+m])``.
    """
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    G = torch.randn((batch, m, n), **kw)
    x0 = torch.rand((batch, n), **kw)
    slack = torch.rand((batch, m), **kw)
    h = torch.einsum("bmn,bn->bm", G, x0) + slack
    Gf = torch.where((h < 0)[:, :, None], -G, G)
    b = torch.abs(h)
    eye = torch.eye(m, dtype=torch.float32, device=device).expand(batch, m, m)
    A = torch.cat([Gf, eye], dim=2)
    zeros = torch.zeros((batch, m), dtype=torch.float32, device=device)
    c = torch.cat([2.0 * torch.rand((batch, n), **kw) - 1.0, zeros], dim=1)
    ubx = 0.5 + (ub_hi - 0.5) * torch.rand((batch, n), **kw)
    lb = torch.zeros((batch, n + m), dtype=torch.float32, device=device)
    ub = torch.cat([ubx, torch.full_like(zeros, float("inf"))], dim=1)
    return c, A, b, lb, ub


def device_standard_form_batch(c, G, h):
    """``min c'x, Gx <= h`` -> ``[G | I] x = h`` with rows of ``h < 0``
    sign-flipped so that ``b >= 0``."""
    B, m, n = G.shape
    eye = torch.eye(m, dtype=G.dtype, device=G.device).expand(B, m, m)
    A = torch.cat([G, eye], dim=2)
    neg = (h < 0)[:, :, None]
    A = torch.where(neg, -A, A)
    b = torch.abs(h)
    c_std = torch.cat([c, torch.zeros((B, m), dtype=G.dtype, device=G.device)],
                      dim=1)
    return c_std, A, b


def random_sparse_pattern(m: int, n: int, density: float, seed: int = 0):
    """Host COO pattern ``(rows, cols)`` (int32) with ~``density`` fill and
    at least one entry in every row and every column; the same arrays as
    the reference's generator for the same seed."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    empty_rows = np.flatnonzero(~mask.any(axis=1))
    mask[empty_rows, rng.integers(0, n, size=empty_rows.size)] = True
    empty_cols = np.flatnonzero(~mask.any(axis=0))
    mask[rng.integers(0, m, size=empty_cols.size), empty_cols] = True
    rows, cols = np.nonzero(mask)
    return rows.astype(np.int32), cols.astype(np.int32)


def random_sparse_inequality_lps(batch: int, m: int, n: int,
                                 density: float = 0.01, seed: int = 0,
                                 dtype=np.float32):
    """Host batch of feasible, bounded sparse canonical LPs on one shared
    pattern, by the construction of :func:`random_inequality_lps`:
    ``(c[B, n], rows[nnz], cols[nnz], vals[B, nnz], h[B, m])``, the same
    arrays as the reference's generator for the same seed."""
    rng = np.random.default_rng(seed + 1)
    rows, cols = random_sparse_pattern(m, n, density, seed)
    nnz = rows.shape[0]
    vals = rng.standard_normal((batch, nnz)).astype(dtype)
    x0 = rng.random((batch, n)).astype(dtype)
    slack = rng.random((batch, m)).astype(dtype)
    h = np.zeros((batch, m), dtype)
    np.add.at(h.T, rows, (vals * x0[:, cols]).T)
    h += slack
    y0 = rng.random((batch, m)).astype(dtype)
    s = (0.1 + 0.9 * rng.random((batch, n))).astype(dtype)
    gty = np.zeros((batch, n), dtype)
    np.add.at(gty.T, cols, (vals * y0[:, rows]).T)
    c = s - gty
    return c, rows, cols, vals, h


def device_sparse_inequality_lps(gen: torch.Generator, batch: int, rows,
                                 cols, m: int, n: int, device):
    """The sparse construction made on ``device`` from the generator
    ``gen`` (which must live there) on the host pattern ``rows/cols``:
    ``(c[B, n], vals[B, nnz], h[B, m])``.  The sums over each row and
    column are gathers over the pattern's padded slot tables, so the same
    generator state gives the same bits on every run."""
    from .ipm_sparse import SharedTables

    kw = dict(generator=gen, device=device, dtype=torch.float32)
    tab = SharedTables(rows, cols, m, n, device)
    nnz = tab.nnz
    vals = torch.randn((batch, nnz), **kw)
    x0 = torch.rand((batch, n), **kw)
    slack = torch.rand((batch, m), **kw)
    Vr, Vc = tab.value_tables(vals)
    h = tab.gx(Vr, x0) + slack
    y0 = torch.rand((batch, m), **kw)
    s = 0.1 + 0.9 * torch.rand((batch, n), **kw)
    c = s - tab.gty(Vc, y0)
    return c, vals, h
