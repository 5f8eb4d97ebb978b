"""Double-word (split-float) terminal polish (counterpart of
:mod:`linprog_tpu.refine`).

f32 pricing inherits the basis inverse's error, so a solve can stop at a
near-optimal vertex it cannot tell from the optimum.  This module reprices
in double-word arithmetic: Dekker-split products (exact in f32), chunked
compensated sums, iterative refinement of duals and basic values, and a few
dd-guided cleanup pivots.

Ported faithfully in f32.  On CPU tensors every elementwise step is its
own eager op (the plain version): a fused multiply-add (``addcmul``,
``addmm``/``baddbmm``, ``lerp``, or a compiler free to contract) would round
differently and break the error-free transformations, and TF32 matmuls
would break the exact split products.  On float32 CUDA tensors the split
products and compensated sums run in one hand-written kernel a call
(:mod:`linprog_tpu_torch.ops.dd_kernel`), built without FMA contraction:
each output is the same sequence of f32 roundings, so it equals the plain
version's in every bit.  ``dd_rowmat``'s four einsums stay matmuls (their
order is cuBLAS's) and only their compensated sum goes to the kernel.
"""

from __future__ import annotations

import torch

from .calibration import get_table
from .engine import basis_matrix, in_basis_mask, inv_or_nan, solve_or_nan
from .observability import current, host_read, spanned
from .ops import dd_kernel


def _split(x):
    """Dekker split ``x = hi + lo`` (hi: top 12 mantissa bits in f32), so
    products of two halves are exact."""
    c = 4097.0 if x.dtype == torch.float32 else float(1 << 27) + 1.0
    t = x * c
    hi = t - (t - x)
    return hi, x - hi


def _on_card(*ts) -> bool:
    """Whether the double-word kernel takes these tensors: float32 on a
    CUDA device (the plain version serves every other case, float64
    included)."""
    return all(t.is_cuda and t.dtype == torch.float32 for t in ts)


def _kahan_sum_chunks(P):
    """Compensated (Sum2) sum of ``P[B, K, n]`` over K -> ``[B, n]``."""
    K = P.shape[1]
    s = P[:, 0]
    comp = torch.zeros_like(s)
    for k in range(1, K):
        x = P[:, k]
        t = s + x
        z = t - s
        comp = comp + ((s - (t - z)) + (x - z))
        s = t
    return s + comp


def _pad_rows(y, M, chunk: int):
    B, m, n = M.shape
    pad = (-m) % chunk
    if pad:
        y = torch.nn.functional.pad(y, (0, pad))
        M = torch.nn.functional.pad(M, (0, 0, 0, pad))
    return y, M


def dd_rowmat(y, M, chunk: int = 8):
    """High-accuracy ``y[B, m] @ M[B, m, n] -> [B, n]``: split products,
    chunk-of-``chunk`` partial sums, compensated sum over chunks."""
    y, M = _pad_rows(y, M, chunk)
    B, m, n = M.shape
    K = m // chunk
    yh, yl = _split(y)
    Mh, Ml = _split(M)

    def part(u, V):
        return torch.einsum("bkc,bkcn->bkn", u.reshape(B, K, chunk),
                            V.reshape(B, K, chunk, n))

    P = (part(yh, Mh) + part(yh, Ml)) + part(yl, Mh)
    P = P + part(yl, Ml)
    if _on_card(P):
        return dd_kernel.kahan_sum(P)
    return _kahan_sum_chunks(P)


def _dd_chunk_products(y, M, chunk: int):
    """Per-chunk double-float partial sums ``(s, e)`` of ``y @ M``, each
    ``[B, K, n]`` with ``sum == s + e`` to ~eps^2 (TwoProd + TwoSum)."""
    y, M = _pad_rows(y, M, chunk)
    B, m, n = M.shape
    K = m // chunk
    yh, yl = _split(y)
    Mh, Ml = _split(M)
    yr = y.reshape(B, K, chunk)
    yhr = yh.reshape(B, K, chunk)
    ylr = yl.reshape(B, K, chunk)
    Mr = M.reshape(B, K, chunk, n)
    Mhr = Mh.reshape(B, K, chunk, n)
    Mlr = Ml.reshape(B, K, chunk, n)

    s = torch.zeros((B, K, n), dtype=M.dtype, device=M.device)
    e = torch.zeros_like(s)
    for c in range(chunk):
        yc = yr[:, :, c, None]
        yhc = yhr[:, :, c, None]
        ylc = ylr[:, :, c, None]
        p = yc * Mr[:, :, c, :]
        # TwoProd: exact rounding error of p from the 12-bit splits
        pe = yhc * Mhr[:, :, c, :] - p
        pe = pe + yhc * Mlr[:, :, c, :]
        pe = pe + ylc * Mhr[:, :, c, :]
        pe = pe + ylc * Mlr[:, :, c, :]
        # TwoSum(s, p)
        t = s + p
        z = t - s
        err = (s - (t - z)) + (p - z)
        s = t
        e = e + (pe + err)
    return s, e


def dd_rowmat_dd(y, M, chunk: int = 8):
    """Double-float ``y[B, m] @ M[B, m, n] -> [B, n]``."""
    if _on_card(y, M):
        return dd_kernel.chunk_products_sum(None, y, M, chunk)
    s, e = _dd_chunk_products(y, M, chunk)
    return _kahan_sum_chunks(torch.cat([s, e], dim=1))


def dd_residual_rowmat(bvec, y, M, chunk: int = 8):
    """Double-float residual ``bvec[B, n] - y[B, m] @ M[B, m, n]`` with
    ``bvec`` folded into the compensated chain."""
    if _on_card(bvec, y, M):
        return dd_kernel.chunk_products_sum(bvec, y, M, chunk)
    s, e = _dd_chunk_products(y, M, chunk)
    return _kahan_sum_chunks(torch.cat([bvec[:, None, :], -s, -e], dim=1))


def dd_residual(bvec, M, x, chunk: int = 8):
    """Double-float residual ``bvec[B, m] - M[B, m, k] @ x[B, k]``."""
    return dd_residual_rowmat(bvec, x, M.transpose(1, 2), chunk=chunk)


def dd_matvec(M, x, chunk: int = 8):
    """Double-float ``M[B, m, k] @ x[B, k] -> [B, m]``."""
    return dd_rowmat_dd(x, M.transpose(1, 2), chunk=chunk)


def dd_dot(u, v, chunk: int = 8):
    """High-accuracy per-lane dot ``sum(u * v)`` for ``u, v [B, m]``."""
    return dd_rowmat(u, v[:, :, None], chunk=chunk)[:, 0]


def refine_duals(cB, Bmat, inv_B, steps: int = 2):
    """Iteratively refined duals ``y`` with ``y B = c_B`` (dd residual)."""
    y = torch.einsum("bm,bmk->bk", cB, inv_B)
    for _ in range(steps):
        s = dd_residual_rowmat(cB, y, Bmat)
        y = y + torch.einsum("bm,bmk->bk", s, inv_B)
    return y


def refine_bfs(Bmat, b, inv_B, xB, steps: int = 2):
    """Iteratively refined ``x_B`` with ``B x_B = b`` (dd residual)."""
    for _ in range(steps):
        r = dd_residual(b, Bmat, xB)
        xB = xB + torch.einsum("bmk,bk->bm", inv_B, r)
    return xB


def dd_steps(m: int) -> int:
    """dd-refinement rounds that :func:`solve_dd` spends at size ``m``.

    A plain f32 solve is off by about cond(B) eps relative.  Up to the
    whole-segment kernel's boundary (``xover_pallas_max_m``) that stays
    inside the certificate's 1e-5 (1,024 of 1,024 lanes certified at
    m = 256 on the card); past it, it does not (57 of 64 at m = 2048, 63 of
    64 with one round), and one round costs ~15 % of the m = 256 wall.
    """
    return 0 if m <= get_table()["xover_pallas_max_m"] else 1


def solve_dd(M, rhs, inv_M=None):
    """``M x = rhs`` with :func:`dd_steps` rounds of dd-residual refinement
    through the f32 inverse ``inv_M`` (computed if None).  Without
    refinement it is the plain solve: ``inv_M @ rhs``, or an LU solve."""
    steps = dd_steps(M.shape[1])
    if steps == 0 and inv_M is None:
        return solve_or_nan(M, rhs)
    if inv_M is None:
        inv_M = inv_or_nan(M)
    x = torch.einsum("bmk,bk->bm", inv_M, rhs)
    return refine_bfs(M, rhs, inv_M, x, steps=steps)


@spanned("bounded_polish")
def polish_bounded_batch(c, A, b, lb, ub, basis, var_state, active, *,
                         max_pivots: int = 16, dd_tol: float = 2e-6,
                         pivot_tol: float = 1e-9, inv_B=None):
    """dd-guided cleanup steps for the bounded-variable engine (the bounded
    counterpart of :func:`polish_batch`).

    Reduced costs are recomputed in double-word arithmetic with the
    bound-aware sign flip (a variable at its upper bound prices as
    ``-(z - c)``), and each cleanup step runs the engine's three-way ratio
    test: a basic variable to its lower bound, to its upper bound, or a
    bound flip of the entering variable.

    ``c[B, n], A[B, m, n], b[B, m], lb[B, n], ub[B, n], basis[B, m]`` i32,
    ``var_state[B, n]`` i8 (AT_LB 0 / AT_UB 1 / BASIC 2), ``active[B]``
    bool.  Returns ``(basis, var_state, xB, y, inv_B)`` with ``xB``
    dd-refined at the final basis and bound assignment.
    """
    Bsz, m, n = A.shape
    lanes = torch.arange(Bsz, device=A.device)
    AT_LB, AT_UB, BASIC = 0, 1, 2
    inf = float("inf")
    basis = basis.to(torch.int32)
    var_state = var_state.to(torch.int8)
    scale = torch.clamp_min(torch.abs(c).max(dim=1).values, 1.0)
    ub_fin = torch.where(torch.isfinite(ub), ub, 0.0)

    launched = dd_kernel.launches
    if inv_B is None:
        inv_B = inv_or_nan(basis_matrix(A, basis))

    def rhs_of(var_state):
        x_n = torch.where(var_state == AT_LB, lb,
                          torch.where(var_state == AT_UB, ub_fin, 0.0))
        return dd_residual(b, A, x_n)  # b - A x_N, compensated

    act = active
    k = 0
    while k < max_pivots and host_read(bool, act.any()):
        Bmat = basis_matrix(A, basis)
        cB = torch.gather(c, 1, basis.long())
        y = refine_duals(cB, Bmat, inv_B)
        zc = -dd_residual_rowmat(c, y, A)  # y'A - c, compensated
        rc = torch.where(var_state == AT_UB, -zc, zc)
        rc = torch.where(var_state == BASIC, -inf, rc)
        enter = rc.argmax(dim=1)
        go = act & (rc[lanes, enter] > dd_tol * scale)

        vs_e = var_state[lanes, enter]
        sigma = torch.where(vs_e == AT_LB, 1.0, -1.0).to(A.dtype)
        d = torch.einsum("bmk,bk->bm", inv_B, A[lanes, :, enter])
        sd = sigma[:, None] * d
        xB = torch.einsum("bmk,bk->bm", inv_B, rhs_of(var_state))
        lb_B = torch.gather(lb, 1, basis.long())
        ub_B = torch.gather(ub, 1, basis.long())
        up, down = sd > pivot_tol, -sd > pivot_tol
        g1 = torch.where(up, (xB - lb_B) / torch.where(up, sd, 1.0), inf)
        g2 = torch.where(down, (ub_B - xB) / torch.where(down, -sd, 1.0), inf)
        g1m = g1.min(dim=1).values
        g2m = g2.min(dim=1).values
        gamma3 = ub[lanes, enter] - lb[lanes, enter]
        delta = torch.minimum(g1m, g2m)
        flip = go & (gamma3 <= delta) & torch.isfinite(gamma3)
        piv = go & ~flip & torch.isfinite(delta)

        # bound flip: the entering variable jumps to its opposite bound
        vs_flip = torch.where(vs_e == AT_LB, AT_UB, AT_LB).to(torch.int8)
        var_state = var_state.clone()
        var_state[lanes, enter] = torch.where(
            flip, vs_flip, torch.where(piv, BASIC, vs_e).to(torch.int8))

        # pivot: the leaving basic lands on the bound that bound its step
        to_lb = g1m < g2m
        leave = torch.where(to_lb, g1.argmin(dim=1), g2.argmin(dim=1))
        leaving_col = basis[lanes, leave].long()
        leave_vs = torch.where(to_lb, AT_LB, AT_UB).to(torch.int8)
        var_state[lanes, leaving_col] = torch.where(
            piv, leave_vs, var_state[lanes, leaving_col])
        d_l = d[lanes, leave]
        safe = torch.where(d_l == 0, 1.0, d_l)
        u = -d / safe[:, None]
        u[lanes, leave] = 1.0 / safe - 1.0
        u = torch.where(piv[:, None], u, 0.0)
        row = inv_B[lanes, leave][:, None, :]
        inv_B = inv_B + u[:, :, None] * row
        new_basis = basis.clone()
        new_basis[lanes, leave] = enter.to(torch.int32)
        basis = torch.where(piv[:, None], new_basis, basis)
        act = go
        k += int(host_read(bool, go.any()))

    Bmat = basis_matrix(A, basis)
    rhs = rhs_of(var_state)
    xB = torch.einsum("bmk,bk->bm", inv_B, rhs)
    xB = refine_bfs(Bmat, rhs, inv_B, xB, steps=3)
    cB = torch.gather(c, 1, basis.long())
    y = refine_duals(cB, Bmat, inv_B)
    current().set(pivots=k, dd_launches=dd_kernel.launches - launched)
    return basis, var_state, xB, y, inv_B


@spanned("polish")
def polish_batch(c, A, b, basis, allowed, active, *, max_pivots: int = 16,
                 dd_tol: float = 2e-6, pivot_tol: float = 1e-9, inv_B=None):
    """dd-guided cleanup pivots at a terminal basis.

    ``c[B, n], A[B, m, n], b[B, m], basis[B, m] i32, allowed[n]`` bool,
    ``active[B]`` bool.  ``inv_B`` may pass the engine's running factor.
    Returns ``(basis, xB, y, inv_B, rounds)``.
    """
    Bsz, m, n = A.shape
    lanes = torch.arange(Bsz, device=A.device)
    scale = torch.clamp_min(torch.abs(c).max(dim=1).values, 1.0)

    def price(basis, Bmat, inv_B):
        cB = torch.gather(c, 1, basis.long())
        y = refine_duals(cB, Bmat, inv_B)
        r = c - dd_rowmat(y, A)
        blocked = in_basis_mask(basis, n) | ~allowed[None, :]
        return torch.where(blocked, float("inf"), r)

    launched = dd_kernel.launches
    if inv_B is None:
        inv_B = inv_or_nan(basis_matrix(A, basis))
    act = active
    k = 0
    while k < max_pivots and host_read(bool, act.any()):
        Bmat = basis_matrix(A, basis)
        r = price(basis, Bmat, inv_B)
        enter = torch.argmin(r, dim=1)
        r_min = r[lanes, enter]
        go = act & (r_min < -dd_tol * scale)

        # the ratio test on dd-refined solves past the whole-segment
        # regime: with plain f32 ones a pivot there can pick a row whose
        # true ratio is not the least and leave a basic value negative past
        # the certificate's tolerance
        acol = A[lanes, :, enter]
        d = solve_dd(Bmat, acol, inv_B)
        xB = solve_dd(Bmat, b, inv_B)
        pos = d > pivot_tol
        go = go & pos.any(dim=1)  # no positive direction: leave the lane
        theta = torch.where(pos, xB / torch.where(pos, d, 1.0), float("inf"))
        leave = torch.argmin(theta, dim=1)

        d_l = d[lanes, leave]
        safe = torch.where(d_l == 0, 1.0, d_l)
        u = -d / safe[:, None]
        u[lanes, leave] = 1.0 / safe - 1.0
        u = torch.where(go[:, None], u, 0.0)
        row = inv_B[lanes, leave][:, None, :]
        inv_B = inv_B + u[:, :, None] * row
        new_basis = basis.clone()
        new_basis[lanes, leave] = enter.to(torch.int32)
        basis = torch.where(go[:, None], new_basis, basis)
        act = go
        k += int(host_read(bool, go.any()))

    Bmat = basis_matrix(A, basis)
    xB = torch.einsum("bmk,bk->bm", inv_B, b)
    xB = refine_bfs(Bmat, b, inv_B, xB, steps=3)
    cB = torch.gather(c, 1, basis.long())
    y = refine_duals(cB, Bmat, inv_B)
    current().set(pivots=k, dd_launches=dd_kernel.launches - launched)
    return basis, xB, y, inv_B, k
