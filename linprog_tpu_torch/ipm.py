"""Batched Mehrotra predictor-corrector IPM, canonical form (counterpart of
the canonical path of :mod:`linprog_tpu.ipm`).

Standard form ``min c'x, Ax = b, x >= 0`` with ``A = [G | I]`` kept
implicit (:class:`_SlackOp`).  Newton systems reduce to the normal
equations ``A D A' dy = r``; each iteration factors ``A D A' + reg I`` once
into the INVERSE Cholesky factor ``W = L^{-1}``
(:func:`block_cholesky_inverse`, whose f32 base panels are the
``panel_cholinv`` kernel), so every Newton solve is two batched GEMVs.
The reference's ``lax.while_loop`` becomes a Python loop with a host check
of "any lane running".  ``gondzio`` correctors and
``newton_solver="minv"`` are not ported (off by default in the reference).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import status as st
from .ops.cholinv_kernel import panel_cholinv
from .results import BatchResult

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """IPM configuration; fields and defaults as the reference's.

    ``eps_rel`` is the KKT tolerance, ``maxiters`` the Newton-step cap,
    ``frac`` the fraction-to-boundary damping, ``reg`` the Tikhonov
    regularization (None: 1e-7 in f32, 1e-12 in f64), ``cert_tol`` the
    Farkas-certificate tolerance (None: 1e-4 in f32, 1e-6 in f64).
    """

    eps_rel: float = 1e-3
    maxiters: int = 80
    frac: float = 0.99
    reg: Optional[float] = None
    cert_tol: Optional[float] = None
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype: {self.dtype!r}")


DEFAULT_IPM_CONFIG = IPMConfig()


class IPMState(NamedTuple):
    """Batched iterate ``x[B, n] > 0``, ``y[B, m]``, ``s[B, n] > 0``,
    ``iters[B]`` i32, ``status[B]`` i32."""

    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor


def _mv(A, v):
    return torch.einsum("bij,bj->bi", A, v)


def _mtv(A, v):
    return torch.einsum("bij,bi->bj", A, v)


class _SlackOp:
    """Implicit slack-extended matrix ``A = [G | I]``:
    ``A D A' = G D_g G' + diag(D_s)``."""

    def __init__(self, G):
        self.G = G
        self.B, self.m, self.ng = G.shape
        self.n = self.ng + self.m

    def mv(self, v):
        return _mv(self.G, v[:, : self.ng]) + v[:, self.ng:]

    def mtv(self, w):
        return torch.cat([_mtv(self.G, w), w], dim=1)

    def normal(self, d):
        GD = self.G * d[:, None, : self.ng]
        M = torch.matmul(GD, self.G.transpose(1, 2))
        return M + torch.diag_embed(d[:, self.ng:])

    def max_abs(self):
        return torch.clamp_min(torch.abs(self.G).amax(dim=(1, 2)), 1.0)


def _chol_solve(W, r):
    """``M^{-1} r = W' (W r)`` with the inverse factor ``W = L^{-1}``."""
    z = torch.einsum("bij,bj->bi", W, r)
    return torch.einsum("bij,bi->bj", W, z)


def block_cholesky_inverse(M, blk: int = 32):
    """``W = L^{-1}`` of the Cholesky factor ``M = L L'`` by block recursion:

        W11 = factor(A11);  L21 = A21 W11';  S = A22 - L21 L21'
        W22 = factor(S);    W = [[W11, 0], [-W22 L21 W11, W22]]

    The recursion's products are ``torch.matmul``; the ``blk``-sized base
    panels are :func:`linprog_tpu_torch.ops.cholinv_kernel.panel_cholinv`
    in f32 (the CUDA kernel on a card, its plain version on the CPU) and a
    Cholesky plus triangular solve in f64.  A non-SPD block gives non-finite
    values, never an exception.
    """
    m = M.shape[-1]
    if m <= blk:
        if M.dtype == torch.float32:
            return panel_cholinv(M.contiguous())
        L, info = torch.linalg.cholesky_ex(M)
        L = torch.where((info != 0)[:, None, None], float("nan"), L)
        eye = torch.eye(m, dtype=M.dtype, device=M.device).expand_as(L)
        return torch.linalg.solve_triangular(L, eye, upper=False)
    k = m // 2
    A11 = M[..., :k, :k]
    A21 = M[..., k:, :k]
    A22 = M[..., k:, k:]
    W11 = block_cholesky_inverse(A11, blk)
    L21 = torch.matmul(A21, W11.transpose(-1, -2))
    S = A22 - torch.matmul(L21, L21.transpose(-1, -2))
    W22 = block_cholesky_inverse(S, blk)
    W21 = -torch.matmul(W22, torch.matmul(L21, W11))
    top = torch.cat([W11, torch.zeros_like(A21.transpose(-1, -2))], dim=-1)
    bot = torch.cat([W21, W22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _normal_factor(op, d, reg):
    """``W = L^{-1}`` of ``A diag(d) A' + reg (1 + mean diag) I``."""
    M = op.normal(d)
    m = M.shape[-1]
    diag_mean = torch.diagonal(M, dim1=1, dim2=2).sum(dim=1) / m
    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    M = M + (reg * (1.0 + diag_mean))[:, None, None] * eye
    return block_cholesky_inverse(M)


def _step_to_boundary(v, dv):
    """Largest ``a in [0, 1]`` with ``v + a dv >= 0`` per lane."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        float("inf"))
    return torch.clamp(ratio.min(dim=1).values, 0.0, 1.0)


def _starting_point(c, op, b, reg):
    """Mehrotra's least-squares starting point, shifted into the interior."""
    L = _normal_factor(op, torch.ones((op.B, op.n), dtype=b.dtype,
                                      device=b.device), reg)
    x = op.mtv(_chol_solve(L, b))
    y = _chol_solve(L, op.mv(c))
    s = c - op.mtv(y)
    dx = torch.clamp_min(-1.5 * x.min(dim=1).values, 0.0)[:, None]
    ds = torch.clamp_min(-1.5 * s.min(dim=1).values, 0.0)[:, None]
    x = x + dx
    s = s + ds
    xs = (x * s).sum(dim=1)
    sum_s = torch.clamp_min(s.sum(dim=1), 1e-12)
    sum_x = torch.clamp_min(x.sum(dim=1), 1e-12)
    x = x + (0.5 * xs / sum_s)[:, None]
    s = s + (0.5 * xs / sum_x)[:, None]
    x = torch.clamp_min(x, 1e-2)
    s = torch.clamp_min(s, 1e-2)
    return x, y, s


def _where(mask, a, b):
    return torch.where(mask[:, None], a, b)


def _ipm_core(c, op, b, cfg: IPMConfig) -> IPMState:
    """The Mehrotra loop over the constraint operator ``op``; ``c``/``b``
    already in the working dtype."""
    B, m, n = op.B, op.m, op.n
    f64 = c.dtype == torch.float64
    eps = cfg.eps_rel
    reg = cfg.reg if cfg.reg is not None else (1e-12 if f64 else 1e-7)
    dev = c.device

    x, y, s = _starting_point(c, op, b, reg)
    norm_b = 1.0 + torch.linalg.vector_norm(b, dim=1)
    norm_c = 1.0 + torch.linalg.vector_norm(c, dim=1)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    status = torch.zeros((B,), dtype=torch.int32, device=dev)

    def _criterion(xx, yy, ss):
        """Per-lane KKT score: max of relative residuals and gap."""
        rb = op.mv(xx) - b
        rc = op.mtv(yy) + ss - c
        pobj = (c * xx).sum(dim=1)
        dobj = (b * yy).sum(dim=1)
        rb_rel = torch.linalg.vector_norm(rb, dim=1) / norm_b
        rc_rel = torch.linalg.vector_norm(rc, dim=1) / norm_c
        gap_rel = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj))
        crit = torch.maximum(torch.maximum(rb_rel, rc_rel), gap_rel)
        return torch.where(torch.isfinite(crit), crit, float("inf"))

    bx, by, bs = x, y, s
    bcrit = _criterion(x, y, s)
    it = 0
    while it < cfg.maxiters and bool((status == st.RUNNING).any()):
        running = status == st.RUNNING
        # grade the current iterate; keep the best seen per lane
        crit = _criterion(x, y, s)
        better = running & (crit < bcrit)
        bx, by, bs = _where(better, x, bx), _where(better, y, by), _where(better, s, bs)
        bcrit = torch.where(better, crit, bcrit)

        status = torch.where(running & (crit <= eps), st.OPTIMAL, status)
        running = status == st.RUNNING
        # freeze lanes past the productive regime
        mu_lane = (x * s).sum(dim=1) / n
        mu_rel = mu_lane / (1.0 + torch.abs((c * x).sum(dim=1)))
        spent = (mu_rel < 1e-6 * eps) | (crit > 100.0 * bcrit)
        status = torch.where(running & spent, st.ITER_LIMIT, status)
        running = status == st.RUNNING

        # ---- Newton machinery (shared factorization) ---------------------
        s_safe = torch.clamp_min(s, 1e-30)
        d = x / s_safe
        W = _normal_factor(op, d, reg)
        rb = op.mv(x) - b
        rc = op.mtv(y) + s - c
        mu = (x * s).sum(dim=1) / n

        def _direction(rxs):
            rhs = -rb + op.mv(rxs / s_safe - d * rc)
            dy = _chol_solve(W, rhs)
            ds = -rc - op.mtv(dy)
            dx = -rxs / s_safe - d * ds
            return dx, dy, ds

        # predictor (affine scaling)
        dx_a, dy_a, ds_a = _direction(x * s)
        ap_a = _step_to_boundary(x, dx_a)
        ad_a = _step_to_boundary(s, ds_a)
        mu_aff = ((x + ap_a[:, None] * dx_a) * (s + ad_a[:, None] * ds_a)
                  ).sum(dim=1) / n
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu, 1e-30)) ** 3,
                            0.0, 1.0)

        # corrector (centering + Mehrotra second-order term)
        rxs = x * s + dx_a * ds_a - (sigma * mu)[:, None]
        dx, dy, ds = _direction(rxs)
        ap = cfg.frac * _step_to_boundary(x, dx)
        ad = cfg.frac * _step_to_boundary(s, ds)

        x_new = x + ap[:, None] * dx
        y_new = y + ad[:, None] * dy
        s_new = s + ad[:, None] * ds
        finite = (torch.isfinite(x_new).all(dim=1)
                  & torch.isfinite(y_new).all(dim=1)
                  & torch.isfinite(s_new).all(dim=1))
        status = torch.where(running & ~finite, st.NUMERICAL_ERROR, status)
        step = running & finite
        x, y, s = _where(step, x_new, x), _where(step, y_new, y), _where(step, s_new, s)
        iters = torch.where(step, iters + 1, iters)
        status = status.to(torch.int32)
        it += 1

    # ---- Farkas certificates from the (possibly diverging) final iterate --
    cert_tol = cfg.cert_tol if cfg.cert_tol is not None else (
        1e-6 if f64 else 1e-4
    )
    normA = 1.0 + op.max_abs()
    yn = torch.linalg.vector_norm(y, dim=1)
    yhat = y / torch.clamp_min(yn, 1e-30)[:, None]
    inf_viol = torch.clamp_min(op.mtv(yhat), 0.0).max(dim=1).values
    inf_gain = (b * yhat).sum(dim=1) / (1.0 + torch.linalg.vector_norm(b, dim=1))
    is_inf = (inf_viol <= cert_tol * normA) & (inf_gain >= 10.0 * cert_tol)

    xn = torch.linalg.vector_norm(x, dim=1)
    xhat = torch.clamp_min(x, 0.0) / torch.clamp_min(xn, 1e-30)[:, None]
    unb_viol = torch.abs(op.mv(xhat)).max(dim=1).values
    unb_gain = -(c * xhat).sum(dim=1) / (1.0 + torch.linalg.vector_norm(c, dim=1))
    is_unb = (unb_viol <= cert_tol * normA) & (unb_gain >= 10.0 * cert_tol)

    # terminal grading: best iterate per lane, then close out running lanes
    crit = _criterion(x, y, s)
    use_best = bcrit < crit
    x = _where(use_best, bx, x)
    y = _where(use_best, by, y)
    s = _where(use_best, bs, s)
    crit = torch.minimum(crit, bcrit)
    closable = (status == st.RUNNING) | (status == st.ITER_LIMIT)
    status = torch.where(closable & (crit <= eps), st.OPTIMAL, status)
    grant_inf = (status != st.OPTIMAL) & closable & is_inf
    grant_unb = (status != st.OPTIMAL) & closable & is_unb & ~grant_inf
    status = torch.where(grant_inf, st.PRIMAL_INFEASIBLE, status)
    status = torch.where(grant_unb, st.PRIMAL_UNBOUNDED, status)
    y = _where(grant_inf, yhat, y)
    x = _where(grant_unb, xhat, x)
    status = torch.where(status == st.RUNNING, st.ITER_LIMIT, status)
    return IPMState(x=x, y=y, s=s, iters=iters,
                    status=status.to(torch.int32))


def ipm_state_to_result(c, state: IPMState) -> BatchResult:
    """A terminal :class:`IPMState` as a :class:`BatchResult` (``basis`` is
    -1: interior points are not vertices)."""
    B, m = state.y.shape
    return BatchResult(
        x=state.x,
        basis=torch.full((B, m), -1, dtype=torch.int32, device=c.device),
        cost=(c * state.x).sum(dim=1),
        iters=state.iters,
        status=state.status,
        y=state.y,
    )


def ipm_canonical_state(cs, G, h, cfg: IPMConfig = DEFAULT_IPM_CONFIG
                        ) -> IPMState:
    """IPM on ``[G | I]`` with slack-extended costs ``cs[B, n + m]``."""
    dt = _DTYPES[cfg.dtype]
    return _ipm_core(cs.to(dt), _SlackOp(G.to(dt)), h.to(dt), cfg)


def ipm_solve_batch_canonical(c, G, h, cfg: IPMConfig = DEFAULT_IPM_CONFIG,
                              return_state: bool = False):
    """Batched IPM on ``min c'x, Gx <= h, x >= 0`` (``c[B, n], G[B, m, n],
    h[B, m]``).  The result lives in the slack-extended space (the first
    ``n`` entries of ``x`` are the user variables)."""
    B, m, n = G.shape
    cs = torch.cat([c, torch.zeros((B, m), dtype=G.dtype, device=G.device)],
                   dim=1)
    state = ipm_canonical_state(cs, G, h, cfg)
    res = ipm_state_to_result(cs, state)
    return (res, state) if return_state else res
