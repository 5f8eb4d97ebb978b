"""Batched Mehrotra predictor-corrector IPM (counterpart of the batched
surface of :mod:`linprog_tpu.ipm`).

Standard form ``min c'x, Ax = b, x >= 0``, with ``A`` explicit
(:class:`_DenseOp`, :func:`ipm_solve_batch_standard`) or ``A = [G | I]``
kept implicit (:class:`_SlackOp`, :func:`ipm_solve_batch_canonical`).
Newton systems reduce to the normal
equations ``A D A' dy = r``; each iteration factors ``A D A' + reg I`` once
into the INVERSE Cholesky factor ``W = L^{-1}``
(:func:`block_cholesky_inverse`, whose f32 base panels are the
``panel_cholinv`` kernel), so every Newton solve is two batched GEMVs.
The reference's ``lax.while_loop`` becomes a Python loop with a host check
of "any lane running".  ``IPMConfig.gondzio`` adds Gondzio's centrality
correctors on the same factor; ``newton_solver="minv"`` squares the factor
once an iteration (``M^{-1} = W'W``) so that every solve is one GEMV.

:class:`IPMSolver` is the single-instance general-form surface on the
standard-form IPM, with warm re-solves of perturbed data.

Warm re-solves (:func:`warm_start_point`,
:func:`reoptimize_ipm_batch_canonical`) restart from a previous terminal
iterate pushed back into the interior.  Straggler recovery
(:func:`recover_stragglers_pooled`, ``recover=True``) gathers the lanes
the f32 IPM leaves non-OPTIMAL at its KKT floor, from many chunks, into one
power-of-two bucket and repairs them to exact vertices through the simplex
crossover; the gather, the Tapia indicator and the scatter stay on the
device, only the statuses and the pick list touch the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import engine as _engine
from . import status as st
from .observability import current, host_read, spanned
from .ops.cholinv_kernel import panel_cholinv
from .ops.solve_kernel import _nonneg
from .results import BatchResult, LinProgResult

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """IPM configuration; fields and defaults as the reference's.

    ``eps_rel`` is the KKT tolerance, ``maxiters`` the Newton-step cap,
    ``frac`` the fraction-to-boundary damping, ``reg`` the Tikhonov
    regularization (None: 1e-7 in f32, 1e-12 in f64), ``cert_tol`` the
    Farkas-certificate tolerance (None: 1e-4 in f32, 1e-6 in f64).
    ``gondzio`` is the number of centrality correctors an iteration (each
    one more solve on the iteration's factor, accepted per lane only where
    both step lengths grow).  ``newton_solver`` is ``"w2"`` (``M^{-1} r =
    W'(W r)``, two GEMVs a solve) or ``"minv"`` (``M^{-1} = W'W`` formed
    once an iteration, one GEMV a solve; it squares the condition number
    into one matrix and collapses in f32, so keep it for float64).
    """

    eps_rel: float = 1e-3
    maxiters: int = 80
    frac: float = 0.99
    reg: Optional[float] = None
    cert_tol: Optional[float] = None
    gondzio: int = 0
    newton_solver: str = "w2"
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype: {self.dtype!r}")
        if self.newton_solver not in ("w2", "minv"):
            raise ValueError(
                f"unknown newton_solver: {self.newton_solver!r}")
        if self.gondzio < 0:
            raise ValueError(f"gondzio must be >= 0, got {self.gondzio}")


DEFAULT_IPM_CONFIG = IPMConfig()


class IPMState(NamedTuple):
    """Batched iterate ``x[B, n] > 0``, ``y[B, m]``, ``s[B, n] > 0``,
    ``iters[B]`` i32, ``status[B]`` i32."""

    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor


def _normal_matmul(A, d):
    """``A diag(d) A'`` for ``A[B, m, K]``, ``d[B, K]``: in float64 and
    rounded when f32 data sums more than ``engine.F64_PAST`` columns (the
    card's f32 GEMM came out 3.0-3.5e-6 of the largest entry off at
    K = 4096, the host's 3.4-3.8e-7 (tools/diag_m4096.py), and the factor of
    every lane of the m = 4096 exact leg broke before the IPM converged;
    f32 inputs multiply exactly in float64)."""
    if A.dtype == torch.float32 and A.shape[2] > _engine.F64_PAST:
        A64 = A.double()
        M = torch.matmul(A64 * d.double()[:, None, :], A64.transpose(1, 2))
        return M.float()
    return torch.matmul(A * d[:, None, :], A.transpose(1, 2))


def _mv(A, v):
    return torch.einsum("bij,bj->bi", A, v)


def _mtv(A, v):
    return torch.einsum("bij,bi->bj", A, v)


class _DenseOp:
    """Explicit batched constraint matrix ``A[B, m, n]`` (standard form)."""

    def __init__(self, A):
        self.A = A
        self.B, self.m, self.n = A.shape

    def mv(self, v):
        return _mv(self.A, v)

    def mtv(self, w):
        return _mtv(self.A, w)

    def normal(self, d):
        """``A diag(d) A'`` (before regularization)."""
        return _normal_matmul(self.A, d)

    def max_abs(self):
        return torch.abs(self.A).amax(dim=(1, 2))


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
        M = _normal_matmul(self.G, d[:, : self.ng])
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


@spanned("ipm")
def _ipm_core(c, op, b, cfg: IPMConfig, init=None) -> IPMState:
    """The Mehrotra loop over the constraint operator ``op``; ``c``/``b``
    already in the working dtype.  ``init`` (optional) is a warm-start
    triple ``(x0, y0, s0)`` with ``x0, s0`` strictly interior
    (:func:`warm_start_point`); with it the least-squares starting point
    and its factorization are skipped."""
    B, m, n = op.B, op.m, op.n
    f64 = c.dtype == torch.float64
    eps = cfg.eps_rel
    reg = cfg.reg if cfg.reg is not None else (1e-12 if f64 else 1e-7)
    dev = c.device

    if init is None:
        x, y, s = _starting_point(c, op, b, reg)
    else:
        x, y, s = (v.to(c.dtype) for v in init)
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
    while it < cfg.maxiters and host_read(bool,
                                          (status == st.RUNNING).any()):
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
        if cfg.newton_solver == "minv":
            # square once; every solve below is one GEMV
            Minv = torch.matmul(W.transpose(1, 2), W)

            def solve(r):
                return torch.einsum("bij,bj->bi", Minv, r)
        else:
            def solve(r):
                return _chol_solve(W, r)
        rb = op.mv(x) - b
        rc = op.mtv(y) + s - c
        mu = (x * s).sum(dim=1) / n

        def _direction(rxs):
            rhs = -rb + op.mv(rxs / s_safe - d * rc)
            dy = solve(rhs)
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

        # Gondzio's centrality correctors on the same factor: push the
        # products of a trial point at 1.2x the steps into [0.1, 10] mu_t;
        # the corrector solves with rb = rc = 0 (the main direction carries
        # them once)
        mu_t = sigma * mu
        for _ in range(cfg.gondzio):
            ap_t = torch.clamp_max(1.2 * ap / cfg.frac, 1.0)
            ad_t = torch.clamp_max(1.2 * ad / cfg.frac, 1.0)
            v = (x + ap_t[:, None] * dx) * (s + ad_t[:, None] * ds)
            target = torch.clamp(v, 0.1 * mu_t[:, None], 10.0 * mu_t[:, None])
            rxs_c = v - target
            dy_c = solve(op.mv(rxs_c / s_safe))
            ds_c = -op.mtv(dy_c)
            dx_c = -rxs_c / s_safe - d * ds_c
            dx2, dy2, ds2 = dx + dx_c, dy + dy_c, ds + ds_c
            ap2 = cfg.frac * _step_to_boundary(x, dx2)
            ad2 = cfg.frac * _step_to_boundary(s, ds2)
            acc = (ap2 >= ap) & (ad2 >= ad)  # both step lengths extend
            dx, dy, ds = _where(acc, dx2, dx), _where(acc, dy2, dy), _where(acc, ds2, ds)
            ap = torch.where(acc, ap2, ap)
            ad = torch.where(acc, ad2, ad)

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
    current().set(steps=it)

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


def ipm_solve_batch_standard(c, A, b, cfg: IPMConfig = DEFAULT_IPM_CONFIG
                             ) -> IPMState:
    """Batched IPM on standard-form LPs ``c[B, n], A[B, m, n], b[B, m]``
    (no ``b >= 0`` requirement: the IPM never flips row signs, so the duals
    live in the caller's row space).  Returns the terminal
    :class:`IPMState`; wrap it with :func:`ipm_state_to_result`."""
    dt = _DTYPES[cfg.dtype]
    return _ipm_core(c.to(dt), _DenseOp(A.to(dt)), b.to(dt), cfg)


def ipm_canonical_state(cs, G, h, cfg: IPMConfig = DEFAULT_IPM_CONFIG,
                        init=None) -> IPMState:
    """IPM on ``[G | I]`` with slack-extended costs ``cs[B, n + m]``;
    ``init`` as in :func:`_ipm_core`."""
    dt = _DTYPES[cfg.dtype]
    return _ipm_core(cs.to(dt), _SlackOp(G.to(dt)), h.to(dt), cfg, init=init)


def _slack_costs(c, G):
    B, m, _ = G.shape
    return torch.cat([c, torch.zeros((B, m), dtype=G.dtype, device=G.device)],
                     dim=1)


def ipm_solve_batch_canonical(c, G, h, cfg: IPMConfig = DEFAULT_IPM_CONFIG,
                              recover: bool = False, recover_cfg=None,
                              recover_maxiters: Optional[int] = None,
                              return_state: bool = False):
    """Batched IPM on ``min c'x, Gx <= h, x >= 0`` (``c[B, n], G[B, m, n],
    h[B, m]``).  The result lives in the slack-extended space (the first
    ``n`` entries of ``x`` are the user variables), the convention of
    :func:`linprog_tpu_torch.crossover.crossover_batch_canonical`.

    ``recover=True`` adds the straggler backstop: lanes the f32 IPM leaves
    non-OPTIMAL are gathered into a small power-of-two bucket and repaired
    to exact vertices, with a basis, by the simplex crossover
    (:func:`recover_stragglers_pooled`).  ``recover_cfg`` is the crossover's
    :class:`~linprog_tpu_torch.config.SolverConfig` and
    ``recover_maxiters`` its pivot budget (default:
    :func:`linprog_tpu_torch.router.recovery_cleanup_config`).  With
    ``return_state`` the terminal :class:`IPMState` comes back too.
    """
    cs = _slack_costs(c, G)
    state = ipm_canonical_state(cs, G, h, cfg)
    res = ipm_state_to_result(cs, state)
    if recover:
        res = _recover_stragglers(c, G, h, res, recover_cfg, recover_maxiters)
    return (res, state) if return_state else res


def warm_start_point(state: IPMState, warm_frac: float = 1e-2):
    """A terminal iterate pushed back into the interior for a re-solve.

    The iterate keeps its support information, but complementarity is
    lifted to ``mu0 ~ warm_frac`` of the lane's own scale: with
    ``xbar = mean|x|`` and ``sbar = mean|s|`` every variable is clamped from
    below at ``tx = sqrt(mu0 xbar / sbar)`` and ``ts = sqrt(mu0 sbar /
    xbar)`` (``tx ts = mu0``, scale ratios kept), so small entries move to
    the ``mu0`` shell and large ones stay.  Returns ``(x0, y0, s0)``.
    """
    x, s = state.x, state.s
    xbar = torch.clamp_min(torch.abs(x).mean(dim=1), 1e-8)
    sbar = torch.clamp_min(torch.abs(s).mean(dim=1), 1e-8)
    mu0 = warm_frac * xbar * sbar
    tx = torch.sqrt(mu0 * xbar / sbar)[:, None]
    ts = torch.sqrt(mu0 * sbar / xbar)[:, None]
    return torch.maximum(x, tx), state.y, torch.maximum(s, ts)


def reoptimize_ipm_batch_canonical(c, G, h, prev_state: IPMState,
                                   cfg: IPMConfig = DEFAULT_IPM_CONFIG,
                                   warm_frac: float = 1e-2,
                                   return_state: bool = False):
    """Warm-started batched IPM re-solve of perturbed canonical LPs (new
    ``h`` and/or ``c``, the same shape of ``G``): the loop restarts from
    ``prev_state`` (from ``ipm_solve_batch_canonical(..., return_state=
    True)`` or from this function) pushed back into the interior, takes the
    perturbation as an initial residual and skips the starting point's
    factorization.  Returns a :class:`BatchResult` (slack-extended ``x``),
    and the terminal state with ``return_state``."""
    cs = _slack_costs(c, G)
    state = ipm_canonical_state(cs, G, h, cfg,
                                init=warm_start_point(prev_state, warm_frac))
    res = ipm_state_to_result(cs, state)
    return (res, state) if return_state else res


def _recover_stragglers(c, G, h, res: BatchResult, recover_cfg,
                        maxiters: Optional[int]) -> BatchResult:
    """:func:`recover_stragglers_pooled` on one batch."""
    return recover_stragglers_pooled(
        [(c, G, h)], [res], recover_cfg=recover_cfg, maxiters=maxiters
    )[0]


def _recovery_pick(statuses, total: int):
    """The straggler lanes ``(chunk, lane)`` and the bucket's pick list:
    the bucket is the next power of two of their count, at least 8 and at
    most ``total``, filled cyclically and sorted."""
    lanes = [(bi, int(lane)) for bi, s in enumerate(statuses)
             for lane in (s != st.OPTIMAL).nonzero()[0]]
    if not lanes:
        return lanes, []
    bucket = min(max(8, 1 << (len(lanes) - 1).bit_length()), total)
    return lanes, sorted(lanes[k % len(lanes)] for k in range(bucket))


def recover_stragglers_pooled(batches, results, recover_cfg=None,
                              maxiters: Optional[int] = None):
    """Pool the non-OPTIMAL IPM lanes of many batches into one crossover.

    ``batches`` is a sequence of canonical chunks ``(c, G, h)`` of one
    ``(m, n)``, ``results`` the matching :class:`BatchResult` list of
    :func:`ipm_solve_batch_canonical`.  The stragglers of all chunks are
    gathered into one power-of-two bucket, ranked by the Tapia indicator
    rebuilt from the stored iterate (by magnitude where a result has no
    ``y``), crossed over in one batched call and scattered back as exact
    vertices with their bases.  There is no alternate-guess retry: a
    recovery lane's iterate is off the central path, not on a bad guess.
    Lanes the crossover cannot verify keep their IPM answer and status.

    Returns the list of (possibly replaced) :class:`BatchResult`.
    """
    from .crossover import crossover_batch_canonical
    from .router import recovery_cleanup_config

    statuses = [r.status.cpu().numpy() for r in results]  # small read-backs
    B, m, n = batches[0][1].shape
    lanes, pick = _recovery_pick(statuses, sum(b[1].shape[0] for b in batches))
    if not lanes:
        return list(results)
    if recover_cfg is None or maxiters is None:
        auto_cfg, auto_iters = recovery_cleanup_config(m)
        recover_cfg = recover_cfg or auto_cfg
        maxiters = maxiters or auto_iters

    # sorted, so each chunk's rows of the bucket are contiguous
    bidx = torch.tensor([p[0] for p in pick], dtype=torch.long)
    lidx = torch.tensor([p[1] for p in pick], dtype=torch.long)
    has_y = all(r.y is not None for r in results)
    cg, Gg, hg, xg, ind = _recovery_gather(
        [b[0] for b in batches], [b[1] for b in batches],
        [b[2] for b in batches], [r.x for r in results],
        [r.y for r in results] if has_y else None, bidx, lidx)
    sub, crossed = crossover_batch_canonical(
        cg, Gg, hg, xg, maxiters=maxiters, cfg=recover_cfg, indicator=ind,
    )
    crossed_host = crossed.cpu().numpy()
    if not crossed_host.any():
        return list(results)
    x_ext = _recovery_extend_x(sub.x, Gg, hg)

    seen, sel = set(), {}
    for k, (bi, lane) in enumerate(pick):
        if not crossed_host[k] or (bi, lane) in seen:
            continue
        seen.add((bi, lane))
        sel.setdefault(bi, []).append((lane, k))
    outs = list(results)
    dev = Gg.device
    for bi, pairs in sel.items():
        idxl = torch.tensor([p[0] for p in pairs], dtype=torch.long,
                            device=dev)
        idxp = torch.tensor([p[1] for p in pairs], dtype=torch.long,
                            device=dev)
        outs[bi] = _recovery_scatter(results[bi], x_ext, sub, idxl, idxp,
                                     with_y=has_y)
    return outs


def _recovery_gather(cs, Gs, hs, xs, ys, bidx, lidx):
    """The bucket's ``(c, G, h, x_struct, indicator)`` from the chunks'
    lists of tensors (``xs`` slack-extended ``[B, n + m]``): row ``k`` is
    lane ``lidx[k]`` of chunk ``bidx[k]``.  ``bidx`` and ``lidx`` are host
    index tensors sorted by chunk; the data is gathered on its device, chunk
    by chunk, so no chunk is copied whole.

    The indicator is Tapia's ``max(x, 0) / max(s, 1e-30)`` with the dual
    slack of the slack-extended system rebuilt from the stored iterate,
    ``s = [c - G'y; -y]``; a lane whose ratios are not all finite takes
    ``max(x, 0)``.  ``ys`` None (no duals stored) gives no indicator: the
    crossover then ranks by magnitude.
    """
    rows = [(bi, lidx[bidx == bi]) for bi in bidx.unique().tolist()]

    def take(ts):
        return torch.cat([ts[bi][idx.to(ts[bi].device)] for bi, idx in rows])

    cg, Gg, hg, xg_full = take(cs), take(Gs), take(hs), take(xs)
    n = cg.shape[-1]
    if ys is None:
        return cg, Gg, hg, xg_full[:, :n], None
    yg = take(ys)
    sg = torch.cat([cg - torch.einsum("bmn,bm->bn", Gg, yg), -yg], dim=1)
    x_pos = _nonneg(xg_full)
    ind = x_pos / torch.clamp_min(sg, 1e-30)
    ind = torch.where(torch.isfinite(ind).all(dim=1)[:, None], ind, x_pos)
    return cg, Gg, hg, xg_full[:, :n], ind


def _recovery_extend_x(sub_x, Gg, hg):
    """Slack-extended exact-vertex ``x`` for the scatter."""
    slack = hg - torch.einsum("bmn,bn->bm", Gg, sub_x)
    return torch.cat([sub_x, _nonneg(slack)], dim=1)


def _recovery_scatter(r: BatchResult, x_ext, sub: BatchResult, idxl, idxp,
                      with_y: bool = True) -> BatchResult:
    """``r`` with lanes ``idxl`` replaced by the crossed vertices at rows
    ``idxp`` of the bucket (iterations add up, status OPTIMAL; ``y`` too
    under ``with_y``)."""
    x, basis, cost = r.x.clone(), r.basis.clone(), r.cost.clone()
    iters, status = r.iters.clone(), r.status.clone()
    x[idxl] = x_ext[idxp].to(x.dtype)
    basis[idxl] = sub.basis[idxp]
    cost[idxl] = sub.cost[idxp].to(cost.dtype)
    iters[idxl] = iters[idxl] + sub.iters[idxp]
    status[idxl] = st.OPTIMAL
    y = r.y
    if with_y:
        y = y.clone()
        y[idxl] = sub.y[idxp].to(y.dtype)
    return BatchResult(x=x, basis=basis, cost=cost, iters=iters,
                       status=status, y=y)


class IPMSolver:
    """Interior-point solver of one instance with the general-form input
    surface: ``min c'x  s.t.  Ax = b, Gx <= h, lb <= x <= ub`` from host
    arrays, on ``device`` (a card by default; ``device="cpu"`` runs on the
    host).

    A finite lower bound of any sign is substituted out (``x = lb + w``);
    finite upper bounds become inequality rows.  Free variables
    (``lb = -inf``) raise ``ValueError``: use
    :class:`~linprog_tpu_torch.api.SimplexSolver` or
    :class:`~linprog_tpu_torch.pdhg.PDHGSolver` there.  The IPM never flips
    a row's sign, so the duals ``y`` are in the user's row space (equality
    rows, then inequality rows, then the upper-bound rows).
    """

    def __init__(self, c, A=None, b=None, G=None, h=None, lb=None, ub=None,
                 config: Optional[IPMConfig] = None, device="cuda"):
        from .ipm_sparse import resolve_device

        # kept for resolve(): a re-solve rebuilds the standard form with
        # the perturbed data and warm-starts from the terminal iterate
        self._init_kwargs = dict(c=c, A=A, b=b, G=G, h=h, lb=lb, ub=ub)
        self.config = config or DEFAULT_IPM_CONFIG
        self.device = resolve_device(device)
        dt = np.dtype(self.config.dtype)
        c = np.asarray(c, dtype=dt)
        n = c.shape[0]
        has_eq = A is not None and b is not None
        has_ineq = G is not None and h is not None
        if not has_eq and not has_ineq:
            raise ValueError(
                "Input polyhedron misspecified: need (A, b) and/or (G, h)."
            )
        Ae = np.atleast_2d(np.asarray(A, dtype=dt)) if has_eq else None
        be = np.asarray(b, dtype=dt) if has_eq else None
        Gi_user = np.atleast_2d(np.asarray(G, dtype=dt)) if has_ineq else None
        hi_user = np.asarray(h, dtype=dt) if has_ineq else None

        # finite lower bounds of any sign: x = lb + w (w >= 0), shifting the
        # right-hand sides and the upper bounds
        self._shift_idx = np.array([], dtype=int)
        self._shift_lb = np.array([], dtype=dt)
        if lb is not None:
            lb = np.asarray(lb, dtype=dt)
            if np.any(~np.isfinite(lb) & (lb < 0)):
                raise ValueError(
                    "IPMSolver does not support free variables (lb=-inf); "
                    "use SimplexSolver/PDHGSolver there."
                )
            idx = np.flatnonzero(np.isfinite(lb) & (lb != 0))
            if idx.size:
                shift = lb[idx].copy()
                if Ae is not None:
                    be = be - Ae[:, idx] @ shift
                if Gi_user is not None:
                    hi_user = hi_user - Gi_user[:, idx] @ shift
                if ub is not None:
                    ub = np.asarray(ub, dtype=dt).copy()
                    ub[idx] = ub[idx] - shift
                self._shift_idx = idx
                self._shift_lb = shift

        G_rows = []
        h_rows = []
        if has_ineq:
            G_rows.append(Gi_user)
            h_rows.append(hi_user)
        if ub is not None:
            ub = np.asarray(ub, dtype=dt)
            idx = np.flatnonzero(np.isfinite(ub))
            if idx.size:
                rows = np.zeros((idx.size, n), dtype=dt)
                rows[np.arange(idx.size), idx] = 1.0
                G_rows.append(rows)
                h_rows.append(ub[idx])

        blocks_A, blocks_b = [], []
        num_ineq = sum(g.shape[0] for g in G_rows)
        if has_eq:
            blocks_A.append(
                np.concatenate([Ae, np.zeros((Ae.shape[0], num_ineq), dt)],
                               axis=1))
            blocks_b.append(be)
        if num_ineq:
            Gi = np.concatenate(G_rows, axis=0)
            blocks_A.append(
                np.concatenate([Gi, np.eye(num_ineq, dtype=dt)], axis=1))
            blocks_b.append(np.concatenate(h_rows))
        self.n_orig = n
        self._c_std = np.concatenate([c, np.zeros(num_ineq, dtype=dt)])
        self._A_std = np.concatenate(blocks_A, axis=0)
        self._b_std = np.concatenate(blocks_b)

    def _standard(self):
        """The standard form as a batch of one on the device."""
        return (torch.tensor(a, device=self.device)[None]
                for a in (self._c_std, self._A_std, self._b_std))

    def _finish(self, state: IPMState) -> LinProgResult:
        self._state = state
        x_std = state.x[0].cpu().numpy()
        code = int(state.status[0])
        # infeasible and unbounded verdicts raise, as the reference's
        # exceptions (the certificate stays in .duals / the state)
        st.raise_for_status(code)
        x = x_std[: self.n_orig].copy()
        if self._shift_idx.size:
            x[self._shift_idx] += self._shift_lb
        return LinProgResult(
            x=x,
            basis=None,
            cost=float(self._c_std[: self.n_orig] @ x),
            iters=int(state.iters[0]),
            optimum=code == st.OPTIMAL,
            status=code,
            y=state.y[0].cpu().numpy(),
        )

    def solve(self, maxiters: Optional[int] = None) -> LinProgResult:
        cfg = self.config
        if maxiters is not None:
            cfg = dataclasses.replace(cfg, maxiters=int(maxiters))
        return self._finish(ipm_solve_batch_standard(*self._standard(), cfg))

    def resolve(self, b=None, h=None, c=None,
                maxiters: Optional[int] = None,
                warm_frac: float = 1e-2) -> LinProgResult:
        """Warm-started re-solve with perturbed data: any of a new ``b``
        (equality rhs), ``h`` (inequality rhs) or ``c``; the polyhedron's
        shape and bounds stay the constructor's.  The standard form is
        rebuilt and the Mehrotra loop restarts from the previous terminal
        iterate pushed back into the interior (:func:`warm_start_point`).
        Requires a prior :meth:`solve`."""
        if not hasattr(self, "_state"):
            raise AttributeError("call solve() first")
        kw = dict(self._init_kwargs)
        if b is not None:
            kw["b"] = b
        if h is not None:
            kw["h"] = h
        if c is not None:
            kw["c"] = c
        fresh = IPMSolver(config=self.config, device=self.device, **kw)
        cfg = fresh.config
        if maxiters is not None:
            cfg = dataclasses.replace(cfg, maxiters=int(maxiters))
        init = warm_start_point(self._state, warm_frac)
        c_s, A_s, b_s = fresh._standard()
        dt = _DTYPES[cfg.dtype]
        state = _ipm_core(c_s.to(dt), _DenseOp(A_s.to(dt)), b_s.to(dt), cfg,
                          init=init)
        # the rebuilt problem and its state, so that re-solves chain
        self.__dict__.update(fresh.__dict__)
        return self._finish(state)

    @property
    def duals(self) -> np.ndarray:
        """The dual iterate ``y`` in the user's row space; solve first."""
        if not hasattr(self, "_state"):
            raise AttributeError("call solve() first")
        return self._state.y[0].cpu().numpy()
