"""PDHG (PDLP-style) first-order LP solver (counterpart of
:mod:`linprog_tpu.pdhg`).

A restarted primal-dual hybrid gradient for

    min c'x   s.t.  A x = b,  G x <= h,  lb <= x <= ub

with the constraints stacked as ``K x ~ q`` (equality rows first):

    x+ = proj_[lb,ub](x - tau (c + K'y))
    y+ = proj_Y(y + sigma (K (2 x+ - x) - q))

``proj_Y`` is the identity on equality duals and ``max(0, .)`` on
inequality duals; ``tau sigma ||K||^2 <= 1`` through a power-iteration
estimate of ``||K||``.  Adaptive restarts (to the better of the current and
the average iterate), primal-weight adaptation with a stall reset,
infeasibility and unboundedness certificates from the epoch's movement, and
reflected Halpern acceleration are the reference's, branch for branch.

Every function takes a batch: state tensors carry a leading lane dimension
and ``K`` is a dense ``[B, m, n]`` tensor or a :class:`SharedPatternSparse`
(one COO pattern, per-lane values).  The reference's vmapped
``lax.while_loop`` becomes a host loop over chunks of ``check_every`` steps
followed by the restart check; a lane whose condition (RUNNING and
``iters < maxiters``) was false before a chunk keeps its state bit for bit,
as under ``vmap``, so ``iters`` grows in chunks and a lane can stop up to
``check_every - 1`` past ``maxiters``.  The host reads one flag a chunk;
on a card the chunk's steps replay as one captured CUDA graph
(:func:`.utils.cuda_graph.graphed`).
Matvecs are batched GEMVs in IEEE f32 (TF32 off) or float64, and gathers
over the sparse pattern's padded slot tables (never a floating-point
scatter).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import status as st
from .ipm import _DTYPES
# a module-level name, so that a caller timing eager chunks can patch it
from .utils.cuda_graph import graphed as _graphed
from .ipm_sparse import SharedTables, _gather_sum, resolve_device
from .results import LinProgResult


class SharedPatternSparse:
    """Sparse ``[m, n]`` matrices, one per lane, on one shared COO pattern.

    ``rows/cols[nnz]`` (host arrays or tensors) hold the pattern once for
    the batch and ``vals[B, nnz]`` each lane's values; the values are laid
    out once into the pattern's padded row and column tables, so ``K v``
    and ``K' y`` are one gather and a masked sum each.  ``.T`` is the
    transposed operator on the same tables.
    """

    def __init__(self, rows, cols, vals, m: int, n: int,
                 transposed: bool = False):
        self.tab = SharedTables(rows, cols, m, n, vals.device)
        self.vals = vals
        self.m, self.n = int(m), int(n)
        self.transposed = transposed
        self._V = self.tab.value_tables(vals)

    @property
    def shape(self):
        return (self.n, self.m) if self.transposed else (self.m, self.n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def T(self) -> "SharedPatternSparse":
        out = copy.copy(self)
        out.transposed = not self.transposed
        return out

    def mv(self, v):
        """``K v`` (``K' v`` when transposed) for ``v[B, shape[1]]``."""
        Vr, Vc = self._V
        pat = self.tab.tables(v.device)
        if self.transposed:
            return _gather_sum(Vc, pat["col_rows"], v)
        return _gather_sum(Vr, pat["row_cols"], v)


def _mv(K, v):
    if isinstance(K, SharedPatternSparse):
        return K.mv(v)
    return torch.einsum("bmn,bn->bm", K, v)


def _mtv(K, y):
    if isinstance(K, SharedPatternSparse):
        return K.T.mv(y)
    return torch.einsum("bmn,bm->bn", K, y)


def _dims(K):
    return K.shape[-2], K.shape[-1]


@dataclasses.dataclass(frozen=True)
class PDHGConfig:
    """PDHG configuration; fields and defaults as the reference's.

    ``check_every`` steps run between restart checks; ``restart_every`` is
    the backstop cadence; ``adaptive`` enables KKT-decay restarts,
    primal-weight adaptation and the certificates (``eps_infeas``);
    ``stall_reset_beta`` resets ``omega`` after a no-progress restart;
    ``halpern`` runs reflected Halpern steps until ``halpern_patience``
    iterations or a no-progress restart revert the lane.
    """

    eps_rel: float = 1e-4
    maxiters: int = 100_000
    check_every: int = 64
    restart_every: int = 512
    power_iters: int = 30
    omega: float = 1.0
    dtype: str = "float32"
    adaptive: bool = True
    restart_beta: float = 0.4
    eps_infeas: float = 1e-6
    omega_clip: float = 64.0
    stall_reset_beta: float = 0.95
    halpern: bool = False
    halpern_patience: int = 10_000

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype: {self.dtype!r}")

    @property
    def torch_dtype(self):
        return _DTYPES[self.dtype]


DEFAULT_PDHG_CONFIG = PDHGConfig()


class PDHGState(NamedTuple):
    """Batched iterate: ``x[B, n]``, ``y[B, m]``, their running sums since
    the last restart, ``inner_count[B]`` (iterations since it) and
    ``iters[B]`` i32, ``status[B]`` i32, ``omega[B]`` (primal weight),
    ``x_anchor[B, n]`` / ``y_anchor[B, m]`` (the iterate at the last
    restart), ``last_score[B]`` (its KKT score) and ``halpern_off[B]``
    (bool: the lane reverted to averaged restarts)."""

    x: torch.Tensor
    y: torch.Tensor
    x_sum: torch.Tensor
    y_sum: torch.Tensor
    inner_count: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor
    omega: torch.Tensor
    x_anchor: torch.Tensor
    y_anchor: torch.Tensor
    last_score: torch.Tensor
    halpern_off: torch.Tensor


def _power_start(n: int, dtype, device, seed: int = 0):
    """The power iteration's start vector ``[n]``: normal draws from a
    generator seeded ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n,), generator=gen, dtype=dtype, device=device)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=1)


def _dot(a, b):
    return (a * b).sum(dim=1)


def _estimate_norm(K, iters: int, seed: int = 0, lanes: int = 1):
    """Power iteration for each lane's ``||K||_2``; ``[lanes]``."""
    m, n = _dims(K)
    dt = K.dtype
    dev = K.vals.device if isinstance(K, SharedPatternSparse) else K.device
    v = _power_start(n, dt, dev, seed)
    v = (v / torch.linalg.vector_norm(v)).expand(lanes, n)
    for _ in range(iters):
        u = _mtv(K, _mv(K, v))
        v = u / torch.clamp_min(_norm(u), 1e-30)[:, None]
    return _norm(_mv(K, v)) / torch.clamp_min(_norm(v), 1e-30)


def _kkt_residuals(c, K, q, n_eq, lb, ub, x, y):
    """Per-lane relative KKT residuals ``(primal, dual, gap)``."""
    m = q.shape[1]
    is_ineq = torch.arange(m, device=q.device) >= n_eq
    viol = _mv(K, x) - q
    pr = torch.where(is_ineq, torch.clamp_min(viol, 0.0), viol)
    primal_res = _norm(pr) / (1.0 + _norm(q))
    # lambda = c + K'y is absorbed by bound multipliers: lambda > 0 needs a
    # finite lb, lambda < 0 a finite ub
    lam = c + _mtv(K, y)
    du = (torch.where(torch.isfinite(ub), 0.0, torch.clamp_max(lam, 0.0))
          + torch.where(torch.isfinite(lb), 0.0, torch.clamp_min(lam, 0.0)))
    dual_res = _norm(du) / (1.0 + _norm(c))
    contrib = torch.where(
        lam >= 0,
        torch.where(torch.isfinite(lb), lam * lb, 0.0),
        torch.where(torch.isfinite(ub), lam * ub, 0.0),
    )
    dual_obj = -_dot(q, y) + contrib.sum(dim=1)
    primal_obj = _dot(c, x)
    gap = torch.abs(primal_obj - dual_obj) / (
        1.0 + torch.abs(primal_obj) + torch.abs(dual_obj))
    return primal_res, dual_res, gap


def _pdhg_core(c, K, q, n_eq, lb, ub, cfg: PDHGConfig):
    """``(init_state, run)`` for a batch ``c[B, n], K, q[B, m],
    lb/ub[B, n]`` in one dtype on one device."""
    B = c.shape[0]
    m, n = _dims(K)
    dt, dev = c.dtype, c.device
    is_ineq = torch.arange(m, device=dev) >= n_eq
    norm_K = torch.clamp_min(_estimate_norm(K, cfg.power_iters, lanes=B),
                             1e-12)
    if cfg.halpern:
        # the reflected operator 2T - I compounds any expansiveness of T
        # when the power iteration underestimates ||K||: a 5 % step-size
        # margin covers the estimator's error
        norm_K = norm_K * 1.05
    finite_lb = torch.isfinite(lb)
    finite_ub = torch.isfinite(ub)

    def col(v):
        return v[:, None]

    def project_x(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    def project_y(y):
        return torch.where(is_ineq, torch.clamp_min(y, 0.0), y)

    def apply_T(x, y, omega):
        """One PDHG operator application (Chambolle-Pock with
        extrapolation)."""
        tau = omega / norm_K
        sigma = 1.0 / (omega * norm_K)
        x_new = project_x(x - col(tau) * (c + _mtv(K, y)))
        y_new = project_y(y + col(sigma) * (_mv(K, 2.0 * x_new - x) - q))
        return x_new, y_new

    def step(s: PDHGState) -> PDHGState:
        xT, yT = apply_T(s.x, s.y, s.omega)
        if cfg.halpern:
            # reflected Halpern with anchor weight 1/(k+2); reverted lanes
            # take the plain step
            k = col(s.inner_count.to(dt))
            lam = (k + 1.0) / (k + 2.0)
            x_h = lam * (2.0 * xT - s.x) + (1.0 - lam) * s.x_anchor
            y_h = lam * (2.0 * yT - s.y) + (1.0 - lam) * s.y_anchor
            off = col(s.halpern_off)
            x_new = torch.where(off, xT, x_h)
            y_new = torch.where(off, yT, y_h)
        else:
            x_new, y_new = xT, yT
        return s._replace(x=x_new, y=y_new, x_sum=s.x_sum + x_new,
                          y_sum=s.y_sum + y_new,
                          inner_count=s.inner_count + 1, iters=s.iters + 1)

    def kkt_score(x, y):
        pr, du, gap = _kkt_residuals(c, K, q, n_eq, lb, ub, x, y)
        return pr, du, gap, torch.sqrt(pr * pr + du * du + gap * gap)

    def certificates(s: PDHGState):
        """Infeasibility certificates from the epoch's movement: diverging
        iterates move along a ray, and the normalized movement since the
        last restart converges to a Farkas certificate."""
        eps = cfg.eps_infeas
        # dual ray => primal infeasible
        dy = s.y - s.y_anchor
        ny = _norm(dy)
        yhat = project_y(dy / col(torch.clamp_min(ny, 1e-30)))
        lam = _mtv(K, yhat)
        lam_plus = torch.clamp_min(lam, 0.0)
        lam_minus = torch.clamp_max(lam, 0.0)
        infeas_res = _norm(torch.where(finite_lb, 0.0, lam_plus)
                           + torch.where(finite_ub, 0.0, lam_minus))
        rayval = -_dot(q, yhat) + (
            torch.where(finite_lb, lam_plus * lb, 0.0)
            + torch.where(finite_ub, lam_minus * ub, 0.0)).sum(dim=1)
        primal_infeas = ((ny > 1.0)
                         & (infeas_res <= eps * (1.0 + _norm(yhat)))
                         & (rayval > eps))
        # primal ray => unbounded
        dx = s.x - s.x_anchor
        nx = _norm(dx)
        xhat = dx / col(torch.clamp_min(nx, 1e-30))
        xhat = torch.where(finite_lb, torch.clamp_min(xhat, 0.0), xhat)
        xhat = torch.where(finite_ub, torch.clamp_max(xhat, 0.0), xhat)
        Kx = _mv(K, xhat)
        ray_res = _norm(torch.where(is_ineq, torch.clamp_min(Kx, 0.0), Kx))
        unbounded = ((nx > 1.0)
                     & (ray_res <= eps * (1.0 + _norm(xhat)))
                     & (_dot(c, xhat) < -eps))
        return primal_infeas, unbounded

    def check_and_restart(s: PDHGState) -> PDHGState:
        cnt = col(torch.clamp_min(s.inner_count, 1).to(dt))
        if cfg.halpern:
            # candidates at T(z): feasible for the projections; reverted
            # lanes keep the averaged candidate
            x_cur, y_cur = apply_T(s.x, s.y, s.omega)
            off = s.halpern_off
            x_avg = torch.where(col(off), s.x_sum / cnt, x_cur)
            y_avg = torch.where(col(off), s.y_sum / cnt, y_cur)
        else:
            x_cur, y_cur = s.x, s.y
            x_avg = s.x_sum / cnt
            y_avg = s.y_sum / cnt
        pr_c, du_c, gap_c, s_cur = kkt_score(x_cur, y_cur)
        pr_a, du_a, gap_a, s_avg = kkt_score(x_avg, y_avg)
        eps = cfg.eps_rel
        ok_cur = (pr_c < eps) & (du_c < eps) & (gap_c < eps)
        ok_avg = (pr_a < eps) & (du_a < eps) & (gap_a < eps)
        adopt_avg_final = ok_avg & ~ok_cur
        ok = ok_cur | ok_avg

        if cfg.adaptive:
            infeas, unbnd = certificates(s)
        else:
            infeas = unbnd = torch.zeros((B,), dtype=torch.bool, device=dev)
        running = s.status == st.RUNNING
        status = torch.where(
            running & ok, st.OPTIMAL,
            torch.where(running & infeas, st.PRIMAL_INFEASIBLE,
                        torch.where(running & unbnd, st.PRIMAL_UNBOUNDED,
                                    s.status))).to(torch.int32)

        # restart decision
        avg_better = s_avg < s_cur
        s_cand = torch.minimum(s_avg, s_cur)
        if cfg.adaptive:
            do = ((s_cand <= cfg.restart_beta * s.last_score)
                  | (s.inner_count >= cfg.restart_every))
        else:
            do = s.inner_count >= cfg.restart_every
        do = do & running & ~ok
        if cfg.halpern:
            # re-anchor at T(z); reverted lanes adopt as averaged restarts
            restart_x = torch.where(
                col(off), torch.where(col(avg_better), x_avg, s.x), x_cur)
            restart_y = torch.where(
                col(off), torch.where(col(avg_better), y_avg, s.y), y_cur)
            x_new = torch.where(col(do), restart_x, s.x)
            y_new = torch.where(col(do), restart_y, s.y)
            # a no-progress restart, or the accelerated phase's budget
            # spent, reverts the lane for good
            off = off | (do & (s_cand > cfg.stall_reset_beta * s.last_score))
            off = off | (running & (s.iters >= cfg.halpern_patience))
        else:
            x_new = torch.where(col(do & avg_better), x_avg, s.x)
            y_new = torch.where(col(do & avg_better), y_avg, s.y)

        # primal weight: log-space smoothing of ||dy|| / ||dx||
        if cfg.adaptive:
            dxn = _norm(x_new - s.x_anchor)
            dyn = _norm(y_new - s.y_anchor)
            both = (dxn > 1e-12) & (dyn > 1e-12)
            ratio = torch.where(both, dyn / torch.clamp_min(dxn, 1e-30), 1.0)
            omega_prop = torch.exp(0.5 * torch.log(ratio)
                                   + 0.5 * torch.log(s.omega))
            omega_prop = torch.clamp(omega_prop, 1.0 / cfg.omega_clip,
                                     cfg.omega_clip)
            omega = torch.where(do & both, omega_prop, s.omega)
            # stall reset: a restart whose score barely moved since the
            # previous one means the adapted weight random-walks; go back
            # to the balanced weight
            stalled = do & (s_cand > cfg.stall_reset_beta * s.last_score)
            omega = torch.where(stalled, torch.ones_like(omega), omega)
        else:
            omega = s.omega

        if cfg.halpern:  # report the feasible T(z) image on termination
            final_x = torch.where(col(ok), x_cur, x_new)
            final_y = torch.where(col(ok), y_cur, y_new)
        else:
            final_x = torch.where(col(adopt_avg_final), x_avg, x_new)
            final_y = torch.where(col(adopt_avg_final), y_avg, y_new)
        return s._replace(
            x=final_x,
            y=final_y,
            x_sum=torch.where(col(do), 0.0, s.x_sum),
            y_sum=torch.where(col(do), 0.0, s.y_sum),
            inner_count=torch.where(do, 0, s.inner_count).to(torch.int32),
            status=status,
            omega=omega,
            x_anchor=torch.where(col(do), final_x, s.x_anchor),
            y_anchor=torch.where(col(do), final_y, s.y_anchor),
            last_score=torch.where(do, s_cand, s.last_score),
            halpern_off=off if cfg.halpern else s.halpern_off,
        )

    def init_state() -> PDHGState:
        x0 = project_x(torch.zeros((B, n), dtype=dt, device=dev))
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        return PDHGState(
            x=x0,
            y=torch.zeros((B, m), dtype=dt, device=dev),
            x_sum=torch.zeros((B, n), dtype=dt, device=dev),
            y_sum=torch.zeros((B, m), dtype=dt, device=dev),
            inner_count=zi,
            iters=zi.clone(),
            status=zi.clone(),
            omega=torch.full((B,), cfg.omega, dtype=dt, device=dev),
            x_anchor=x0,
            y_anchor=torch.zeros((B, m), dtype=dt, device=dev),
            last_score=torch.full((B,), float("inf"), dtype=dt, device=dev),
            halpern_off=torch.zeros((B,), dtype=torch.bool, device=dev),
        )

    def chunk(s: PDHGState) -> PDHGState:
        for _ in range(cfg.check_every):
            s = step(s)
        return s

    def run(state: PDHGState, maxiters: int) -> PDHGState:
        steps = None
        while True:
            live = (state.status == st.RUNNING) & (state.iters < maxiters)
            if not bool(live.any()):  # the one host read of a chunk
                return state
            if steps is None:
                steps = _graphed(chunk, state) if dev.type == "cuda" else chunk
            s = check_and_restart(steps(state))
            # lanes that were done before the chunk keep their state
            state = PDHGState(*(
                torch.where(live.view(-1, *([1] * (new.dim() - 1))), new,
                            old)
                for new, old in zip(s, state)))

    return init_state, run


def _solve(c, K, q, n_eq, lb, ub, maxiters, cfg):
    init_state, run = _pdhg_core(c, K, q, n_eq, lb, ub, cfg)
    return run(init_state(), int(maxiters))


def _canonicalize(c, A, b, G, h, lb, ub, dtype):
    """Host arrays of the general form stacked as ``(c, K, q, n_eq, lb,
    ub)``: equality rows first."""
    c = np.asarray(c, dtype=dtype)
    n = c.shape[0]
    rows, rhs, n_eq = [], [], 0
    if A is not None and b is not None:
        A = np.atleast_2d(np.asarray(A, dtype=dtype))
        rows.append(A)
        rhs.append(np.asarray(b, dtype=dtype))
        n_eq = A.shape[0]
    if G is not None and h is not None:
        rows.append(np.atleast_2d(np.asarray(G, dtype=dtype)))
        rhs.append(np.asarray(h, dtype=dtype))
    if not rows:
        raise ValueError("need (A, b) and/or (G, h)")
    K = np.concatenate(rows, axis=0)
    q = np.concatenate(rhs)
    lb = (np.zeros(n, dtype=dtype) if lb is None
          else np.asarray(lb, dtype=dtype))
    ub = (np.full(n, np.inf, dtype=dtype) if ub is None
          else np.asarray(ub, dtype=dtype))
    return c, K, q, n_eq, lb, ub


def _single_result(c, state: PDHGState) -> LinProgResult:
    x = state.x[0].cpu().numpy()
    code = int(state.status[0])
    return LinProgResult(
        x=x,
        basis=None,
        cost=float(c[0].cpu().numpy() @ x),
        iters=int(state.iters[0]),
        optimum=code == st.OPTIMAL,
        status=code if code != st.RUNNING else st.ITER_LIMIT,
        y=state.y[0].cpu().numpy(),
    )


class PDHGSolver:
    """First-order LP solver with the general-form input surface:
    ``min c'x  s.t.  Ax = b, Gx <= h, lb <= x <= ub`` from host arrays,
    solved on ``device`` (a card by default; ``device="cpu"`` runs on the
    host)."""

    def __init__(self, c, A=None, b=None, G=None, h=None, lb=None, ub=None,
                 config: Optional[PDHGConfig] = None, device="cuda"):
        self.config = config or DEFAULT_PDHG_CONFIG
        dev = resolve_device(device)
        c, K, q, n_eq, lb_, ub_ = _canonicalize(
            c, A, b, G, h, lb, ub, np.dtype(self.config.dtype))
        self.c, self.K, self.q, self.lb, self.ub = (
            torch.as_tensor(a, device=dev)[None] for a in (c, K, q, lb_, ub_))
        self.n_eq = n_eq

    def solve(self, maxiters: Optional[int] = None) -> LinProgResult:
        state = _solve(self.c, self.K, self.q, self.n_eq, self.lb, self.ub,
                       maxiters or self.config.maxiters, self.config)
        self._state = state
        return _single_result(self.c, state)

    @property
    def duals(self) -> np.ndarray:
        """Dual iterate ``y`` (equality rows first); solve first."""
        if not hasattr(self, "_state"):
            raise AttributeError("call solve() first")
        return self._state.y[0].cpu().numpy()


def pdhg_solve_batch(c, K, q, n_eq: int, lb, ub, maxiters: int = 100_000,
                     cfg: PDHGConfig = DEFAULT_PDHG_CONFIG) -> PDHGState:
    """Batched PDHG over same-shape instances ``c[B, n], K[B, m, n],
    q[B, m], lb/ub[B, n]`` (tensors, in their dtype, on their device).
    Returns the final :class:`PDHGState`."""
    return _solve(c, K, q, n_eq, lb, ub, maxiters, cfg)


def pdhg_solve_sparse(c, K, q, n_eq: int = 0, lb=None, ub=None,
                      maxiters: int = 100_000,
                      cfg: PDHGConfig = DEFAULT_PDHG_CONFIG,
                      device="cuda") -> LinProgResult:
    """First-order solve with a sparse constraint matrix: ``K`` a
    ``torch.sparse_coo_tensor`` ``[m, n]`` stacking equality rows (the
    first ``n_eq``) then ``<=`` rows, ``q`` the right-hand side (host
    arrays or tensors).  Matrix-free: memory and work scale with nnz.
    Runs on ``device`` (a card by default)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    K = K.coalesce()
    m, n = K.shape
    rows, cols = K.indices()
    vals = K.values().to(device=dev, dtype=dt)[None]

    def vec(a, fill):
        if a is None:
            return torch.full((1, n), fill, dtype=dt, device=dev)
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)[None]

    c = vec(c, 0.0)
    state = _solve(c, SharedPatternSparse(rows, cols, vals, m, n),
                   torch.as_tensor(np.asarray(q), dtype=dt, device=dev)[None],
                   n_eq, vec(lb, 0.0), vec(ub, float("inf")), maxiters, cfg)
    return _single_result(c, state)


def pdhg_solve_batch_sparse(c, rows, cols, vals, q, n_eq: int, lb, ub,
                            shape: tuple, maxiters: int = 100_000,
                            cfg: PDHGConfig = DEFAULT_PDHG_CONFIG
                            ) -> PDHGState:
    """Batched sparse PDHG over instances sharing one sparsity pattern:
    ``c[B, n], vals[B, nnz], q[B, m], lb/ub[B, n]`` (tensors, cast to
    ``cfg.dtype``, on ``vals``' device) with the COO pattern
    ``rows/cols[nnz]`` and ``shape = (m, n)``.  The same iteration as
    :func:`pdhg_solve_batch`; only the matvecs differ.  Returns the final
    :class:`PDHGState`."""
    m, n = shape
    dt = cfg.torch_dtype
    dev = vals.device

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    K = SharedPatternSparse(rows, cols, t(vals), m, n)
    return _solve(t(c), K, t(q), n_eq, t(lb), t(ub), maxiters, cfg)


def pdhg_solve_batch_canonical(c, G, h, maxiters: int = 100_000,
                               cfg: PDHGConfig = DEFAULT_PDHG_CONFIG):
    """Batched PDHG for canonical ``min c'x, Gx <= h, x >= 0``
    (``c[B, n], G[B, m, n], h[B, m]``) after Ruiz equilibration.  Returns
    ``(x[B, n], cost[B], status[B], iters[B])`` in the original scaling;
    a lane out of budget is ITER_LIMIT."""
    from .presolve import ruiz_equilibrate, unscale_solution

    B, m, n = G.shape
    cs, Gs, hs, sc = ruiz_equilibrate(c, G, h)
    # x >= 0 maps to z >= 0 under positive column scales
    lb = torch.zeros((B, n), dtype=G.dtype, device=G.device)
    ub = torch.full((B, n), float("inf"), dtype=G.dtype, device=G.device)
    states = _solve(cs, Gs, hs, 0, lb, ub, maxiters, cfg)
    x = unscale_solution(states.x, sc)
    cost = (c * x).sum(dim=1)
    status = torch.where(states.status == st.RUNNING, st.ITER_LIMIT,
                         states.status).to(torch.int32)
    return x, cost, status, states.iters
