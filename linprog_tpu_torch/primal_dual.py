"""The primal-dual algorithm (Papadimitriou & Steiglitz's restricted-primal
loop; counterpart of :mod:`linprog_tpu.primal_dual`).

* Start from a dual-feasible ``y``: ``y = 0`` when ``c >= 0``, otherwise
  one bounding row ``sum(x) <= n M`` is appended and
  ``y = (0, .., 0, min c)`` (P&S pg. 105);
* loop: the admissible set ``J = {j : y'A_j ~= c_j}``; solve the restricted
  primal; if its cost is positive, step the duals by ``theta`` along the
  restricted dual's direction; otherwise complementary slackness holds and
  the point is optimal.

The restricted primal is always the full-width ``[A | I]`` with an
``allowed`` column mask handed to the engine's pricing (compaction keeps
column order, so Bland's rule visits the admissible columns in the same
order).  Two routines, as in the reference: :func:`solve_primal_dual_batch`
runs every lane of a batch on the device, always with the bounding row and
with admissibility tolerances from the config; :class:`PrimalDualAlgorithm`
is the host loop over one instance, with ``np.isclose``'s tolerances.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import engine, forms
from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .ipm_sparse import resolve_device
from .results import LinProgResult
from .utils import get_bounds_on_bfs


def solve_primal_dual_batch(c, A, b, maxiters1: int = 100,
                            maxiters2: int = 100,
                            cfg: SolverConfig = DEFAULT_CONFIG):
    """The primal-dual loop on every lane of ``c[B, n], A[B, m, n],
    b[B, m]`` (standard form, ``b >= 0``; tensors on their device).

    The bounding row ``sum(x) <= n M`` is always added (harmless when
    ``min(c) >= 0``: every basic feasible solution lies below ``M``).  The
    lanes step in lockstep: each outer step solves every live lane's
    restricted primal with the per-lane engine (``allowed[B, n + m]``), and
    a lane that stopped keeps its carry.  A lane still ``RUNNING`` after
    ``maxiters1`` outer steps becomes ``ITER_LIMIT``.  Returns
    ``(x[B, n], cost[B], iters[B], status[B], y[B, m])``.
    """
    B, m0, n0 = A.shape
    dt, dev = A.dtype, A.device
    M = get_bounds_on_bfs(A, b)  # [B]
    A_x = torch.cat([A, torch.zeros((B, m0, 1), dtype=dt, device=dev)], dim=2)
    A_x = torch.cat([A_x, torch.ones((B, 1, n0 + 1), dtype=dt, device=dev)],
                    dim=1)
    b_x = torch.cat([b, (n0 * M)[:, None].to(dt)], dim=1)
    c_x = torch.cat([c, torch.zeros((B, 1), dtype=dt, device=dev)], dim=1)
    m, n = m0 + 1, n0 + 1

    y = torch.cat([torch.zeros((B, m0), dtype=dt, device=dev),
                   torch.clamp_max(c.min(dim=1).values, 0.0)[:, None]], dim=1)
    A_rp = torch.cat(
        [A_x, torch.eye(m, dtype=dt, device=dev).expand(B, m, m)], dim=2)
    c_rp = torch.cat([torch.zeros(n, dtype=dt, device=dev),
                      torch.ones(m, dtype=dt, device=dev)]).expand(B, n + m)
    art_allowed = torch.ones((B, m), dtype=torch.bool, device=dev)
    cost_tol = (cfg.feas_tol * torch.clamp_min(torch.abs(b_x).amax(dim=1), 1.0)
                * m)
    # admissibility tolerance from the config: at the default opt_tol of
    # 1e-6 these are np.isclose's atol / rtol of the host loop
    adm_atol = 0.1 * cfg.opt_tol
    adm_rtol = 10.0 * cfg.opt_tol

    counter = torch.zeros((B,), dtype=torch.int32, device=dev)
    status = torch.zeros((B,), dtype=torch.int32, device=dev)
    basis = torch.zeros((B, m), dtype=torch.int32, device=dev)
    bfs = torch.zeros((B, m), dtype=dt, device=dev)
    live = (status == st.RUNNING) & (counter < maxiters1)
    while bool(live.any()):
        admissible = (torch.abs(torch.einsum("bm,bmn->bn", y, A_x) - c_x)
                      <= adm_atol + adm_rtol * torch.abs(c_x))
        allowed = torch.cat([admissible, art_allowed], dim=1)
        state = engine.artificial_state(b_x, n)
        # a lane that stopped keeps its carry whatever its restricted
        # primal gives: start it terminal, so the engine skips it
        state = state._replace(status=torch.where(
            live, st.RUNNING, st.OPTIMAL).to(torch.int32))
        state = engine.run(c_rp, A_rp, b_x, state, allowed, maxiters2, cfg,
                           "primal")
        rp_cost = engine.current_cost(c_rp, state)
        y_r = engine.duals(c_rp, state)
        feasible = rp_cost <= cost_tol
        dual_unb = (torch.einsum("bm,bmn->bn", y_r, A_rp)
                    <= cfg.feas_tol).all(dim=1)
        num = c_x - torch.einsum("bm,bmn->bn", y, A_x)
        den = torch.einsum("bm,bmn->bn", y_r, A_x)
        step_ok = (den > cfg.pivot_tol) & ~admissible
        ratios = torch.where(
            step_ok, num / torch.where(den > cfg.pivot_tol, den, 1.0),
            float("inf"))
        theta = ratios.amin(dim=1)
        no_step = ~torch.isfinite(theta)
        new_status = torch.where(
            feasible, st.OPTIMAL,
            torch.where(dual_unb | no_step, st.DUAL_UNBOUNDED, st.RUNNING))
        stay = feasible | dual_unb | no_step
        y_new = torch.where(stay[:, None], y, y + theta[:, None] * y_r)

        y = torch.where(live[:, None], y_new, y)
        status = torch.where(live, new_status, status).to(torch.int32)
        counter = torch.where(live, counter + 1, counter)
        basis = torch.where(live[:, None], state.basis, basis)
        bfs = torch.where(live[:, None], state.bfs, bfs)
        live = (status == st.RUNNING) & (counter < maxiters1)
    status = torch.where(status == st.RUNNING, st.ITER_LIMIT,
                         status).to(torch.int32)

    structural = basis < n
    x_full = torch.zeros((B, n), dtype=dt, device=dev)
    x_full.scatter_add_(1, torch.where(structural, basis, n - 1).long(),
                        torch.where(structural, bfs, 0.0))
    x = x_full[:, :n0]  # the bounding variable left out
    cost = (c * x).sum(dim=1)
    return x, cost, counter, status, y[:, :m0]


class PrimalDualAlgorithm:
    """The primal-dual algorithm on one instance (no starting basis
    needed), from host arrays, on ``device`` (a card by default;
    ``device="cpu"`` runs on the host)."""

    def __init__(self, c, A, b, config: Optional[SolverConfig] = None,
                 device="cuda"):
        self.config = config or DEFAULT_CONFIG
        self.device = resolve_device(device)
        dtype = np.dtype(self.config.dtype)
        self.c, self.A, self.b = forms.preprocess_problem(c, A, b, dtype)
        self.m, self.n = self.A.shape
        self.counter = 0
        self.optimum = False

    def solve(self, maxiters1: int = 100, maxiters2: int = 100
              ) -> LinProgResult:
        cfg = self.config
        dtype = np.dtype(cfg.dtype)
        dev = self.device
        c, A, b = self.c.copy(), self.A.copy(), self.b.copy()
        m, n = A.shape

        # dual-feasible start: y = 0 needs c >= 0; otherwise the bounding
        # row sum(x) <= n M (one more variable and row) and
        # y = (0, ..., 0, min c)
        y = np.zeros(m, dtype=dtype)
        expanded = False
        if c.min() < 0:
            expanded = True
            M = float(get_bounds_on_bfs(torch.as_tensor(A),
                                        torch.as_tensor(b)))
            c = np.concatenate([c, np.zeros(1, dtype=dtype)])
            A = np.block(
                [
                    [A, np.zeros((m, 1), dtype=dtype)],
                    [np.ones((1, n + 1), dtype=dtype)],
                ]
            )
            b = np.concatenate([b, np.array([n * M], dtype=dtype)])
            m, n = A.shape
            y = np.concatenate([y, np.full(1, c.min(), dtype=dtype)])

        # the full-width restricted primal [A | I], artificial costs
        A_rp_np = np.concatenate([A, np.eye(m, dtype=dtype)], axis=1)
        A_rp = torch.tensor(A_rp_np, device=dev)[None]
        c_rp = torch.cat([torch.zeros(n, dtype=A_rp.dtype, device=dev),
                          torch.ones(m, dtype=A_rp.dtype, device=dev)])[None]
        b_dev = torch.tensor(b, device=dev)[None]
        art_allowed = torch.ones(m, dtype=torch.bool, device=dev)

        scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
        cost_tol = cfg.feas_tol * scale * max(1, m)

        self.counter = 0
        self.optimum = False
        state = None
        while self.counter < maxiters1:
            self.counter += 1
            # admissible columns: y'A_j ~= c_j
            ya = y @ A
            admissible = np.isclose(ya, c, rtol=1e-5, atol=1e-7)
            allowed = torch.cat([torch.tensor(admissible, device=dev),
                                 art_allowed])
            state = engine.artificial_state(b_dev, n)
            state = engine.run(c_rp, A_rp, b_dev, state, allowed, maxiters2,
                               cfg, "primal")
            rp_cost = float(engine.current_cost(c_rp, state)[0])

            if rp_cost > cost_tol:
                # the restricted dual's direction y_r = c_B inv_B
                y_r = engine.duals(c_rp, state)[0].cpu().numpy()
                if np.all(y_r @ A_rp_np <= cfg.feas_tol):
                    raise st.DualIsUnboundedError(
                        "restricted dual is unbounded: primal is infeasible"
                    )
                num = c - y @ A
                den = y_r @ A
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratios = np.where(den > cfg.pivot_tol, num / den, np.inf)
                theta = float(np.min(ratios[~admissible]))
                if not np.isfinite(theta):
                    raise st.DualIsUnboundedError(
                        "no admissible dual step: primal is infeasible"
                    )
                y = y + theta * y_r
            else:
                self.optimum = True
                break

        # x in the original space: basis entries < n are columns of A
        basis = state.basis[0].cpu().numpy()
        bfs = state.bfs[0].cpu().numpy()
        x = np.zeros(n, dtype=dtype)
        structural = basis < n
        x[basis[structural]] = bfs[structural]
        out_basis = np.sort(basis[structural])

        if expanded:
            out_basis = out_basis[out_basis != n - 1]
            x = x[:-1]

        cost = float(self.c @ x)
        return LinProgResult(
            x=x,
            basis=out_basis,
            cost=cost,
            iters=self.counter,
            optimum=self.optimum,
            status=st.OPTIMAL if self.optimum else st.ITER_LIMIT,
        )
