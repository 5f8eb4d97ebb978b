"""Plain reference: a textbook bounded-variable primal simplex, batched.

``min c'z  s.t.  A z = b,  lb <= z <= ub`` (``ub`` may be ``inf``), every
lane from scratch: the crash basis takes each row's slack column where
its value lies within its bounds and an artificial variable elsewhere;
Phase I minimises the sum of the artificials, Phase II the objective with
the artificials fixed at zero.  Dantzig pricing on the bound-aware reduced
costs, the three-way ratio test (a basic variable reaches its lower or its
upper bound, or the entering variable crosses to its other bound), an
explicit inverse with a rank-1 update and an exact re-inversion every
``refactor_every`` pivots; a lane that makes ``stall_limit`` degenerate
pivots in a row prices by Bland's rule until it moves again.  Lanes run in
lockstep; each lane's answer is its own.

This is plain PyTorch in float64 and shares no code with the program.  It
runs on the card after the measured window.  With ``tf32=True`` it is the
control: float32, every product's inputs rounded to TF32 (10 mantissa
bits, as the card's TF32 path reads them), f32 tolerances.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

AT_LB, AT_UB, BASIC = 0, 1, 2
# outcome classes, shared with the comparison
OPTIMAL, INFEASIBLE, UNBOUNDED, NO_ANSWER = "optimal", "infeasible", \
    "unbounded", "none"


class RefResult(NamedTuple):
    """Per lane: ``outcome`` (list of class names), ``x[B, n]`` (the
    original columns), ``cost[B]``, ``basis[B, m]`` (sorted), ``vstate[B,
    n]``, ``iters[B]``."""

    outcome: list
    x: torch.Tensor
    cost: torch.Tensor
    basis: torch.Tensor
    vstate: torch.Tensor
    iters: torch.Tensor


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (8 exponent bits, 10 mantissa bits),
    to nearest with ties away from zero, as the card converts them."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Arith:
    """Products in the reference's precision."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        # opt, pivot and feasibility tolerances, relative to the data scale
        self.tol = 1e-5 if tf32 else 1e-9

    def r(self, t):
        return tf32_round(t) if self.tf32 else t

    def matvec(self, M, v):  # [B, p, q] @ [B, q] -> [B, p]
        return torch.bmm(self.r(M), self.r(v)[:, :, None])[:, :, 0]

    def vecmat(self, v, M):  # [B, p] @ [B, p, q] -> [B, q]
        return torch.bmm(self.r(v)[:, None, :], self.r(M))[:, 0, :]


def _inverse(Bm):
    inv, info = torch.linalg.inv_ex(Bm)
    return inv, info == 0


def solve(c, A, b, lb, ub, *, slack_start: int, maxiters: int,
          tf32: bool = False, refactor_every: int = 64,
          stall_limit: int = 32, check_every: int = 16) -> RefResult:
    """Solve every lane of ``c[B, n], A[B, m, n], b[B, m], lb[B, n],
    ub[B, n]``.  Columns ``slack_start .. slack_start + m - 1`` are the
    rows' slack columns (``+-e_i``), with ``lb = 0`` there."""
    ar = _Arith(tf32)
    dt, dev = ar.dtype, A.device
    c, A, b, lb, ub = (t.to(dt) for t in (c, A, b, lb, ub))
    Bn, m, n = A.shape
    lanes = torch.arange(Bn, device=dev)
    rows = torch.arange(m, device=dev)
    scale = torch.clamp_min(torch.abs(b).amax(dim=1), 1.0)  # [B]
    cscale = torch.clamp_min(torch.abs(c).amax(dim=1), 1.0)

    # ---- crash basis: a row's slack where feasible, else an artificial --
    x_n0 = torch.where(torch.isfinite(lb), lb, 0.0)
    resid = b - ar.matvec(A, x_n0)
    slack_cols = slack_start + rows
    a_diag = A[:, rows, slack_cols]  # [B, m], +-1
    s_val = resid / a_diag
    use_slack = s_val >= 0
    sign = torch.where(resid >= 0, 1.0, -1.0).to(dt)
    art = torch.diag_embed(sign)  # [B, m, m]: column i is sign_i e_i
    Aext = torch.cat([A, art], dim=2)  # [B, m, n + m]
    N = n + m
    lb_e = torch.cat([lb, torch.zeros((Bn, m), dtype=dt, device=dev)], 1)
    ub1 = torch.cat([ub, torch.full((Bn, m), float("inf"), dtype=dt,
                                     device=dev)], 1)
    ub2 = torch.cat([ub, torch.zeros((Bn, m), dtype=dt, device=dev)], 1)
    c1 = torch.cat([torch.zeros((Bn, n), dtype=dt, device=dev),
                    torch.ones((Bn, m), dtype=dt, device=dev)], 1)
    c2 = torch.cat([c, torch.zeros((Bn, m), dtype=dt, device=dev)], 1)

    basis = torch.where(use_slack, slack_cols, n + rows)  # [B, m] long
    vstate = torch.full((Bn, N), AT_LB, dtype=torch.int8, device=dev)
    vstate.scatter_(1, basis, BASIC)
    inv = torch.diag_embed(1.0 / torch.where(use_slack, a_diag, sign))
    xB = torch.where(use_slack, s_val, torch.abs(resid))

    phase1 = (~use_slack).any(dim=1)  # lanes with an artificial basic
    active = torch.ones(Bn, dtype=torch.bool, device=dev)
    outcome = torch.zeros(Bn, dtype=torch.int8, device=dev)  # 0 none yet
    iters = torch.zeros(Bn, dtype=torch.int64, device=dev)
    stall = torch.zeros(Bn, dtype=torch.int64, device=dev)
    OUT_OPT, OUT_INF, OUT_UNB = 1, 2, 3

    def nonbasic_values(vs, ub_cur):
        return torch.where(vs == AT_UB, ub_cur, torch.where(
            vs == BASIC, torch.zeros_like(lb_e), lb_e))

    def refactor(basis, vstate, ub_cur):
        Bm = torch.gather(Aext, 2, basis[:, None, :].expand(Bn, m, m))
        inv, ok = _inverse(Bm)
        rhs = b - ar.matvec(Aext, nonbasic_values(vstate, ub_cur))
        return inv, ar.matvec(inv, rhs), ok

    k = 0
    while True:
        if k % check_every == 0 and not bool(active.any()):
            break
        k += 1
        ub_cur = torch.where(phase1[:, None], ub1, ub2)
        cost = torch.where(phase1[:, None], c1, c2)
        cB = torch.gather(cost, 1, basis)
        y = ar.vecmat(cB, inv)  # y' = c_B' B^-1
        d = cost - ar.vecmat(y, Aext)  # reduced costs
        fixed = (ub_cur - lb_e) <= 0
        tol = ar.tol * torch.where(phase1, 1.0, cscale)[:, None]
        inc = (vstate == AT_LB) & (d < -tol) & ~fixed
        dec = (vstate == AT_UB) & (d > tol) & ~fixed
        elig = inc | dec
        has = elig.any(dim=1)
        bland = stall >= stall_limit
        q_dantzig = torch.where(elig, torch.abs(d), -1.0).argmax(dim=1)
        q_bland = elig.to(torch.int32).argmax(dim=1)  # first eligible
        q = torch.where(bland, q_bland, q_dantzig)
        sigma = torch.where(inc[lanes, q], 1.0, -1.0).to(dt)

        aq = Aext[lanes, :, q]  # [B, m]
        alpha = ar.matvec(inv, aq)
        sa = sigma[:, None] * alpha
        lbB = torch.gather(lb_e, 1, basis)
        ubB = torch.gather(ub_cur, 1, basis)
        ptol = ar.tol * torch.clamp_min(torch.abs(alpha).amax(dim=1), 1.0)
        ptol = ptol[:, None]
        t_dec = torch.where(sa > ptol, torch.clamp_min(xB - lbB, 0.0) / sa,
                            float("inf"))
        t_inc = torch.where(sa < -ptol,
                            torch.clamp_min(ubB - xB, 0.0) / (-sa),
                            float("inf"))
        t_rows = torch.minimum(t_dec, t_inc)
        t_row, r = t_rows.min(dim=1)
        t_flip = ub_cur[lanes, q] - lb_e[lanes, q]
        flip = t_flip <= t_row
        t = torch.minimum(t_row, t_flip)
        unbounded = has & torch.isinf(t)
        move = active & has & ~unbounded

        # ---- lanes that stop ------------------------------------------
        done_now = active & ~has
        if phase1.any():
            art_sum = torch.where(basis >= n, xB, 0.0).sum(dim=1)
            infeasible = done_now & phase1 & (art_sum > ar.tol * 10 * scale
                                              * m)
            to_phase2 = done_now & phase1 & ~infeasible
        else:
            infeasible = torch.zeros_like(done_now)
            to_phase2 = infeasible
        optimal = done_now & ~phase1
        outcome = torch.where(infeasible, OUT_INF, outcome)
        outcome = torch.where(optimal, OUT_OPT, outcome)
        outcome = torch.where(active & unbounded & ~phase1, OUT_UNB, outcome)
        stop = infeasible | optimal | (active & unbounded)
        phase1 = phase1 & ~to_phase2

        # ---- the pivot or the flip, on the moving lanes -----------------
        t_safe = torch.where(move, torch.where(torch.isinf(t), 0.0, t), 0.0)
        xB = xB - sa * t_safe[:, None]
        pivot = move & ~flip
        flip_now = move & flip
        vq = vstate[lanes, q]
        vstate[lanes, q] = torch.where(
            flip_now, torch.where(vq == AT_LB, AT_UB, AT_LB).to(torch.int8),
            vq)
        entering_val = torch.where(sigma > 0, lb_e[lanes, q],
                                   ub_cur[lanes, q]) + sigma * t_safe
        leave_ub = t_inc[lanes, r] <= t_dec[lanes, r]
        p = basis[lanes, r]
        vp = vstate[lanes, p]
        vstate[lanes, p] = torch.where(
            pivot, torch.where(leave_ub, AT_UB, AT_LB).to(torch.int8), vp)
        vstate[lanes, q] = torch.where(pivot, BASIC, vstate[lanes, q]).to(
            torch.int8)
        xB[lanes, r] = torch.where(pivot, entering_val, xB[lanes, r])
        basis[lanes, r] = torch.where(pivot, q, p)
        piv = alpha[lanes, r]
        row_r = inv[lanes, r, :] / torch.where(pivot, piv, 1.0)[:, None]
        upd = inv - alpha[:, :, None] * row_r[:, None, :]
        upd[lanes, r, :] = row_r
        inv = torch.where(pivot[:, None, None], upd, inv)

        stall = torch.where(move & (t_safe <= 0), stall + 1,
                            torch.zeros_like(stall))
        iters = iters + move.to(torch.int64)
        active = active & ~stop & (iters < maxiters)
        if k % refactor_every == 0 or to_phase2.any():
            ub_cur = torch.where(phase1[:, None], ub1, ub2)
            inv_f, xB_f, ok = refactor(basis, vstate, ub_cur)
            inv = torch.where(ok[:, None, None], inv_f, inv)
            xB = torch.where(ok[:, None], xB_f, xB)

    # ---- the answer at the final basis, solved exactly ------------------
    ub_cur = torch.where(phase1[:, None], ub1, ub2)
    inv, xB, ok = refactor(basis, vstate, ub_cur)
    x = nonbasic_values(vstate, ub_cur)
    x = x.scatter(1, basis, xB)[:, :n]
    cost = (ar.r(c) * ar.r(x)).sum(dim=1)
    names = {0: NO_ANSWER, OUT_OPT: OPTIMAL, OUT_INF: INFEASIBLE,
             OUT_UNB: UNBOUNDED}
    outcome = torch.where(ok, outcome, 0)
    return RefResult(
        outcome=[names[int(v)] for v in outcome.tolist()],
        x=x, cost=cost,
        basis=torch.sort(basis, dim=1).values,
        vstate=vstate[:, :n], iters=iters)
