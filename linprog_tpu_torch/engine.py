"""Simplex state helpers and the per-lane revised-simplex engine
(counterpart of :mod:`linprog_tpu.engine`).

The reference writes its engine per lane and lifts it with ``vmap``; here
every function takes the batch dimension explicitly and runs the lanes side
by side.  :func:`run` drives :func:`primal_step` or :func:`dual_step` until
each lane is terminal or at ``maxiters``, with exactly the semantics of the
reference's vmapped ``lax.while_loop``: a lane that has stopped is frozen by
a select, the counter increments on the entry that detects optimality, and
``maxiters`` leaves a lane ``RUNNING``.  With ``refactor_every > 0`` and eta
updates every lane refactorizes on its OWN cadence (every
``refactor_every`` of its own pivots), not on the batched loop's minimum
over running lanes.  This is the plain-PyTorch parity engine behind
``kernels="torch"`` in dual mode; it has data-dependent control flow and is
not written for the card's speed.

A singular basis gives a status, never an exception: inversions go through
:func:`inv_or_nan` and :func:`solve_or_nan`, which turn a nonzero LAPACK
``info`` into NaN factors (``jnp.linalg.inv`` returns non-finite values
where ``torch.linalg.inv`` would raise).  A lane whose refactorization is
singular then runs on NaN factors as the reference's does: no entering
column or leaving row is eligible, so it stops as ``OPTIMAL`` with NaN
values, and the terminal solves downstream catch it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .observability import current, span
from .ops import lu_kernel


class SimplexState(NamedTuple):
    """Batched solver state: ``basis[B, m]`` i32 (column of A at each basis
    position), ``inv_B[B, m, m]`` (inverse of ``A[:, basis]``), ``bfs[B, m]``
    (basic values), ``iters[B]`` i32, ``status[B]`` i32."""

    basis: torch.Tensor
    inv_B: torch.Tensor
    bfs: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor


# Past this many rows (or summed columns) an f32 factorization or normal
# product is computed in float64 and rounded to f32.  The card's f32 LU and
# GEMM are IEEE f32, but their error grows with the length of their sums.
# On the m = 4096 exact leg (H100, tools/diag_m4096.py) the f32 basis
# inverses left the crossover's pricing so far off that two of four lanes
# ran 4096 dual pivots without finishing and the two that crossed failed the
# certificate; with the inverses formed in float64 all four crossed in at
# most 385 pivots and certified.  Every size up to 2048 keeps f32.
F64_PAST = 2048


def _wide(M):
    """``M`` in float64 where an f32 factorization of it would be too
    inaccurate (see ``F64_PAST``), else ``M``."""
    if M.dtype == torch.float32 and M.shape[-1] > F64_PAST:
        return M.double()
    return M


# CUDA calls of inv_or_nan / solve_or_nan that went to torch.linalg (the
# kernel's own launches are ops.lu_kernel.launches)
library_calls = 0


def _library(W) -> None:
    global library_calls
    if W.is_cuda:
        library_calls += 1


def _library_span(op: str, W):
    """A span ``lu_library`` around one factorization that goes to
    ``torch.linalg``: its ``op`` (``"inv"`` or ``"solve"``), the factored
    matrices' ``shape``, ``dtype`` and ``device`` type."""
    sp = span("lu_library")
    if sp:
        sp.set(op=op, shape=tuple(W.shape), dtype=str(W.dtype)[6:],
               device=W.device.type)
    return sp


def inv_or_nan(M):
    """Batched inverse; lanes whose factorization fails come back NaN.
    float32 CUDA lanes up to ``lu_kernel.MAX_M`` take the batched LU kernel
    (one launch), every other tensor ``torch.linalg``."""
    W = _wide(M)
    if lu_kernel.takes(W.device.type, W.dtype, W.shape[-1]):
        return lu_kernel.inverse(W)
    _library(W)
    with _library_span("inv", W):
        inv, info = torch.linalg.inv_ex(W)
        return torch.where((info != 0)[:, None, None], float("nan"),
                           inv.to(M.dtype))


def solve_or_nan(M, rhs):
    """Batched ``M x = rhs`` for ``rhs[B, m]``; failed lanes come back NaN.
    Routed as :func:`inv_or_nan`; the kernel forms no inverse."""
    W = _wide(M)
    if lu_kernel.takes(W.device.type, W.dtype, W.shape[-1]):
        return lu_kernel.solve(W, rhs.to(W.dtype))
    _library(W)
    with _library_span("solve", W):
        x, info = torch.linalg.solve_ex(W, rhs.to(W.dtype)[:, :, None])
        return torch.where((info != 0)[:, None], float("nan"),
                           x[:, :, 0].to(M.dtype))


def noting_lu(fn):
    """``fn`` noting on the span open around each call (the entry point's
    own) the batched LU's work inside the call: ``lu_launches``, the
    kernel's launches, and ``lu_library``, the CUDA factorizations that
    went to ``torch.linalg``."""
    @functools.wraps(fn)
    def inner(*args, **kw):
        sp = current()
        if not sp:
            return fn(*args, **kw)
        launched, library = lu_kernel.launches, library_calls
        try:
            return fn(*args, **kw)
        finally:
            sp.set(lu_launches=lu_kernel.launches - launched,
                   lu_library=library_calls - library)
    return inner


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


# ---------------------------------------------------------------------------
# The per-lane engine, batch dimension explicit
# ---------------------------------------------------------------------------


def tree_select(pred, on_true, on_false):
    """Per-lane select over the fields of two states: ``pred[B]`` bool picks
    lane ``b`` of ``on_true`` where it holds, of ``on_false`` elsewhere."""
    def sel(t, f):
        p = pred.reshape(pred.shape + (1,) * (t.dim() - 1))
        return torch.where(p, t, f)

    return type(on_true)(*(sel(t, f) for t, f in zip(on_true, on_false)))


def artificial_state(b, n: int) -> SimplexState:
    """All-artificial basis of ``[A | I]`` (the Phase-I start): ``inv_B = I``
    and ``bfs = b`` exactly, no inversion.  Requires ``b >= 0``."""
    B, m = b.shape
    dev = b.device
    return SimplexState(
        basis=torch.arange(n, n + m, dtype=torch.int32,
                           device=dev).expand(B, m).contiguous(),
        inv_B=torch.eye(m, dtype=b.dtype, device=dev).expand(B, m, m).clone(),
        bfs=b.clone(),
        iters=torch.zeros((B,), dtype=torch.int32, device=dev),
        status=torch.zeros((B,), dtype=torch.int32, device=dev),
    )


def reduced_costs(c, A, state: SimplexState):
    """``r = c - (c_B inv_B) A`` per lane, with basis entries exactly 0."""
    r = c - torch.einsum("bm,bmn->bn", duals(c, state), A)
    return torch.where(in_basis_mask(state.basis, c.shape[1]), 0.0, r)


def current_cost(c, state: SimplexState):
    """``c_B . bfs`` per lane: ``[B]``."""
    return (torch.gather(c, 1, state.basis.long()) * state.bfs).sum(dim=1)


def basis_is_primal_feasible(A, b, basis, tol: float):
    """bool ``[B]``: ``inv(A[:, basis]) b >= -tol`` (False where singular)."""
    x = torch.einsum("bmk,bk->bm", inv_or_nan(basis_matrix(A, basis)), b)
    return (x >= -tol).all(dim=1)


def basis_is_dual_feasible(c, A, basis, tol: float):
    """bool ``[B]``: ``y A <= c + tol`` for ``y = c_B inv(A[:, basis])``
    (False where singular)."""
    inv_B = inv_or_nan(basis_matrix(A, basis))
    y = torch.bmm(torch.gather(c, 1, basis.long())[:, None, :], inv_B)[:, 0]
    return (torch.einsum("bm,bmn->bn", y, A) <= c + tol).all(dim=1)


def _lane_pick(v, idx):
    """``v[b, idx[b]]`` for ``v[B, k]``: ``[B]``."""
    return torch.gather(v, 1, idx.long()[:, None])[:, 0]


def _gather_cols(A, idx):
    """``A[b, :, idx[b]]`` for each lane: ``[B, m]``."""
    B, m, _ = A.shape
    cols = idx.long()[:, None, None].expand(B, m, 1)
    return torch.gather(A, 2, cols)[:, :, 0]


def _eta(d, leave, safe):
    """The eta column ``u = -d / d_l`` with ``u_l = 1 / d_l - 1``."""
    u = -d / safe[:, None]
    return u.scatter(1, leave.long()[:, None], (1.0 / safe - 1.0)[:, None])


def _rank1(inv_B, bfs, u, leave):
    """``inv_B + u (x) inv_B[leave, :]`` and ``bfs + u bfs[leave]``."""
    B, m, _ = inv_B.shape
    row = torch.gather(inv_B, 1, leave.long()[:, None, None].expand(B, 1, m))
    return (inv_B + u[:, :, None] * row,
            bfs + u * _lane_pick(bfs, leave)[:, None])


def _set_basis(basis, leave, enter):
    return basis.scatter(1, leave.long()[:, None],
                         enter.to(torch.int32)[:, None])


def eta_update(inv_B, bfs, d, leave):
    """Product-form update of ``inv_B`` and ``bfs`` for a pivot on row
    ``leave[B]`` with direction ``d[B, m]``, as a rank-1 outer product."""
    d_l = _lane_pick(d, leave)
    safe = torch.where(d_l == 0, 1.0, d_l)
    return _rank1(inv_B, bfs, _eta(d, leave, safe), leave)


def apply_pivot(A, b, state: SimplexState, leave, enter, cfg: SolverConfig,
                d=None) -> SimplexState:
    """Pivot ``basis[leave] <- enter`` on every lane (``leave``, ``enter``:
    ``[B]``) and update the factors by ``cfg.update``: a fresh inversion
    (``"naive"``) or the eta update (``d`` may pass in the direction
    ``inv_B A[:, enter]`` already computed)."""
    basis = _set_basis(state.basis, leave, enter)
    if cfg.update == "naive":
        inv_B = inv_or_nan(basis_matrix(A, basis))
        bfs = torch.einsum("bmk,bk->bm", inv_B, b)
    else:
        if d is None:
            d = torch.einsum("bmk,bk->bm", state.inv_B,
                             _gather_cols(A, enter))
        inv_B, bfs = eta_update(state.inv_B, state.bfs, d, leave)
    return state._replace(basis=basis, inv_B=inv_B, bfs=bfs)


def pivot(A, b, state: SimplexState, leave, enter,
          cfg: SolverConfig = DEFAULT_CONFIG) -> SimplexState:
    """One explicit pivot on every lane (the reference's ``pivot_jit``)."""
    return apply_pivot(A, b, state, leave, enter, cfg)


def _masked_pivot(A, b, state: SimplexState, leave, enter, d, do_pivot,
                  cfg: SolverConfig) -> SimplexState:
    """Pivot the lanes where ``do_pivot`` holds.  Eta updates zero the eta
    column elsewhere, so the rank-1 update leaves those lanes as they are
    (as the reference does: no select over the factor); the naive update
    selects whole states."""
    if cfg.update == "naive":
        pivoted = apply_pivot(A, b, state, leave, enter, cfg)
        return tree_select(do_pivot, pivoted, state)
    d_l = _lane_pick(d, leave)
    safe = torch.where(torch.abs(d_l) > 0, d_l, 1.0)
    u = torch.where(do_pivot[:, None], _eta(d, leave, safe), 0.0)
    inv_B, bfs = _rank1(state.inv_B, state.bfs, u, leave)
    basis = torch.where(do_pivot[:, None],
                        _set_basis(state.basis, leave, enter), state.basis)
    return state._replace(basis=basis, inv_B=inv_B, bfs=bfs)


def refactorize(A, b, state: SimplexState) -> SimplexState:
    """Fresh ``inv_B`` and ``bfs`` on every lane (NaN where singular)."""
    inv_B = inv_or_nan(basis_matrix(A, state.basis))
    return state._replace(inv_B=inv_B,
                          bfs=torch.einsum("bmk,bk->bm", inv_B, b))


def primal_step(c, A, b, allowed, state: SimplexState,
                cfg: SolverConfig) -> SimplexState:
    """One primal iteration on every lane: price, enter, ratio test, pivot.

    The optimality tolerance is ``opt_tol * max(1, max|c|)`` per lane, as in
    the reference's per-lane engine.  ``allowed`` (bool ``[n]`` or
    ``[B, n]``) masks the columns that may enter.  Dantzig enters the most
    negative eligible reduced cost, Bland the first; the leaving row is the
    first minimum ratio over ``bfs`` clamped at zero."""
    if cfg.pricing == "devex":
        raise ValueError(
            "pricing='devex' is not implemented on the per-lane engine -- "
            "use pricing='dantzig'/'bland' here (devex runs on the "
            "whole-segment kernel and the per-step loop)"
        )
    r = reduced_costs(c, A, state)
    tol = cfg.opt_tol * torch.clamp_min(torch.abs(c).max(dim=1).values, 1.0)
    eligible = (r < -tol[:, None]) & allowed
    any_elig = eligible.any(dim=1)
    if cfg.pricing == "dantzig":
        enter = torch.where(eligible, r, float("inf")).argmin(dim=1)
    else:  # bland: the first eligible column
        enter = eligible.to(torch.int8).argmax(dim=1)

    d = torch.einsum("bmk,bk->bm", state.inv_B, _gather_cols(A, enter))
    pos = d > cfg.pivot_tol
    unbounded = any_elig & ~pos.any(dim=1)
    bfs_nn = torch.clamp_min(state.bfs, 0.0) + 0.0
    theta = torch.where(pos, bfs_nn / torch.where(pos, d, 1.0), float("inf"))
    leave = theta.argmin(dim=1)

    out = _masked_pivot(A, b, state, leave, enter, d,
                        any_elig & ~unbounded, cfg)
    status = torch.where(~any_elig, st.OPTIMAL,
                         torch.where(unbounded, st.PRIMAL_UNBOUNDED,
                                     st.RUNNING))
    return out._replace(status=status.to(torch.int32),
                        iters=state.iters + 1)


def dual_step(c, A, b, allowed, state: SimplexState,
              cfg: SolverConfig) -> SimplexState:
    """One dual iteration on every lane.  Leaving row: Dantzig the most
    negative ``bfs``, Bland the first ``bfs < -feas_tol``.  Ratio test: the
    first minimum of ``-r / u`` over ``u < -pivot_tol`` (``u`` the leaving
    row of ``inv_B A``, basic columns zeroed).  No candidate means the
    primal is infeasible: ``DUAL_UNBOUNDED``."""
    if cfg.pricing == "devex":
        raise ValueError(
            "pricing='devex' has no dual-engine implementation anywhere "
            "(the reference rule is a primal pricing rule); use "
            "pricing='dantzig'/'bland' for dual solves"
        )
    B, m, n = A.shape
    neg = state.bfs < -cfg.feas_tol
    any_neg = neg.any(dim=1)
    if cfg.pricing == "dantzig":  # the most infeasible row
        leave = state.bfs.argmin(dim=1)
    else:  # bland: the first infeasible row
        leave = neg.to(torch.int8).argmax(dim=1)

    row = torch.gather(state.inv_B, 1,
                       leave[:, None, None].expand(B, 1, m))[:, 0]
    u = torch.einsum("bm,bmn->bn", row, A)
    u = torch.where(in_basis_mask(state.basis, n), 0.0, u)
    cand = (u < -cfg.pivot_tol) & allowed
    unbounded = any_neg & ~cand.any(dim=1)

    r = reduced_costs(c, A, state)
    theta = torch.where(cand, -r / torch.where(cand, u, -1.0), float("inf"))
    enter = theta.argmin(dim=1)

    d = torch.einsum("bmk,bk->bm", state.inv_B, _gather_cols(A, enter))
    out = _masked_pivot(A, b, state, leave, enter, d,
                        any_neg & ~unbounded, cfg)
    status = torch.where(~any_neg, st.OPTIMAL,
                         torch.where(unbounded, st.DUAL_UNBOUNDED,
                                     st.RUNNING))
    return out._replace(status=status.to(torch.int32),
                        iters=state.iters + 1)


_STEP_FNS = {"primal": primal_step, "dual": dual_step}


def live_lanes(state, hi):
    """bool ``[B]``: lanes still ``RUNNING`` and below ``hi`` iterations
    (``hi`` an int or a per-lane tensor)."""
    return (state.status == st.RUNNING) & (state.iters < hi)


def run_lanes(step, refresh, state, maxiters, refactor_every: int):
    """The per-lane loop shared by the simplex and bounded engines.

    ``step(state)`` advances every lane once; only the live lanes keep the
    result.  With ``refactor_every > 0`` each lane runs chunks of its own:
    ``hi = min(iters + refactor_every, maxiters)`` from the lane's count at
    the start of the chunk, then ``refresh(state)`` replaces the lanes that
    ran the chunk and are still ``RUNNING``.  One pass of the outer loop is
    one outer iteration of the reference's vmapped loop, so lanes that
    stopped earlier are never refreshed again."""
    def advance(s, hi):
        go = live_lanes(s, hi)
        while bool(go.any()):
            s = tree_select(go, step(s), s)
            go = live_lanes(s, hi)
        return s

    if refactor_every <= 0:
        return advance(state, maxiters)
    active = live_lanes(state, maxiters)
    while bool(active.any()):
        # a lane that is not active is not live below its hi either
        hi = torch.clamp_max(state.iters + refactor_every, maxiters)
        state = advance(state, hi)
        fresh = refresh(state)
        state = tree_select(active & (state.status == st.RUNNING), fresh,
                            state)
        active = live_lanes(state, maxiters)
    return state


def run(c, A, b, state: SimplexState, allowed, maxiters,
        cfg: SolverConfig = DEFAULT_CONFIG, mode: str = "primal"
        ) -> SimplexState:
    """Drive every lane to a terminal status or ``maxiters`` (the
    reference's ``jax.vmap(engine.run)``): ``mode`` is ``"primal"`` or
    ``"dual"``; ``allowed`` bool ``[n]`` or ``[B, n]``; ``maxiters`` an int
    or an i32 tensor.  Refactorizes each lane every ``cfg.refactor_every``
    of its own pivots under eta updates."""
    step_fn = _STEP_FNS[mode]
    chunk = cfg.refactor_every if cfg.update == "eta" else 0
    return run_lanes(lambda s: step_fn(c, A, b, allowed, s, cfg),
                     lambda s: refactorize(A, b, s), state, maxiters, chunk)
