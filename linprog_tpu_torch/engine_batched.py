"""Batched simplex loop over the segment kernel
(counterpart of the kernel half of :mod:`linprog_tpu.engine_batched`).

:func:`run_batched` runs the whole-segment kernel
(:func:`linprog_tpu_torch.ops.solve_kernel.solve_segment`) in segments of
``cfg.refactor_every`` iterations and refactorizes the still-running lanes
exactly in between, to bound eta-product drift.  The reference's XLA
fallback path is not part of the port: a shape or mode the kernel does not
take raises ``NotImplementedError`` instead of running something else.
"""

from __future__ import annotations

import torch

from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .engine import SimplexState, basis_matrix, inv_or_nan
from .ops.solve_kernel import SegmentState, solve_segment

_PRICING_CODES = {"bland": 0, "dantzig": 1, "devex": 2}


def batched_in_basis_penalty(basis, n: int, allowed):
    """f32 ``[B, n]`` penalty: +inf on basis columns and disallowed columns."""
    B = basis.shape[0]
    pen = torch.zeros((B, n), dtype=torch.float32, device=basis.device)
    pen.scatter_(1, basis.long(), float("inf"))
    return torch.where(allowed[None, :], pen, float("inf"))


def _finite_lanes(inv_B, bfs):
    """bool ``[B]``: lanes whose refreshed factors are all finite (a
    singular basis inverts to NaN; such lanes freeze as NUMERICAL_ERROR)."""
    return (torch.isfinite(inv_B).all(dim=2).all(dim=1)
            & torch.isfinite(bfs).all(dim=1))


def compact_refactorize(A, b, basis, run):
    """Exact refactorization of the running lanes only.

    Gathers the lanes flagged in ``run``, inverts their basis matrices and
    scatters the result back; every other lane gets zeros, which callers
    mask out.  Per lane the result equals a full-batch inversion (batched
    LU is lane-independent).  Returns ``(inv[B, m, m], bfs[B, m])``.
    """
    B, m, _ = A.shape
    inv = torch.zeros((B, m, m), dtype=A.dtype, device=A.device)
    bfs = torch.zeros((B, m), dtype=A.dtype, device=A.device)
    idx = torch.nonzero(run, as_tuple=True)[0]
    if idx.numel():
        invp = inv_or_nan(basis_matrix(A[idx], basis[idx]))
        inv[idx] = invp
        bfs[idx] = torch.einsum("bmk,bk->bm", invp, b[idx])
    return inv, bfs


def _segment_pack(c, A, state: SimplexState, allowed):
    """Arrange state in the kernel's layout (the transposed factor)
    (counterpart of the reference's ``_pallas_pack``, without its
    singleton row dimensions).  Returns ``(apen, SegmentState)``."""
    B, m, n = A.shape
    apen_row = torch.where(allowed, 0.0, float("inf")).to(A.dtype)
    apen = apen_row[None, :].expand(B, n).contiguous()
    seg = SegmentState(
        invBT=state.inv_B.transpose(1, 2).contiguous(),
        bfs=state.bfs.contiguous().clone(),
        cB=torch.gather(c, 1, state.basis.long()).contiguous(),
        basis=state.basis.to(torch.int32).contiguous().clone(),
        pen=batched_in_basis_penalty(state.basis, n, allowed),
        gamma=torch.ones((B, n), dtype=A.dtype, device=A.device),
        iters=state.iters.to(torch.int32).contiguous().clone(),
        status=state.status.to(torch.int32).contiguous().clone(),
    )
    return apen, seg


def run_batched_segments(c, A, b, state: SimplexState, allowed, maxiters: int,
                         cfg: SolverConfig, mode: str = "primal"
                         ) -> SimplexState:
    """Segment-at-a-time loop (counterpart of ``run_batched_pallas``).

    Each outer step runs up to ``cfg.refactor_every`` iterations per lane in
    one kernel launch, then refactorizes the still-running lanes exactly.
    With ``refactor_every == 0`` one unbounded segment runs.
    """
    B, m, n = A.shape
    A = A.contiguous()
    c = c.contiguous()
    seg_len = cfg.refactor_every if cfg.refactor_every > 0 else (1 << 30)
    apen, seg = _segment_pack(c, A, state, allowed)
    kw = dict(seg_len=seg_len, pricing=_PRICING_CODES[cfg.pricing],
              opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              dual=(mode == "dual"), feas_tol=cfg.feas_tol,
              stall_limit=cfg.stall_limit, unroll=cfg.unroll,
              packed=cfg.packed_select)

    def any_running():
        return bool(((seg.status == st.RUNNING) & (seg.iters < maxiters)).any())

    if cfg.refactor_every > 0:
        while any_running():
            solve_segment(A, c, apen, maxiters, seg, **kw)
            run = seg.status == st.RUNNING
            inv, fresh_bfs = compact_refactorize(A, b, seg.basis, run)
            ok = _finite_lanes(inv, fresh_bfs)
            seg.status.copy_(torch.where(run & ~ok, st.NUMERICAL_ERROR,
                                         seg.status).to(torch.int32))
            take = run & ok
            seg.invBT.copy_(torch.where(take[:, None, None],
                                        inv.transpose(1, 2), seg.invBT))
            seg.bfs.copy_(torch.where(take[:, None], fresh_bfs, seg.bfs))
            seg.gamma.fill_(1.0)  # devex weights: fresh reference framework
    else:
        solve_segment(A, c, apen, maxiters, seg, **kw)

    return SimplexState(
        basis=seg.basis,
        inv_B=seg.invBT.transpose(1, 2),
        bfs=seg.bfs,
        iters=seg.iters,
        status=seg.status,
    )


def _mega_kernel_fits(m: int, n: int, with_at: bool, itemsize: int = 4,
                      vmem_budget: int = 64 * 1024 * 1024) -> bool:
    """The reference's size gate for its whole-segment kernel.  The port
    keeps it so it takes the same (m, n) the reference's kernel takes; larger
    shapes belong to the streaming kernel, which is not ported yet."""
    a_terms = (2 if with_at else 1) * m * n
    per_lane = (a_terms + m * m + 10 * (m + n)) * itemsize
    return 4 * per_lane <= vmem_budget


def run_batched(c, A, b, state: SimplexState, allowed, maxiters: int,
                cfg: SolverConfig = DEFAULT_CONFIG,
                mode: str = "primal") -> SimplexState:
    """Drive the batch (primal or dual mode) to termination on the segment
    kernel.  Raises ``NotImplementedError`` for shapes past the
    whole-segment kernel's range."""
    if mode not in ("primal", "dual"):
        raise ValueError(f"unknown mode {mode!r}")
    _, m, n = A.shape
    if not _mega_kernel_fits(m, n, with_at=False):
        raise NotImplementedError(
            f"m={m}, n={n} is past the whole-segment kernel's range; the "
            "streaming kernel for large m is not ported yet"
        )
    return run_batched_segments(c, A, b, state, allowed, maxiters, cfg, mode)
