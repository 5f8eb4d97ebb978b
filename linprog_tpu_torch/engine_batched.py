"""Batched simplex loop over the segment kernels
(counterpart of the kernel half of :mod:`linprog_tpu.engine_batched`).

:func:`run_batched` runs a whole-segment kernel in segments of
``cfg.refactor_every`` iterations and refactorizes the still-running lanes
exactly in between, to bound eta-product drift.  It takes the kernel the
reference takes at that shape: the whole-segment kernel
(:func:`linprog_tpu_torch.ops.solve_kernel.solve_segment`) where the
reference's fits in VMEM, else the streaming kernel
(:func:`linprog_tpu_torch.ops.stream_kernel.solve_segment_stream`) in the
reference's variant.  The reference's XLA path and its vmapped per-lane
dual engine are not part of the port: a shape or mode that reaches them in
the reference raises ``NotImplementedError`` here instead of running
something else.
"""

from __future__ import annotations

import torch

from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .engine import SimplexState, basis_matrix, inv_or_nan
from .ops.solve_kernel import SegmentState, solve_segment
from .ops.stream_kernel import solve_segment_stream

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


def _drive_segments(c, A, b, state: SimplexState, allowed, maxiters: int,
                    cfg: SolverConfig, kernel, **kw) -> SimplexState:
    """Segment loop shared by both kernels: each outer step runs up to
    ``cfg.refactor_every`` iterations per lane in one ``kernel`` launch,
    then refactorizes the still-running lanes exactly.  With
    ``refactor_every == 0`` one unbounded segment runs."""
    A = A.contiguous()
    c = c.contiguous()
    seg_len = cfg.refactor_every if cfg.refactor_every > 0 else (1 << 30)
    apen, seg = _segment_pack(c, A, state, allowed)
    kw = dict(kw, seg_len=seg_len, opt_tol=cfg.opt_tol,
              pivot_tol=cfg.pivot_tol, feas_tol=cfg.feas_tol,
              stall_limit=cfg.stall_limit, packed=cfg.packed_select)

    def any_running():
        return bool(((seg.status == st.RUNNING) & (seg.iters < maxiters)).any())

    if cfg.refactor_every > 0:
        while any_running():
            kernel(A, c, apen, maxiters, seg, **kw)
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
        kernel(A, c, apen, maxiters, seg, **kw)

    return SimplexState(
        basis=seg.basis,
        inv_B=seg.invBT.transpose(1, 2),
        bfs=seg.bfs,
        iters=seg.iters,
        status=seg.status,
    )


def run_batched_segments(c, A, b, state: SimplexState, allowed, maxiters: int,
                         cfg: SolverConfig, mode: str = "primal"
                         ) -> SimplexState:
    """Segment loop on the whole-segment kernel (counterpart of
    ``run_batched_pallas``)."""
    return _drive_segments(c, A, b, state, allowed, maxiters, cfg,
                           solve_segment,
                           pricing=_PRICING_CODES[cfg.pricing],
                           dual=(mode == "dual"), unroll=cfg.unroll)


def run_batched_stream(c, A, b, state: SimplexState, allowed, maxiters: int,
                       cfg: SolverConfig, mode: str = "primal",
                       variant: str = "resident",
                       n_blk: int = 256) -> SimplexState:
    """Segment loop on the streaming kernel (counterpart of the
    reference's ``run_batched_stream``): the same segments and exact
    refactorizations as :func:`run_batched_segments`.  ``variant`` is the
    reference's ``"resident"``, ``"stream"`` or ``"stream_blocked"``; the
    last is primal only.  Devex raises ``ValueError``, as in the
    reference."""
    if cfg.pricing == "devex":
        raise ValueError(
            "pricing='devex' is not implemented on the streaming (large-m) "
            "kernel -- the weight update would need a second pass over A; "
            "use pricing='dantzig' here (devex runs on the whole-segment "
            "kernel's plain version)"
        )
    if variant not in ("resident", "stream", "stream_blocked"):
        raise ValueError(f"unknown streaming variant {variant!r}")
    return _drive_segments(c, A, b, state, allowed, maxiters, cfg,
                           solve_segment_stream,
                           pricing=_PRICING_CODES[cfg.pricing],
                           dual=(mode == "dual"),
                           a_resident=(variant == "resident"), n_blk=n_blk,
                           factor_blocked=(variant == "stream_blocked"))


def _mega_kernel_fits(m: int, n: int, with_at: bool, itemsize: int = 4,
                      vmem_budget: int = 64 * 1024 * 1024) -> bool:
    """The reference's size gate for its whole-segment kernel, kept as a
    routing-parity constant: the port takes the whole-segment kernel where
    the reference's fits in a v5e's VMEM.  It is not an H100 limit (a
    calibration on the card replaces it; ROADMAP Queue 1 item 8)."""
    a_terms = (2 if with_at else 1) * m * n
    per_lane = (a_terms + m * m + 10 * (m + n)) * itemsize
    return 4 * per_lane <= vmem_budget


def _stream_variant(m: int, n: int, itemsize: int = 4,
                    vmem_budget: int = 24 * 1024 * 1024):
    """The reference's choice of streaming-kernel variant for (m, n):
    ``("resident" | "stream" | "stream_blocked", n_blk)`` or None.

    These are the reference's VMEM rules (its scoped-allocation budgets on a
    v5e), kept as routing-parity constants so the port runs the variant the
    reference runs; they are not an H100 limit, which waits for
    ``calibrate()`` (ROADMAP Queue 1 item 8).  On the card the variants
    differ only in the plain version's blocked-factor summation order.
    """
    rows = 12 * (m + n) * itemsize
    resident = (m * n + 2 * m * m) * itemsize + rows
    if resident <= vmem_budget:
        return ("resident", 0)
    for n_blk in (512, 256, 128):
        if n % n_blk:
            continue
        stream = (2 * m * n_blk + 2 * m * m) * itemsize + rows
        if stream <= 48 * 1024 * 1024:
            return ("stream", n_blk)
    for n_blk in (256, 128):
        if n % n_blk:
            continue
        need = (m * m + 2 * m * n_blk + 2 * 512 * m) * itemsize + rows
        if need <= 92 * 1024 * 1024:
            return ("stream_blocked", n_blk)
    return None


def run_batched(c, A, b, state: SimplexState, allowed, maxiters: int,
                cfg: SolverConfig = DEFAULT_CONFIG,
                mode: str = "primal") -> SimplexState:
    """Drive the batch (primal or dual mode) to termination: the
    whole-segment kernel where the reference's fits, else the streaming
    kernel in the reference's variant.  Raises ``NotImplementedError``
    where the reference leaves its kernels: the blocked-factor variant in
    dual mode (the reference's vmapped per-lane dual engine) and shapes
    past every streaming variant (its XLA batched path)."""
    if mode not in ("primal", "dual"):
        raise ValueError(f"unknown mode {mode!r}")
    _, m, n = A.shape
    if _mega_kernel_fits(m, n, with_at=False):
        return run_batched_segments(c, A, b, state, allowed, maxiters, cfg,
                                    mode)
    variant = _stream_variant(m, n)
    if variant is None:
        raise NotImplementedError(
            f"m={m}, n={n} is past the reference's streaming-kernel "
            "variants; the reference runs its XLA batched path there, which "
            "is not ported"
        )
    if variant[0] == "stream_blocked" and mode == "dual":
        raise NotImplementedError(
            f"dual mode at m={m}, n={n} (blocked-factor shape): the "
            "reference runs its vmapped per-lane dual engine there "
            "(engine.run), which is not ported (ROADMAP Queue 1 item 9)"
        )
    return run_batched_stream(c, A, b, state, allowed, maxiters, cfg, mode,
                              variant=variant[0], n_blk=variant[1])
