"""Batched simplex engine (counterpart of
:mod:`linprog_tpu.engine_batched`).

:func:`run_batched` runs a whole-segment kernel in segments of
``cfg.refactor_every`` iterations and refactorizes the still-running lanes
exactly in between, to bound eta-product drift.  With ``kernels="cuda"`` it
takes the kernel the reference takes at that shape: the whole-segment
kernel (:func:`linprog_tpu_torch.ops.solve_kernel.solve_segment`) where the
reference's fits in VMEM, else the streaming kernel
(:func:`linprog_tpu_torch.ops.stream_kernel.solve_segment_stream`) in the
reference's variant, and in dual mode at a blocked-factor shape the
streaming kernel unblocked and unpacked, where the reference leaves its
kernels for the vmapped per-lane dual engine.  A shape past every
streaming variant raises ``NotImplementedError`` under ``"cuda"``: the
kernel setting never gives way to plain PyTorch on its own.  ``kernels="torch"`` (the counterpart of
the reference's ``"xla"``) is the explicit choice of plain PyTorch: the
per-step loop :func:`run_batched_steps` over :func:`batched_primal_step`'s
einsum branch in primal mode, the per-lane engine
:func:`linprog_tpu_torch.engine.run` in dual mode; both are parity paths of
the reference's XLA code.  The step's kernel branch (the two per-step
kernels of :mod:`linprog_tpu_torch.ops.step_kernels`) is reached, as in the
reference, only by calling :func:`batched_primal_step` with
``kernels="cuda"``.
"""

from __future__ import annotations

import torch

from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from . import engine
from .engine import SimplexState, _gather_cols, basis_matrix, inv_or_nan
from .observability import host_read, span, spanned
from .ops.solve_kernel import (SegmentState, solve_segment, unit_count,
                               unit_map, unit_pays)
from .ops.step_kernels import price_entering, ratio_eta_pivot
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
    idx = host_read(torch.nonzero, run, as_tuple=True)[0]
    if idx.numel():
        invp = inv_or_nan(basis_matrix(A[idx], basis[idx]))
        inv[idx] = invp
        bfs[idx] = torch.einsum("bmk,bk->bm", invp, b[idx])
    return inv, bfs


def full_refactorize(A, b, basis):
    """Exact refactorization of every lane: ``(inv[B, m, m], bfs[B, m])``
    (a singular basis gives NaN factors)."""
    inv = inv_or_nan(basis_matrix(A, basis))
    return inv, torch.einsum("bmk,bk->bm", inv, b)


def newton_schulz_refine(A, b, basis, inv_B, steps: int = 2,
                         resid_tol: float = 1e-3):
    """Drifted eta factors refined toward ``inv(A[:, basis])``, guarded.

    ``steps`` Newton-Schulz iterations ``X <- X (2I - B X)`` square the
    residual ``||I - B X||`` each, at two batched products a step; they
    converge only inside ``||I - B X|| < 1``, so lanes whose largest
    residual entry stays above ``resid_tol`` take an exact inversion
    (computed only when some lane needs it).  In f32 past
    ``engine.F64_PAST`` rows the products run in float64, as the exact
    factorizations do.  Returns ``(inv_B, bfs)``.
    """
    B_mat = basis_matrix(A, basis)
    W = engine._wide(B_mat)
    X = inv_B.to(W.dtype)
    eye = torch.eye(W.shape[-1], dtype=W.dtype, device=W.device)
    for _ in range(steps):
        X = torch.matmul(X, 2.0 * eye - torch.matmul(W, X))
    resid = torch.matmul(W, X) - eye
    bad = torch.abs(resid).amax(dim=(1, 2)) > resid_tol
    X = X.to(inv_B.dtype)
    if host_read(bool, bad.any()):
        X = torch.where(bad[:, None, None], inv_or_nan(B_mat), X)
    return X, torch.einsum("bmk,bk->bm", X, b)


@spanned("batched_lu")
def refresh_running_lanes(A, rhs, seg, method: str = "inv",
                          compact: bool = True) -> None:
    """Refactorization between two segments, in place on a packed kernel
    state (``invBT``, ``bfs``, ``basis``, ``status``): the RUNNING lanes get
    a fresh factor and ``bfs = inv_B rhs``; one whose fresh factors are not
    finite freezes as ``NUMERICAL_ERROR`` instead.  ``method="inv"``
    inverts exactly, the running lanes only (``compact``) or the whole batch
    (the same bits on every running lane); ``"ns"`` refines the eta factors
    by :func:`newton_schulz_refine` with the reference's loose residual
    bound of 0.1."""
    run = seg.status == st.RUNNING
    if method == "ns":
        inv, fresh_bfs = newton_schulz_refine(
            A, rhs, seg.basis, seg.invBT.transpose(1, 2), resid_tol=1e-1)
    elif compact:
        inv, fresh_bfs = compact_refactorize(A, rhs, seg.basis, run)
    else:
        inv, fresh_bfs = full_refactorize(A, rhs, seg.basis)
    ok = _finite_lanes(inv, fresh_bfs)
    seg.status.copy_(torch.where(run & ~ok, st.NUMERICAL_ERROR,
                                 seg.status).to(torch.int32))
    take = run & ok
    seg.invBT.copy_(torch.where(take[:, None, None], inv.transpose(1, 2),
                                seg.invBT))
    seg.bfs.copy_(torch.where(take[:, None], fresh_bfs, seg.bfs))


def _segment_pack(c, A, state: SimplexState, allowed):
    """Arrange state in the kernel's layout (the transposed factor)
    (counterpart of the reference's ``_pallas_pack``, without its
    singleton row dimensions).  Returns ``(apen, SegmentState)``."""
    B, m, n = A.shape
    apen_row = torch.where(allowed, 0.0, float("inf")).to(A.dtype)
    apen = apen_row[None, :].expand(B, n).contiguous()
    seg = SegmentState(
        # always a copy: the kernels update it in place, and a caller's
        # inv_B whose transpose is contiguous would otherwise be overwritten
        invBT=state.inv_B.transpose(1, 2).clone(
            memory_format=torch.contiguous_format),
        bfs=state.bfs.contiguous().clone(),
        cB=torch.gather(c, 1, state.basis.long()).contiguous(),
        basis=state.basis.to(torch.int32).contiguous().clone(),
        pen=batched_in_basis_penalty(state.basis, n, allowed),
        gamma=torch.ones((B, n), dtype=A.dtype, device=A.device),
        iters=state.iters.to(torch.int32).contiguous().clone(),
        status=state.status.to(torch.int32).contiguous().clone(),
    )
    return apen, seg


def segment_launch(number: int, mode: str, seg, kernel, *args, **kw):
    """``kernel(*args, **kw)``, one launch of kernel ``number`` on the
    packed state ``seg`` (``args[0]`` is A), as a span ``segment`` with the
    lanes running at the launch and the pivots it did (device counts, no
    host read), A's ``shape``, the columns of A it held in shared memory
    (``held_cols``: kernel 1's ``n_d`` in the unit layout, else n), its
    CTAs a lane (``cluster``) and the ``branch`` that ran (kernels 1 and 4
    ``"resident"`` or ``"stream"``, kernel 3 ``"stream"``), which the kernel's
    wrapper gives the span; a plain version launches nothing (``cluster``
    0, ``branch`` ``"plain"``)."""
    sp = span("segment")
    if sp:
        before = seg.iters.clone()
        sp.set(kernel=number, mode=mode,
               running=(seg.status == st.RUNNING).sum(),
               shape=tuple(args[0].shape), held_cols=args[0].shape[2],
               cluster=0, branch="plain")
    with sp:
        kernel(*args, **kw)
    if sp:
        sp.set(pivots=(seg.iters - before).sum())


def _drive_segments(c, A, b, state: SimplexState, allowed, maxiters: int,
                    cfg: SolverConfig, kernel, number: int,
                    polish: bool = False, **kw) -> SimplexState:
    """Segment loop shared by both kernels: each outer step runs up to
    ``cfg.refactor_every`` iterations per lane in one ``kernel`` launch
    (kernel ``number``: 1 or 3),
    then refactorizes the still-running lanes (by ``cfg.refactor_method``
    and ``cfg.compact_refactor``).  With ``refactor_every == 0`` one
    unbounded segment runs.  ``polish`` (kernel 1 under
    ``refactor_method="ns"``, as in the reference): after the segments, at
    most three rounds of exact refactorization of every lane, reopening the
    OPTIMAL and PRIMAL_UNBOUNDED lanes and resuming, until no lane moves
    more than the one iteration that re-confirms it.  Kernel 1 gets the
    map of A's trailing unit columns where its unit layout could take fewer
    CTAs a lane than the dense launch
    (:func:`~linprog_tpu_torch.ops.solve_kernel.unit_pays`): their count
    rides on the drive's first read of the running lanes, and the map is
    built only where the count makes the layout pay."""
    A = A.contiguous()
    c = c.contiguous()
    seg_len = cfg.refactor_every if cfg.refactor_every > 0 else (1 << 30)
    apen, seg = _segment_pack(c, A, state, allowed)
    kw = dict(kw, seg_len=seg_len, opt_tol=cfg.opt_tol,
              pivot_tol=cfg.pivot_tol, feas_tol=cfg.feas_tol,
              stall_limit=cfg.stall_limit, packed=cfg.packed_select)
    B, m, n = A.shape
    # the unit-column count, on the device, where a map could pay
    probe = (unit_count(A) if number == 1 and not kw.get("split")
             and not kw.get("ablate") and unit_pays(B, m, n, 0, A.device)
             else None)

    mode = "dual" if kw.get("dual") else "primal"

    def any_running():
        nonlocal probe
        running = ((seg.status == st.RUNNING) & (seg.iters < maxiters)).any()
        if probe is None:
            return host_read(bool, running)
        go, n_u = host_read(torch.Tensor.tolist,
                            torch.stack([running.to(probe.dtype), probe]))
        probe = None
        unit = unit_map(A, n_u)
        kw["unit"] = (unit if unit is not None
                      and unit_pays(B, m, n, unit.n_d, A.device) else None)
        return bool(go)

    def segments():
        while any_running():
            segment_launch(number, mode, seg, kernel, A, c, apen, maxiters,
                           seg, **kw)
            refresh_running_lanes(A, b, seg, cfg.refactor_method,
                                  cfg.compact_refactor)
            seg.gamma.fill_(1.0)  # devex weights: fresh reference framework

    if cfg.refactor_every > 0:
        segments()
        for _ in range(3 if polish and cfg.refactor_method == "ns" else 0):
            inv, fresh_bfs = full_refactorize(A, b, seg.basis)
            seg.invBT.copy_(inv.transpose(1, 2))
            seg.bfs.copy_(fresh_bfs)
            seg.gamma.fill_(1.0)
            snapshot = seg.iters.clone()
            reopen = ((seg.status == st.OPTIMAL)
                      | (seg.status == st.PRIMAL_UNBOUNDED))
            seg.status.masked_fill_(reopen, st.RUNNING)
            segments()
            if host_read(bool, ((seg.iters - snapshot) <= 1).all()):
                break
    else:
        if probe is not None:
            any_running()  # the map: its one read
        segment_launch(number, mode, seg, kernel, A, c, apen, maxiters, seg,
                       **kw)

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
    ``run_batched_pallas``).  ``cfg.split_pricing`` takes effect where the
    reference's does: primal mode, bland or dantzig, at a shape where its
    kernel holds ``A^T`` too."""
    _, m, n = A.shape
    pricing = _PRICING_CODES[cfg.pricing]
    split = bool(cfg.split_pricing and mode == "primal" and pricing <= 1
                 and _mega_kernel_fits(m, n, with_at=True))
    return _drive_segments(c, A, b, state, allowed, maxiters, cfg,
                           solve_segment, 1, polish=True, pricing=pricing,
                           dual=(mode == "dual"), unroll=cfg.unroll,
                           split=split)


def run_batched_stream(c, A, b, state: SimplexState, allowed, maxiters: int,
                       cfg: SolverConfig, mode: str = "primal",
                       variant: str = "resident",
                       n_blk: int = 256) -> SimplexState:
    """Segment loop on the streaming kernel (counterpart of the
    reference's ``run_batched_stream``): the same segments and
    refactorizations as :func:`run_batched_segments`.  ``variant`` is the
    reference's ``"resident"``, ``"stream"`` or ``"stream_blocked"``; the
    last is primal only.  ``cfg.partial_pricing`` prices by sections of
    ``n_blk`` columns in primal mode off the blocked variant.  Devex raises
    ``ValueError``, as in the reference."""
    if cfg.pricing == "devex":
        raise ValueError(
            "pricing='devex' is not implemented on the streaming (large-m) "
            "kernel -- the weight update would need a second pass over A; "
            "use pricing='dantzig' here (devex runs on the whole-segment "
            "kernel and the per-step loop)"
        )
    if variant not in ("resident", "stream", "stream_blocked"):
        raise ValueError(f"unknown streaming variant {variant!r}")
    # sectional pricing: primal only, never with the blocked factor; the
    # resident variant's n_blk (0) becomes 256 where it divides n
    partial = bool(cfg.partial_pricing and mode == "primal")
    if partial and n_blk == 0:
        n = A.shape[2]
        n_blk = 256 if n % 256 == 0 else 0
        partial = n_blk > 0
    blocked = variant == "stream_blocked"
    return _drive_segments(c, A, b, state, allowed, maxiters, cfg,
                           solve_segment_stream, 3,
                           pricing=_PRICING_CODES[cfg.pricing],
                           dual=(mode == "dual"),
                           a_resident=(variant == "resident"), n_blk=n_blk,
                           factor_blocked=blocked,
                           partial=partial and not blocked)


def _mega_kernel_fits(m: int, n: int, with_at: bool, itemsize: int = 4,
                      vmem_budget: int = 64 * 1024 * 1024) -> bool:
    """The reference's v5e VMEM gate for its whole-segment kernel, kept for
    routing parity: the port takes the whole-segment kernel where the
    reference's fits in a v5e's VMEM.  It is not an H100 limit: each kernel
    applies its own reach line on the card."""
    a_terms = (2 if with_at else 1) * m * n
    per_lane = (a_terms + m * m + 10 * (m + n)) * itemsize
    return 4 * per_lane <= vmem_budget


def _stream_variant(m: int, n: int, itemsize: int = 4,
                    vmem_budget: int = 24 * 1024 * 1024):
    """The reference's choice of streaming-kernel variant for (m, n):
    ``("resident" | "stream" | "stream_blocked", n_blk)`` or None.

    These are the reference's v5e VMEM gates (its scoped-allocation budgets
    on a v5e), kept for routing parity so the port runs the variant the
    reference runs; they are not an H100 limit.  On the card the variants
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


def batched_primal_step(c, A, b, allowed, state: SimplexState,
                        cfg: SolverConfig, maxiters, bland=None, gamma=None):
    """One batched primal iteration over all lanes (finished lanes frozen).

    With ``cfg.kernels == "cuda"`` the two hot ops go through the per-step
    kernels (:func:`~linprog_tpu_torch.ops.step_kernels.price_entering`,
    then :func:`~linprog_tpu_torch.ops.step_kernels.ratio_eta_pivot`) with
    the ABSOLUTE ``opt_tol``; that branch updates ``state.inv_B`` and
    ``state.bfs`` in place where they are contiguous (the reference donates
    them).  With ``"torch"`` the step is plain einsum code with the
    per-lane tolerance ``opt_tol * max(1, max|c|)`` and ``bfs`` clamped at
    zero in the ratio test.

    ``bland`` (optional bool[B], einsum branch only): lanes flagged True use
    Bland's first-eligible entering rule whatever ``cfg.pricing`` says.
    ``gamma`` (optional f32[B, n], einsum branch only): devex reference
    weights; with ``cfg.pricing == "devex"`` it must be given, and the
    return value becomes ``(state, gamma_updated)``.  ``maxiters`` is an int
    or an i32 tensor.
    """
    B, m, n = A.shape
    lanes = torch.arange(B, device=A.device)
    inf = float("inf")
    running = (state.status == st.RUNNING) & (state.iters < maxiters)

    cB = torch.gather(c, 1, state.basis.long())
    penalty = batched_in_basis_penalty(state.basis, n, allowed)

    if cfg.pricing == "devex" and (cfg.kernels == "cuda" or gamma is None):
        raise ValueError(
            "pricing='devex' on the batched step requires the per-step loop "
            "(run_batched_steps threads the weight vector, kernels='torch'); "
            "the per-step kernels do not implement reference-weight devex "
            "-- use the whole-segment kernel (kernels='cuda' via "
            "run_batched) or pricing='dantzig'"
        )
    if cfg.kernels == "cuda":
        enter, elig = price_entering(
            cB.contiguous(), state.inv_B.contiguous(), A.contiguous(),
            c.contiguous(), penalty,
            dantzig=(cfg.pricing == "dantzig"), opt_tol=cfg.opt_tol,
        )
        eligible = elig > 0
        # a NaN reduced cost leaves `enter` at n: the reference's gather
        # clamps, so the port clamps before it gathers
        enter = enter.clamp_max(n - 1)
        acol = _gather_cols(A, enter)
        go = (running & eligible).to(torch.int32)
        inv_B, bfs, leave, unb = ratio_eta_pivot(
            state.inv_B.contiguous(), state.bfs.contiguous(), acol,
            go[:, None].contiguous(), pivot_tol=cfg.pivot_tol,
        )
        unbounded = unb > 0
        # an unbounded lane got leave = 0 and must keep its basis
        pivoted = (go > 0) & ~unbounded
    else:
        y = torch.einsum("bm,bmk->bk", cB, state.inv_B)
        r = c - torch.einsum("bm,bmn->bn", y, A) + penalty
        tol = (cfg.opt_tol
               * torch.clamp_min(torch.abs(c).max(dim=1).values, 1.0))[:, None]
        neg = r < -tol
        first_neg = neg.to(torch.int8).argmax(dim=1)  # first eligible column
        if cfg.pricing == "devex":
            score = torch.where(neg, (r * r) / gamma, -inf)
            enter = score.argmax(dim=1)
            eligible = neg[lanes, enter]
            if bland is not None:
                enter = torch.where(bland, first_neg, enter)
        elif cfg.pricing == "dantzig":
            enter = r.argmin(dim=1)
            eligible = neg[lanes, enter]
            if bland is not None:
                enter = torch.where(bland, first_neg, enter)
        else:
            enter = first_neg
            eligible = neg[lanes, enter]
        acol = _gather_cols(A, enter)
        d = torch.einsum("bmk,bk->bm", state.inv_B, acol)
        pos = d > cfg.pivot_tol
        any_pos = pos.any(dim=1)
        bfs_nn = torch.clamp_min(state.bfs, 0.0) + 0.0
        theta = torch.where(pos, bfs_nn / torch.where(pos, d, 1.0), inf)
        leave = theta.argmin(dim=1)
        go = running & eligible & any_pos
        d_l = d[lanes, leave]
        safe = torch.where(d_l == 0, 1.0, d_l)
        u = -d / safe[:, None]
        u[lanes, leave] = 1.0 / safe - 1.0
        u = torch.where(go[:, None], u, 0.0)
        row = state.inv_B[lanes, leave]
        inv_B = state.inv_B + u[:, :, None] * row[:, None, :]
        bfs = state.bfs + u * state.bfs[lanes, leave][:, None]
        unbounded = eligible & ~any_pos
        pivoted = go
        if cfg.pricing == "devex":
            # the whole-segment kernel's rule: weights from the pivot row of
            # the OLD tableau; the leaving variable re-enters the nonbasic
            # pool at max(gamma_q / alpha_q^2, 1)
            w = torch.einsum("bm,bmn->bn", row, A)
            ws = w / safe[:, None]
            gamma_q = torch.clamp_min(gamma[lanes, enter], 1.0)
            gamma_new = torch.maximum(gamma, (ws * ws) * gamma_q[:, None])
            leaving_col = state.basis[lanes, leave].long()
            gamma_new[lanes, leaving_col] = torch.clamp_min(
                gamma_q / (safe * safe), 1.0)
            gamma_new = torch.clamp_max(gamma_new, 1e12)
            gamma = torch.where(pivoted[:, None], gamma_new, gamma)

    new_basis = state.basis.clone()
    new_basis[lanes, leave.long()] = enter.to(torch.int32)
    basis = torch.where(pivoted[:, None], new_basis, state.basis)
    new_status = torch.where(
        running & ~eligible, st.OPTIMAL,
        torch.where(running & unbounded, st.PRIMAL_UNBOUNDED, state.status),
    ).to(torch.int32)
    out = SimplexState(basis=basis, inv_B=inv_B, bfs=bfs,
                       iters=state.iters + running.to(torch.int32),
                       status=new_status)
    return (out, gamma) if gamma is not None else out


def batched_refactorize(A, b, state: SimplexState) -> SimplexState:
    """Fresh ``inv_B`` and ``bfs`` of every lane (a singular basis gives
    NaN factors, never an exception)."""
    inv_B = inv_or_nan(basis_matrix(A, state.basis))
    return state._replace(inv_B=inv_B,
                          bfs=torch.einsum("bmk,bk->bm", inv_B, b))


def run_batched_steps(c, A, b, state: SimplexState, allowed, maxiters: int,
                      cfg: SolverConfig) -> SimplexState:
    """Per-step primal loop (counterpart of the reference's XLA batched
    path in ``run_batched``): one :func:`batched_primal_step` (einsum
    branch) per pass until every lane is terminal or at ``maxiters``, in
    chunks of ``cfg.refactor_every`` steps with an exact refactorization of
    the still-running lanes after each (eta updates only: under
    ``update="naive"`` the reference's path runs one loop without
    refactorizations, and so does this one).  A lane without relative
    objective progress over ``cfg.stall_limit`` pivots prices by Bland's
    rule until progress resumes; devex weights ride along and are reset at
    each refactorization."""
    cfg = cfg.replace(kernels="torch")
    B, _, n = A.shape
    dev = A.device
    track = cfg.stall_limit > 0 and cfg.pricing in ("dantzig", "devex")
    use_devex = cfg.pricing == "devex"
    z_prev = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    stall = torch.zeros((B,), dtype=torch.int32, device=dev)
    bland = torch.zeros((B,), dtype=torch.bool, device=dev)
    gamma = torch.ones((B, n), dtype=torch.float32, device=dev) \
        if use_devex else None

    def any_running(ss, hi):
        return bool(((ss.status == st.RUNNING) & (ss.iters < hi)).any())

    def step(ss, hi):
        nonlocal z_prev, stall, bland, gamma
        if track:
            cB = torch.gather(c, 1, ss.basis.long())
            z = (cB * ss.bfs).sum(dim=1)
            progressed = torch.abs(z - z_prev) > 1e-6 * (torch.abs(z) + 1.0)
            stall = torch.where(progressed, 0, stall + 1).to(torch.int32)
            bland = ~progressed & (bland | (stall >= cfg.stall_limit))
            z_prev = z
        out = batched_primal_step(c, A, b, allowed, ss, cfg, hi,
                                  bland=bland if track else None, gamma=gamma)
        if use_devex:
            ss, gamma = out
            return ss
        return out

    if cfg.refactor_every <= 0 or cfg.update != "eta":
        while any_running(state, maxiters):
            state = step(state, maxiters)
        return state
    while any_running(state, maxiters):
        iters_run = torch.where(state.status == st.RUNNING, state.iters,
                                maxiters)
        hi = min(int(iters_run.min()) + cfg.refactor_every, maxiters)
        while any_running(state, hi):
            state = step(state, hi)
        run = state.status == st.RUNNING
        if cfg.compact_refactor:
            inv, fresh_bfs = compact_refactorize(A, b, state.basis, run)
        else:
            inv, fresh_bfs = full_refactorize(A, b, state.basis)
        ok = _finite_lanes(inv, fresh_bfs)
        take = run & ok
        state = state._replace(
            inv_B=torch.where(take[:, None, None], inv, state.inv_B),
            bfs=torch.where(take[:, None], fresh_bfs, state.bfs),
            status=torch.where(run & ~ok, st.NUMERICAL_ERROR,
                               state.status).to(torch.int32),
        )
        if use_devex:  # weights: fresh reference framework
            gamma = torch.ones_like(gamma)
    return state


def run_batched(c, A, b, state: SimplexState, allowed, maxiters: int,
                cfg: SolverConfig = DEFAULT_CONFIG,
                mode: str = "primal") -> SimplexState:
    """Drive the batch (primal or dual mode) to termination.

    ``kernels="cuda"``: the whole-segment kernel where the reference's
    fits, else the streaming kernel in the reference's variant; dual mode
    at a ``"stream_blocked"`` shape runs the streaming kernel unblocked and
    unpacked (the blocked-factor mode is primal only, a rule of the v5e's
    VMEM: the card's kernel streams the whole factor in every variant; the
    reference's per-lane dual engine there selects exact minima).  A shape
    past every streaming variant raises ``NotImplementedError`` in either mode
    (the reference switches to ``"xla"`` there; here the caller asks for
    ``kernels="torch"`` to get plain PyTorch).
    ``kernels="torch"``: the per-step loop in primal mode and the per-lane
    engine (:func:`linprog_tpu_torch.engine.run`, the reference's vmapped
    ``engine.run``) in dual mode."""
    if mode not in ("primal", "dual"):
        raise ValueError(f"unknown mode {mode!r}")
    _, m, n = A.shape
    if cfg.kernels == "cuda":
        if _mega_kernel_fits(m, n, with_at=False):
            return run_batched_segments(c, A, b, state, allowed, maxiters,
                                        cfg, mode)
        variant = _stream_variant(m, n)
        if variant is None:
            raise NotImplementedError(
                f"{mode} mode at m={m}, n={n} is past every streaming-kernel "
                "variant, so no kernel of kernels='cuda' runs it; ask for "
                "kernels='torch' to run it in plain PyTorch (the per-step "
                "loop in primal mode, the per-lane engine in dual mode)"
            )
        name, n_blk = variant
        if name == "stream_blocked" and mode == "dual":
            # the reference leaves its kernels here for the per-lane dual
            # engine, whose selections are exact first minima: run unblocked
            # and unpacked (a packed key resolves a ratio only to
            # 2^-(23 - log2 n) relative, 1e-3 at n = 8192)
            name, cfg = "stream", cfg.replace(packed_select=False)
        return run_batched_stream(c, A, b, state, allowed, maxiters, cfg,
                                  mode, variant=name, n_blk=n_blk)
    if mode == "dual":
        return engine.run(c, A, b, state, allowed, maxiters, cfg, "dual")
    return run_batched_steps(c, A, b, state, allowed, maxiters, cfg)
