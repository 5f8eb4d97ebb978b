"""Solver-family router (counterpart of :mod:`linprog_tpu.router`).

:func:`solve_batch_auto` is the front door for dense batches: it picks
simplex, the batched IPM with the straggler backstop, IPM -> crossover or
the first-order PDHG by the size ``m`` and the accuracy class, from the
thresholds of :func:`linprog_tpu_torch.calibration.get_table`
(:func:`choose_family` is the rule alone).  :func:`solve_batch_auto_sparse`
is its counterpart for shared-pattern sparse batches (the sparse IPM with
straggler recovery, or the sparse PDHG, by :func:`choose_family_sparse`).
:func:`solve_batch_exact` is the exact pipeline: IPM -> crossover, then for
``xover_pallas_max_m < m < 1536`` a retry from the other basis guess, and
below ``m = 3072`` a two-phase fallback.  From ``m = 3072`` up (the
blocked-factor regime: the crossover's dual phase runs the streaming kernel
unblocked, its primal phase blocked) the uncrossed lanes are retried with
the same guess at double the pivot budget, and a lane that still fails
keeps its IPM answer and status: two-phase cannot converge affordably at
that size.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import status as st
from .calibration import get_table
from .config import SolverConfig, tuned_config
from .engine import noting_lu
from .observability import by_status, host_read, span, spanned
from .results import BatchResult

_FAMILIES = ("simplex", "ipm", "ipm+crossover", "pdhg")
# from here up: the blocked-factor cleanup settings, a same-guess retry at
# double budget and no two-phase fallback (the reference's literal 3072)
_LARGE_M = 3072
# below this (and past the whole-segment boundary) the uncrossed lanes are
# retried from the alternate basis guess before the fallback; from here to
# _LARGE_M they go straight to it (the reference's literal 1536)
_ALT_RETRY_MAX_M = 1536


def _xover_max_m() -> int:
    """Whole-segment kernel boundary for the crossover cleanup phases."""
    return int(get_table()["xover_pallas_max_m"])


def exact_cleanup_config(m: int, maxiters: Optional[int] = None):
    """Crossover-cleanup settings ``(SolverConfig, budget)`` for size ``m``:
    the tuned segment length up to the whole-segment kernel's boundary, a
    128-pivot refactorization cadence and a 2048-pivot budget past it, and
    from ``m = 3072`` up a 384-pivot cadence, ``unroll=1`` and a 4-pivot
    polish at the same budget (the reference's settings for its
    blocked-factor regime)."""
    if m <= _xover_max_m():
        return tuned_config(m), (maxiters or 512)
    if m < _LARGE_M:
        return (tuned_config(m, refactor_every=128, unroll=2),
                (maxiters or 2048))
    return (tuned_config(m, refactor_every=384, unroll=1, polish_pivots=4),
            (maxiters or 2048))


def recovery_cleanup_config(m: int, maxiters: Optional[int] = None):
    """The straggler recovery's variant of :func:`exact_cleanup_config`.  A
    recovery bucket starts from a near-optimal Tapia-ranked IPM iterate, so
    from m = 1536 up it takes a 256-pivot refactorization cadence and a
    1024-pivot budget; a lane that exhausts the budget keeps its IPM answer
    and status."""
    if m >= 1536:
        return (tuned_config(m, refactor_every=256, unroll=2),
                (maxiters or 1024))
    return exact_cleanup_config(m, maxiters)


def choose_family(m: int, accuracy: float) -> str:
    """The routing rule alone: ``"pdhg"`` for huge and loose
    (``accuracy >= 1e-4`` and ``m >= pdhg_min_m``); at exact accuracy
    (``<= exact_eps``) simplex up to ``exact_simplex_max_m`` and
    IPM -> crossover past it; else simplex up to ``moderate_simplex_max_m``
    and the IPM past it."""
    t = get_table()
    if accuracy >= 1e-4 and m >= t["pdhg_min_m"]:
        return "pdhg"
    if accuracy <= t["exact_eps"]:
        return ("simplex" if m <= t["exact_simplex_max_m"]
                else "ipm+crossover")
    return "simplex" if m <= t["moderate_simplex_max_m"] else "ipm"


def solve_batch_auto(c, G, h, accuracy: float = 1e-6,
                     maxiters: Optional[int] = None,
                     cfg: Optional[SolverConfig] = None,
                     prefer: Optional[str] = None):
    """Solve ``min c'x, Gx <= h, x >= 0`` for a batch (``c[B, n],
    G[B, m, n], h[B, m]``) with the family measured best for its regime.

    ``accuracy`` is the relative accuracy class: ``<= 1e-5`` asks for exact
    vertices with a basis (simplex or IPM -> crossover), larger values
    accept interior points at that KKT tolerance, with the non-converged
    lanes repaired to vertices (the IPM) or first-order points at that
    tolerance (PDHG, fixed-cadence restarts, ``basis`` -1).  ``prefer``
    names a family from ``{"simplex", "ipm", "ipm+crossover", "pdhg"}``
    instead.

    Returns ``(BatchResult, info)``: ``x`` over the structural ``n``
    columns; ``info`` holds the family taken and its extras (``crossed``,
    ``eps_rel``).
    """
    B, m, n = G.shape
    family = prefer or choose_family(m, float(accuracy))
    if family not in _FAMILIES:
        raise ValueError(
            f"unknown family {family!r}; expected one of {_FAMILIES}"
        )
    info = {"family": family, "m": int(m), "n": int(n), "lanes": int(B),
            "accuracy": float(accuracy)}

    if family == "simplex":
        from .batch import solve_batch_two_phase
        from .generators import device_standard_form_batch

        scfg = cfg or tuned_config(m)
        it = maxiters or max(2000, 4 * m)
        cs, As, bs = device_standard_form_batch(c, G, h)
        res = solve_batch_two_phase(cs, As, bs, it, it, scfg)
        return res._replace(x=res.x[:, :n]), info

    if family == "ipm":
        from .ipm import IPMConfig, ipm_solve_batch_canonical

        icfg = IPMConfig(eps_rel=max(float(accuracy), 1e-5),
                         maxiters=maxiters or 60)
        res = ipm_solve_batch_canonical(c, G, h, icfg, recover=True)
        info["eps_rel"] = icfg.eps_rel
        return res._replace(x=res.x[:, :n]), info

    if family == "ipm+crossover":
        res, xinfo = solve_batch_exact(c, G, h, cfg=cfg, maxiters=maxiters)
        info.update(xinfo)
        return res, info

    from .pdhg import PDHGConfig, pdhg_solve_batch_canonical

    pcfg = PDHGConfig(eps_rel=max(float(accuracy), 1e-5), adaptive=False)
    x, cost, status, iters = pdhg_solve_batch_canonical(
        c, G, h, maxiters=maxiters or 60_000, cfg=pcfg)
    res = BatchResult(
        x=x, basis=torch.full((B, m), -1, dtype=torch.int32, device=G.device),
        cost=cost, iters=iters, status=status, y=None)
    info["eps_rel"] = pcfg.eps_rel
    return res, info


def auto_summary(res: BatchResult, info: dict) -> dict:
    """``info`` with the host-side counts of OPTIMAL and ITER_LIMIT lanes."""
    status = res.status.cpu().numpy()
    out = dict(info)
    out["optimal"] = int((status == st.OPTIMAL).sum())
    out["iter_limit"] = int((status == st.ITER_LIMIT).sum())
    return out


def _merge(res: BatchResult, lanes, sub: BatchResult, rows):
    """``res`` with lanes ``lanes`` replaced by rows ``rows`` of ``sub``
    (iterations add up)."""
    x, basis, cost = res.x.clone(), res.basis.clone(), res.cost.clone()
    iters, status = res.iters.clone(), res.status.clone()
    x[lanes] = sub.x[rows, : x.shape[1]]
    basis[lanes] = sub.basis[rows, : basis.shape[1]]
    cost[lanes] = sub.cost[rows]
    iters[lanes] = iters[lanes] + sub.iters[rows]
    status[lanes] = sub.status[rows]
    y = res.y
    if y is not None and sub.y is not None:
        y = y.clone()
        y[lanes] = sub.y[rows, : y.shape[1]]
    return BatchResult(x=x, basis=basis, cost=cost, iters=iters,
                       status=status, y=y)


def _bucket(bad, B: int):
    """The uncrossed lanes gathered into a power-of-two bucket (at least 8,
    at most B) with cyclic fill."""
    nb = int(bad.numel())
    size = min(max(8, 1 << (nb - 1).bit_length()), B)
    return bad[torch.arange(size, device=bad.device) % nb]


@spanned("solve_batch_exact")
@noting_lu
def solve_batch_exact(c, G, h, cfg: Optional[SolverConfig] = None,
                      maxiters: Optional[int] = None, guess: str = "tapia"):
    """Exact vertices of ``min c'x, Gx <= h, x >= 0`` for a batch.

    Batched IPM, the dual-then-primal crossover to a verified vertex, then
    a retry of the uncrossed lanes gathered into a bucket: from the
    alternate basis guess for ``xover_pallas_max_m < m < 1536``, with the
    same guess at double the budget for ``m >= 3072``.  Below ``m = 3072`` a
    gathered two-phase simplex fallback repairs the lanes that still fail,
    so every OPTIMAL lane is a vertex with a basis; from ``m = 3072`` up
    they keep their IPM answer and status.  Returns ``(BatchResult, info)``
    with ``x`` over the structural columns and ``info["crossed"]`` (retries
    included), ``info["retry_crossed"]`` and ``info["fallback"]`` counting
    the paths taken, and ``info["uncrossed"]`` the lanes left uncrossed at
    ``m >= 3072``.
    """
    from .batch import solve_batch_two_phase
    from .crossover import (crossover_batch_canonical,
                            ipm_crossover_batch_canonical)
    from .generators import device_standard_form_batch

    B, m, n = G.shape
    if cfg is None:
        cfg, budget = exact_cleanup_config(m, maxiters)
    else:
        budget = maxiters or (512 if m <= _xover_max_m() else 2048)

    res, crossed = ipm_crossover_batch_canonical(
        c, G, h, crossover_maxiters=budget, cfg=cfg, guess=guess
    )
    info = {"crossed": host_read(int, crossed.sum()), "fallback": 0,
            "retry_crossed": 0}
    bad = host_read(torch.nonzero, ~crossed, as_tuple=True)[0]
    if bad.numel() == 0:
        return res, info

    retry = None
    if _xover_max_m() < m < _ALT_RETRY_MAX_M:
        # past the whole-segment kernel the reference retries the gathered
        # lanes from the other basis guess before any two-phase fallback
        retry = ("magnitude" if guess == "tapia" else "tapia", budget)
    elif m >= _LARGE_M:
        # the reference's evidence at this size is budget sensitivity:
        # the same guess again, with twice the pivots
        retry = (guess, 2 * budget)
    if retry is not None:
        alt, r_budget = retry
        with span("retry") as sp:
            idx = _bucket(bad, B)
            if sp:
                sp.set(lanes=int(bad.numel()), bucket=int(idx.numel()),
                       guess=alt)
            res2, crossed2 = ipm_crossover_batch_canonical(
                c[idx], G[idx], h[idx], crossover_maxiters=r_budget, cfg=cfg,
                guess=alt,
            )
            # the first crossed occurrence of each lane is written back
            seen, lanes, rows = set(), [], []
            for k, (lane, ok) in enumerate(zip(
                    host_read(torch.Tensor.tolist, idx),
                    host_read(torch.Tensor.tolist, crossed2))):
                if ok and lane not in seen:
                    seen.add(lane)
                    lanes.append(lane)
                    rows.append(k)
            if lanes:
                res = _merge(res, torch.tensor(lanes, device=bad.device),
                             res2, torch.tensor(rows, device=bad.device))
                info["retry_crossed"] = len(lanes)
                info["crossed"] += len(lanes)
                keep = [lane for lane in host_read(torch.Tensor.tolist, bad)
                        if lane not in seen]
                bad = torch.tensor(keep, dtype=bad.dtype, device=bad.device)
            if sp:
                sp.set(crossed=info["retry_crossed"])
        if bad.numel() == 0:
            return res, info
    if m >= _LARGE_M:
        # no affordable exact repair remains at this size: the lanes keep
        # their IPM answer and status
        info["uncrossed"] = int(bad.numel())
        return res, info

    with span("fallback") as sp:
        # gather the uncrossed lanes into a power-of-two bucket (cyclic
        # fill)
        nb = int(bad.numel())
        idx = _bucket(bad, B)
        if sp:
            sp.set(lanes=nb, bucket=int(idx.numel()),
                   reason=by_status(res.status[bad]))
        cg, Gg, hg = c[idx], G[idx], h[idx]
        cs, As, bs = device_standard_form_batch(cg, Gg, hg)
        it = 4 * m if m >= 256 else 2000
        sub = solve_batch_two_phase(cs, As, bs, it, it, cfg)
        info["fallback"] = nb
        # two-phase duals live in the sign-flipped row space -> unflip
        sub = sub._replace(x=sub.x[:, :n],
                           y=torch.where(hg < 0, -sub.y, sub.y))

        # At large m the two-phase vertex can end outside the
        # certificate's primal tolerance (its f32 simplex cannot resolve
        # basic values of ~1e-4 relative).  One crossover pass from that
        # vertex -- dual phase first, dd-refined verification -- repairs
        # it; where the pass verifies, its vertex replaces the two-phase
        # one.
        fix, fixed = crossover_batch_canonical(cg, Gg, hg, sub.x,
                                               maxiters=budget, cfg=cfg)
        sub = BatchResult(*(
            torch.where(fixed.view(-1, *([1] * (a.dim() - 1))), f, a)
            for a, f in zip(sub, fix._replace(iters=sub.iters + fix.iters))
        ))

        # the first nb bucket entries are exactly the bad lanes, in order
        out = _merge(res, bad, sub, torch.arange(nb, device=bad.device))
    return out, info


def choose_family_sparse(m: int, n: int, nnz: int, accuracy: float,
                         lanes: int = 1) -> str:
    """Routing rule for shared-pattern sparse batches (the reference's):

    * ``"pdhg"`` when the IPM's dense normal factors (``lanes * m^2`` f32)
      pass 4 GiB: the first-order family needs no ``m^2`` memory;
    * at loose accuracy (``>= 1e-2``) by a work model: ~12 Newton steps of
      a dense ``2 m^3`` factorization against ``min(60000, 20 / accuracy)``
      PDHG iterations of ``8 nnz`` operations, the smaller wins;
    * ``"ipm"`` everywhere else.
    """
    factor_bytes = 4.0 * lanes * m * m
    if factor_bytes > 4 * 1024**3:
        return "pdhg"
    if accuracy >= 1e-2:
        ipm_work = 12.0 * 2.0 * float(m) ** 3
        pdhg_iters = min(60_000.0, 20.0 / max(accuracy, 1e-6))
        if pdhg_iters * 8.0 * nnz < ipm_work:
            return "pdhg"
    return "ipm"


def solve_batch_auto_sparse(c, rows, cols, vals, h, shape,
                            accuracy: float = 1e-3,
                            maxiters: Optional[int] = None,
                            pattern=None, prefer: Optional[str] = None,
                            recover: Optional[bool] = None):
    """Solve a shared-pattern sparse canonical batch (``c[B, n],
    vals[B, nnz], h[B, m]`` over ``rows/cols[nnz]``, ``shape = (m, n)``)
    with the family :func:`choose_family_sparse` picks (``prefer``
    overrides it).

    The IPM path runs at ``eps_rel = max(accuracy, 1e-5)`` and, with
    ``recover`` (default: on for ``accuracy <= 1e-3``), repairs its
    stragglers through :func:`ipm_sparse.recover_stragglers_sparse`.  The
    PDHG path runs adaptive restarts at the same tolerance; as in the
    reference its lanes keep the solver's status (a lane out of budget
    stays RUNNING).  Returns ``(BatchResult, info)`` with ``x`` over the
    structural ``n`` columns.
    """
    m, n = shape
    B = vals.shape[0]
    nnz = int(len(rows))
    family = prefer or choose_family_sparse(m, n, nnz, float(accuracy), B)
    info = {"family": f"sparse-{family}", "m": int(m), "n": int(n),
            "lanes": int(B), "nnz": nnz, "accuracy": float(accuracy)}

    if family == "ipm":
        from .ipm import IPMConfig
        from .ipm_sparse import (
            ipm_solve_batch_sparse_canonical,
            recover_stragglers_sparse,
        )

        icfg = IPMConfig(eps_rel=max(float(accuracy), 1e-5),
                         maxiters=maxiters or 60, frac=0.995)
        res = ipm_solve_batch_sparse_canonical(
            c, rows, cols, vals, h, shape, icfg, pattern=pattern)
        do_recover = (recover if recover is not None
                      else float(accuracy) <= 1e-3)
        if do_recover:
            res = recover_stragglers_sparse(c, rows, cols, vals, h, shape,
                                            res)
            info["recovered"] = True
        info["eps_rel"] = icfg.eps_rel
        return res._replace(x=res.x[:, :n]), info

    if family != "pdhg":
        raise ValueError(f"unknown sparse family {family!r}")
    from .pdhg import PDHGConfig, pdhg_solve_batch_sparse

    dev = vals.device
    lb = torch.zeros((B, n), dtype=torch.float32, device=dev)
    ub = torch.full((B, n), float("inf"), dtype=torch.float32, device=dev)
    pcfg = PDHGConfig(eps_rel=max(float(accuracy), 1e-5), adaptive=True,
                      stall_reset_beta=0.95)
    state = pdhg_solve_batch_sparse(c, rows, cols, vals, h, 0, lb, ub,
                                    shape, maxiters=maxiters or 60_000,
                                    cfg=pcfg)
    res = BatchResult(
        x=state.x,
        basis=torch.full((B, m), -1, dtype=torch.int32, device=dev),
        cost=(c.to(state.x.dtype) * state.x).sum(dim=1),
        iters=state.iters, status=state.status, y=state.y)
    info["eps_rel"] = pcfg.eps_rel
    return res, info
