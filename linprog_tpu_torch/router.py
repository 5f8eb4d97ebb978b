"""Exact pipeline: IPM -> crossover -> retry -> two-phase fallback
(counterpart of the exact half of :mod:`linprog_tpu.router`, for
m < 3072).

At m >= 3072 the reference's crossover runs its dual phase on the vmapped
per-lane engine and retries at double budget with no fallback; neither is
ported, so that size raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .calibration import get_table
from .config import SolverConfig, tuned_config
from .results import BatchResult

_LARGE_M = 3072  # from here the reference's exact path leaves the port


def _xover_max_m() -> int:
    """Whole-segment kernel boundary for the crossover cleanup phases."""
    return int(get_table()["xover_pallas_max_m"])


def _check_size(m: int) -> None:
    if m >= _LARGE_M:
        raise NotImplementedError(
            f"m={m} >= {_LARGE_M}: the reference's crossover runs its dual "
            "phase on the vmapped per-lane dual engine at this size and its "
            "router retries at double budget with no fallback; neither is "
            "ported yet (ROADMAP Queue 1 items 9 and 10)"
        )


def exact_cleanup_config(m: int, maxiters: Optional[int] = None):
    """Crossover-cleanup settings ``(SolverConfig, budget)`` for size ``m``:
    the tuned segment length up to the whole-segment kernel's boundary, a
    128-pivot refactorization cadence and a 2048-pivot budget past it."""
    _check_size(m)
    if m <= _xover_max_m():
        return tuned_config(m), (maxiters or 512)
    return tuned_config(m, refactor_every=128, unroll=2), (maxiters or 2048)


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


def solve_batch_exact(c, G, h, cfg: Optional[SolverConfig] = None,
                      maxiters: Optional[int] = None, guess: str = "tapia"):
    """Exact vertices of ``min c'x, Gx <= h, x >= 0`` for a batch.

    Batched IPM, the dual-then-primal crossover to a verified vertex, for
    ``xover_pallas_max_m < m < 1536`` a retry of uncrossed lanes from the
    alternate basis guess, and a gathered two-phase simplex fallback for
    lanes that still fail to cross, so every OPTIMAL lane is a vertex with a
    basis.  Returns ``(BatchResult, info)`` with ``x`` over the structural
    columns and ``info["crossed"]`` (retries included),
    ``info["retry_crossed"]`` and ``info["fallback"]`` counting the paths
    taken.
    """
    from .batch import solve_batch_two_phase
    from .crossover import (crossover_batch_canonical,
                            ipm_crossover_batch_canonical)
    from .generators import device_standard_form_batch

    B, m, n = G.shape
    _check_size(m)
    if cfg is None:
        cfg, budget = exact_cleanup_config(m, maxiters)
    else:
        budget = maxiters or (512 if m <= _xover_max_m() else 2048)

    res, crossed = ipm_crossover_batch_canonical(
        c, G, h, crossover_maxiters=budget, cfg=cfg, guess=guess
    )
    info = {"crossed": int(crossed.sum()), "fallback": 0, "retry_crossed": 0}
    bad = torch.nonzero(~crossed, as_tuple=True)[0]
    if bad.numel() == 0:
        return res, info

    if _xover_max_m() < m < 1536:
        # past the whole-segment kernel the reference retries the gathered
        # lanes from the other basis guess before any two-phase fallback
        alt = "magnitude" if guess == "tapia" else "tapia"
        idx = _bucket(bad, B)
        res2, crossed2 = ipm_crossover_batch_canonical(
            c[idx], G[idx], h[idx], crossover_maxiters=budget, cfg=cfg,
            guess=alt,
        )
        # the first crossed occurrence of each lane is written back
        seen, lanes, rows = set(), [], []
        for k, (lane, ok) in enumerate(zip(idx.tolist(), crossed2.tolist())):
            if ok and lane not in seen:
                seen.add(lane)
                lanes.append(lane)
                rows.append(k)
        if lanes:
            res = _merge(res, torch.tensor(lanes, device=bad.device), res2,
                         torch.tensor(rows, device=bad.device))
            info["retry_crossed"] = len(lanes)
            info["crossed"] += len(lanes)
            keep = [lane for lane in bad.tolist() if lane not in seen]
            bad = torch.tensor(keep, dtype=bad.dtype, device=bad.device)
        if bad.numel() == 0:
            return res, info

    # gather the uncrossed lanes into a power-of-two bucket (cyclic fill)
    nb = int(bad.numel())
    idx = _bucket(bad, B)
    cg, Gg, hg = c[idx], G[idx], h[idx]
    cs, As, bs = device_standard_form_batch(cg, Gg, hg)
    it = 4 * m if m >= 256 else 2000
    sub = solve_batch_two_phase(cs, As, bs, it, it, cfg)
    info["fallback"] = nb
    # two-phase duals live in the sign-flipped row space -> unflip
    sub = sub._replace(x=sub.x[:, :n], y=torch.where(hg < 0, -sub.y, sub.y))

    # At large m the two-phase vertex can end outside the certificate's
    # primal tolerance (its f32 simplex cannot resolve basic values of
    # ~1e-4 relative).  One crossover pass from that vertex -- dual phase
    # first, dd-refined verification -- repairs it; where the pass
    # verifies, its vertex replaces the two-phase one.
    fix, fixed = crossover_batch_canonical(cg, Gg, hg, sub.x, maxiters=budget,
                                           cfg=cfg)
    sub = BatchResult(*(
        torch.where(fixed.view(-1, *([1] * (a.dim() - 1))), f, a)
        for a, f in zip(sub, fix._replace(iters=sub.iters + fix.iters))
    ))

    # the first nb bucket entries are exactly the bad lanes, in order
    return _merge(res, bad, sub, torch.arange(nb, device=bad.device)), info
