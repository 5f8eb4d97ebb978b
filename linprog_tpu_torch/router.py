"""Exact pipeline: IPM -> crossover -> two-phase fallback (counterpart of
the ``m <= xover_pallas_max_m`` branch of :mod:`linprog_tpu.router`).

Sizes past that boundary (the streaming kernel and the retries of the
reference) are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .calibration import get_table
from .config import SolverConfig, tuned_config
from .results import BatchResult


def _xover_max_m() -> int:
    return int(get_table()["xover_pallas_max_m"])


def _check_size(m: int) -> None:
    if m > _xover_max_m():
        raise NotImplementedError(
            f"m={m} > {_xover_max_m()}: the large-m crossover (streaming "
            "kernel, alternate-guess retry) is not ported yet"
        )


def exact_cleanup_config(m: int, maxiters: Optional[int] = None):
    """Crossover-cleanup settings ``(SolverConfig, budget)`` for size ``m``."""
    _check_size(m)
    return tuned_config(m), (maxiters or 512)


def solve_batch_exact(c, G, h, cfg: Optional[SolverConfig] = None,
                      maxiters: Optional[int] = None, guess: str = "tapia"):
    """Exact vertices of ``min c'x, Gx <= h, x >= 0`` for a batch.

    Batched IPM, the dual-then-primal crossover to a verified vertex, and a
    gathered two-phase simplex fallback for lanes that fail to cross, so
    every OPTIMAL lane is a vertex with a basis.  Returns
    ``(BatchResult, info)`` with ``x`` over the structural columns and
    ``info["crossed"]``, ``info["fallback"]`` counting the paths taken.
    """
    from .batch import solve_batch_two_phase
    from .crossover import ipm_crossover_batch_canonical
    from .generators import device_standard_form_batch

    B, m, n = G.shape
    _check_size(m)
    if cfg is None:
        cfg, budget = exact_cleanup_config(m, maxiters)
    else:
        budget = maxiters or 512

    res, crossed = ipm_crossover_batch_canonical(
        c, G, h, crossover_maxiters=budget, cfg=cfg, guess=guess
    )
    info = {"crossed": int(crossed.sum()), "fallback": 0, "retry_crossed": 0}
    bad = torch.nonzero(~crossed, as_tuple=True)[0]
    if bad.numel() == 0:
        return res, info

    # gather the uncrossed lanes into a power-of-two bucket (cyclic fill)
    nb = int(bad.numel())
    bucket = min(max(8, 1 << (nb - 1).bit_length()), B)
    idx = bad[torch.arange(bucket, device=bad.device) % nb]
    cs, As, bs = device_standard_form_batch(c[idx], G[idx], h[idx])
    it = 4 * m if m >= 256 else 2000
    sub = solve_batch_two_phase(cs, As, bs, it, it, cfg)
    info["fallback"] = nb

    # the first nb bucket entries are exactly the bad lanes, in order;
    # two-phase duals live in the sign-flipped row space -> unflip
    k = slice(0, nb)
    flip = h[bad] < 0
    sub_y = torch.where(flip, -sub.y[k], sub.y[k])
    x, basis, cost = res.x.clone(), res.basis.clone(), res.cost.clone()
    iters, status = res.iters.clone(), res.status.clone()
    x[bad] = sub.x[k, : x.shape[1]]
    basis[bad] = sub.basis[k, : basis.shape[1]]
    cost[bad] = sub.cost[k]
    iters[bad] = iters[bad] + sub.iters[k]
    status[bad] = sub.status[k]
    y = None
    if res.y is not None:
        y = res.y.clone()
        y[bad] = sub_y[:, : y.shape[1]]
    return BatchResult(x=x, basis=basis, cost=cost, iters=iters,
                       status=status, y=y), info
