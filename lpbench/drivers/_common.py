"""Helpers shared by the drivers."""

from __future__ import annotations

import torch

from ..cell import Problem
from ..instances import standard_form


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def order(seed: int, size: int) -> list:
    """The run's order of the pool: a permutation drawn from ``--seed``.
    The pool itself comes from the configuration's ``data_seed``, so every
    seed runs the same LPs in another order (the LPs set the work: a batch
    that sends lanes to a fallback costs twice the others)."""
    g = torch.Generator().manual_seed(seed % (1 << 63))
    return torch.randperm(size, generator=g).tolist()


def solver_config(m: int, entry: dict):
    """The program's ``tuned_config(m, **overrides)`` for an entry of the
    configuration file."""
    from linprog_tpu_torch.config import tuned_config

    return tuned_config(m, **entry.get("overrides", {}))


def by_key(keys, lanes, one):
    """``one(key, lanes_of_key)`` for each key in ascending order, joined
    into one :class:`Problem` (the harness passes the sampled pairs sorted
    by key, then lane)."""
    parts = [one(k, lanes[keys == k]) for k in sorted(set(keys.tolist()))]
    first = parts[0]
    return first._replace(**{
        f: torch.cat([getattr(p, f) for p in parts])
        for f in ("c", "A", "b", "lb", "ub")})


def standard_problem(cs, A, b, slack_start: int, x_cols: int) -> Problem:
    """Standard-form LPs ``min c'z, A z = b, z >= 0``, float64."""
    cs, A, b = cs.double(), A.double(), b.double()
    return Problem(c=cs, A=A, b=b, lb=torch.zeros_like(cs),
                   ub=torch.full_like(cs, float("inf")),
                   slack_start=slack_start, x_cols=x_cols, bounded=False)


def inequality_problem(c, G, h, x_cols: int) -> Problem:
    """``min c'x, Gx <= h, x >= 0`` in standard form (the benchmark's own
    construction) for the reference."""
    cs, A, b = standard_form(c.double(), G.double(), h.double())
    return standard_problem(cs, A, b, G.shape[2], x_cols)
