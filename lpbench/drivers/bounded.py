"""``batch.solve_batch_bounded(c, A, b, lb, ub, basis, var_state,
maxiters, cfg)`` from the slack start (every structural variable at its
lower bound): kernel 4's segments, the terminal dd re-solve and the
bound-aware dd polish; on a pool of batches of ``min c'z, [G' | I] z = b,
0 <= x <= ub`` taken in turn."""

from __future__ import annotations

from ..cell import Answer, Cell, Problem
from ..instances import bounded_lps, bounded_slack_start
from ._common import by_key, generator, order, solver_config


class BoundedCell(Cell):
    def __init__(self, config, seed, device):
        from linprog_tpu_torch.batch import solve_batch_bounded

        self.solve = solve_batch_bounded
        entry = config["entries"]["solve_batch_bounded"]
        m, n, self.lanes = config["m"], config["n"], config["lanes"]
        self.cfg = solver_config(m, entry)
        self.maxiters = entry["maxiters"]
        self.n = n
        lo, hi = config["ub_range"]
        gen = generator(config["data_seed"], device)
        self.pool = [bounded_lps(gen, self.lanes, m, n, device, lo, hi)
                     for _ in range(config["pool_batches"])]
        self.start = bounded_slack_start(self.lanes, m, n, device)
        self.order = order(seed, len(self.pool))
        self.call(0)  # warm-up: the cell's shapes

    def key(self, i):
        return self.order[i % len(self.order)]

    def call(self, i):
        res = self.solve(*self.pool[self.key(i)], *self.start, self.maxiters,
                         self.cfg)
        return Answer(status=res.status, x=res.x, cost=res.cost,
                      basis=res.basis, iters=res.iters, info={})

    def problems(self, keys, lanes):
        def one(k, ln):
            c, A, b, lb, ub = (t[ln].double() for t in self.pool[k])
            return Problem(c=c, A=A, b=b, lb=lb, ub=ub, slack_start=self.n,
                           x_cols=A.shape[2], bounded=True)
        return by_key(keys, lanes, one)


def setup(config, traffic, seed, device):
    return BoundedCell(config, seed, device)
