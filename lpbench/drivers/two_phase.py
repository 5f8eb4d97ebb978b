"""``batch.solve_batch_two_phase(c, A, b, maxiters1, maxiters2, cfg)``:
Phase I from the slack crash, then Phase II, both on kernel 1, then the
dd polish; on the standard form of a pool of batches of ``min c'x, Gx <=
h, x >= 0`` (built by the benchmark in set-up), taken in turn."""

from __future__ import annotations

from ..cell import Answer, Cell
from ..instances import inequality_lps, standard_form
from ._common import (by_key, generator, order, solver_config,
                      standard_problem)


class TwoPhaseCell(Cell):
    def __init__(self, config, seed, device):
        from linprog_tpu_torch.batch import solve_batch_two_phase

        self.solve = solve_batch_two_phase
        entry = config["entries"]["solve_batch_two_phase"]
        m, n, self.lanes = config["m"], config["n"], config["lanes"]
        self.cfg = solver_config(m, entry)
        self.iters = (entry["maxiters1"], entry["maxiters2"])
        self.n = n
        gen = generator(config["data_seed"], device)
        self.pool = [standard_form(*inequality_lps(gen, self.lanes, m, n,
                                                   device))
                     for _ in range(config["pool_batches"])]
        self.order = order(seed, len(self.pool))
        self.call(0)  # warm-up: the cell's shapes

    def key(self, i):
        return self.order[i % len(self.order)]

    def call(self, i):
        res = self.solve(*self.pool[self.key(i)], *self.iters, self.cfg)
        return Answer(status=res.status, x=res.x, cost=res.cost,
                      basis=res.basis, iters=res.iters, info={})

    def problems(self, keys, lanes):
        def one(k, ln):
            cs, A, b = self.pool[k]
            return standard_problem(cs[ln], A[ln], b[ln], self.n,
                                    A.shape[2])
        return by_key(keys, lanes, one)


def setup(config, traffic, seed, device):
    return TwoPhaseCell(config, seed, device)
