"""``router.solve_batch_exact(c, G, h)``: IPM -> crossover -> dd polish ->
two-phase fallback, on a pool of batches of ``min c'x, Gx <= h, x >= 0``
taken in turn."""

from __future__ import annotations

from ..cell import Answer, Cell
from ..instances import inequality_lps
from ._common import by_key, generator, order, inequality_problem


class ExactCell(Cell):
    def __init__(self, config, seed, device):
        from linprog_tpu_torch.router import solve_batch_exact

        self.solve = solve_batch_exact
        m, n, self.lanes = config["m"], config["n"], config["lanes"]
        gen = generator(config["data_seed"], device)
        self.pool = [inequality_lps(gen, self.lanes, m, n, device)
                     for _ in range(config["pool_batches"])]
        self.order = order(seed, len(self.pool))
        self.call(0)  # warm-up: the cell's shapes

    def key(self, i):
        return self.order[i % len(self.order)]

    def call(self, i):
        res, info = self.solve(*self.pool[self.key(i)])
        return Answer(status=res.status, x=res.x, cost=res.cost,
                      basis=res.basis, iters=res.iters,
                      info={"fallback": info["fallback"]})

    def problems(self, keys, lanes):
        def one(k, ln):
            c, G, h = self.pool[k]
            # the program's x is the structural part
            return inequality_problem(c[ln], G[ln], h[ln], G.shape[2])
        return by_key(keys, lanes, one)


def setup(config, traffic, seed, device):
    return ExactCell(config, seed, device)
