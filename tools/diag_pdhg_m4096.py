#!/usr/bin/env python3
"""How close the first-order family's answers at m = 4096 come to the
optimum on the card, and whether f32 arithmetic moves them (a development
aid behind chip_smoke.py phase 12's PDHG regime).

Run from the repository root on a machine with a CUDA device:

    python3 tools/diag_pdhg_m4096.py [lanes m seed]

On ``device_inequality_lps`` (4 lanes at m = n = 4096 from device seed
4156 by default: phase 12's instances) it prints one JSON line for the
optimum (``solve_batch_exact``, with the dd-KKT certificate of each lane)
and one for each PDHG setting of the router's regime
(``pdhg_solve_batch_canonical`` at eps 1e-4, fixed-cadence restarts):

* ``f32``: the package's (chunks of steps as captured CUDA graphs);
* ``f32_eager``: the same steps launched one by one;
* ``f32_f64_matvec``: f32 state, each matvec formed in float64 and
  rounded to f32;
* ``float64``: the instances cast to float64.

For each: statuses, iterations, wall, and against the certified optimum
the relative objective gap; beside them the answer's primal infeasibility
``||max(Gx - h, 0)|| / (1 + ||h||)`` in float64 on the original scaling.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import pdhg  # noqa: E402
from linprog_tpu_torch.generators import device_inequality_lps  # noqa: E402


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def main():
    lanes, m, seed = (int(a) for a in (sys.argv[1:4] or (4, 4096, 4156)))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    c, G, h = device_inequality_lps(gen, lanes, m, m, dev)
    (exact, info), wall = _timed(lambda: lt.solve_batch_exact(c, G, h))
    cert = lt.certify_vertex_batch(c, G, h, exact.basis)["certified"]
    opt = exact.cost.double()
    print(json.dumps({"run": "exact", "lanes": lanes, "m": m, "seed": seed,
                      "cost": opt.tolist(), "certified": cert.tolist(),
                      "crossed": info["crossed"], "wall_s": wall,
                      "device": torch.cuda.get_device_name(0)}), flush=True)

    cfg = pdhg.PDHGConfig(eps_rel=1e-4, adaptive=False)
    mv, mtv = pdhg._mv, pdhg._mtv

    def mv64(K, v):
        return torch.einsum("bmn,bn->bm", K.double(), v.double()).to(v.dtype)

    def mtv64(K, y):
        return torch.einsum("bmn,bm->bn", K.double(), y.double()).to(y.dtype)

    settings = [("f32", (c, G, h), True, False),
                ("f32_eager", (c, G, h), False, False),
                ("f32_f64_matvec", (c, G, h), True, True),
                ("float64", (c.double(), G.double(), h.double()), True,
                 False)]
    graphed = pdhg._graphed
    for name, args, graphs, f64_matvec in settings:
        if not graphs:
            pdhg._graphed = lambda chunk, state: chunk
        if f64_matvec:
            pdhg._mv, pdhg._mtv = mv64, mtv64
        try:
            (x, cost, status, iters), wall = _timed(
                lambda: pdhg.pdhg_solve_batch_canonical(
                    *args, maxiters=60_000, cfg=cfg))
        finally:
            pdhg._graphed = graphed
            pdhg._mv, pdhg._mtv = mv, mtv
        gap = ((cost.double() - opt).abs() / opt.abs().clamp_min(1.0))
        viol = torch.clamp_min(
            torch.einsum("bmn,bn->bm", G.double(), x.double()) - h.double(),
            0.0)
        infeas = (torch.linalg.vector_norm(viol, dim=1)
                  / (1.0 + torch.linalg.vector_norm(h.double(), dim=1)))
        print(json.dumps({"run": name, "status": status.tolist(),
                          "iters": iters.tolist(), "wall_s": wall,
                          "rel_gap_to_exact": gap.tolist(),
                          "primal_infeasibility": infeas.tolist()}),
              flush=True)


if __name__ == "__main__":
    main()
