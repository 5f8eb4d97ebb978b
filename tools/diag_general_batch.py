#!/usr/bin/env python3
"""Which lanes of chip_smoke.py phase 19b's structured batch end other
than OPTIMAL, and under which settings.

Run from the repository root on a machine with a CUDA device:

    python3 tools/diag_general_batch.py

Builds the kernels, then solves the 1024 structured instances of phase 19b
(bounds as rows, padded to m = 240) with ``solve_batch_general`` under
dantzig and devex on kernel 1 (twice, for the same bits), devex with
``pivot_tol = 1e-6``, both rules on the per-step loop
(``kernels="torch"``), and devex on batches that repeat two set-covering
lanes (lanes 314 and 589) beside the first lane of each family, at four
batch sizes.  Prints one JSON line per setting: the non-OPTIMAL lanes as
``[lane, family, status, pivots, HiGHS status]`` (HiGHS status 2 is
infeasible) and the slowest lane's pivots.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.batch import solve_batch_general  # noqa: E402

PAIR = (314, 589)  # set-covering lanes
REPEATS = (1, 8, 64, 93)  # copies of the pair beside the 11 family lanes


def main():
    cs.phase_environment()
    cs.phase_build()
    problems, _, originals = cs._general_problems(cs.GB)
    highs = {}

    def lanes_of(results):
        out = []
        for k, r in enumerate(results):
            if r.status == st.OPTIMAL:
                continue
            if k not in highs:
                highs[k] = cs._highs_general(originals[k])[0]
            out.append([k, cs.GF_FAMILIES[k % len(cs.GF_FAMILIES)][0],
                        st.status_name(r.status), r.iters, highs[k]])
        return out

    dantzig = cs._suite_config()
    devex = dantzig.replace(pricing="devex")
    for name, cfg in (("dantzig", dantzig), ("devex", devex),
                      ("devex_again", devex),
                      ("devex_pivot_tol_1e-6", devex.replace(pivot_tol=1e-6)),
                      ("dantzig_torch", dantzig.replace(kernels="torch")),
                      ("devex_torch", devex.replace(kernels="torch"))):
        t0 = time.time()
        res = solve_batch_general(problems, cs.GITERS, cs.GITERS, cfg,
                                  device=cs.DEVICE)
        print(json.dumps({"setting": name, "lanes": cs.GB,
                          "seconds": time.time() - t0,
                          "not_optimal": lanes_of(res),
                          "max_pivots": max(r.iters for r in res)}),
              flush=True)
    base = [problems[k] for k in range(len(cs.GF_FAMILIES))]
    for reps in REPEATS:
        sub = base + [problems[k] for k in PAIR] * reps
        res = solve_batch_general(sub, cs.GITERS, cs.GITERS, devex,
                                  device=cs.DEVICE)
        codes = [st.status_name(r.status) for r in res[len(base):]]
        print(json.dumps({"setting": "devex_pair_repeated", "lanes": len(sub),
                          "pair_status": {c: codes.count(c)
                                          for c in sorted(set(codes))}}),
              flush=True)


if __name__ == "__main__":
    main()
