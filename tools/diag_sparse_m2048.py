#!/usr/bin/env python3
"""Where the sparse IPM's stragglers at m = 2048 come from on the card, and
what its normal assembly costs (a development aid behind chip_smoke.py
phase 18).

Run from the repository root on a machine with a CUDA device:

    python3 tools/diag_sparse_m2048.py [lanes m density]

On phase 18's instances (``device_sparse_inequality_lps``, device seed 0,
128 lanes at m = n = 2048, 1 % density by default) it prints one JSON line
for each of:

1. ``assembly``: one normal matrix ``G D G' + diag(D_s)`` at a ``d``
   spread over e^-9..e^9, assembled by the sparse operator
   (``_SparseSlackOp.normal``) and by the dense slack operator on the
   densified batch (one batched f32 GEMM); milliseconds of each (CUDA
   events, median of 5 after a warm-up) and their largest difference
   relative to the largest entry of a float64 product;
2. ``ipm``: the raw IPM at the phase's settings (eps 1e-3, 40 steps, frac
   0.995) through the sparse operator in f32, through the dense operator
   on the densified batch in f32, and through the sparse operator in
   float64: statuses, Newton steps, wall.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.generators import (  # noqa: E402
    device_sparse_inequality_lps,
    random_sparse_pattern,
)
from linprog_tpu_torch.ipm import _SlackOp  # noqa: E402
from linprog_tpu_torch.ipm_sparse import _densify_lanes, _SparseSlackOp  # noqa: E402


def _counts(status):
    return {st.status_name(int(k)): int(v) for k, v in
            zip(*torch.unique(status, return_counts=True))}


def _ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main():
    args = sys.argv[1:4]
    lanes = int(args[0]) if args else 128
    m = int(args[1]) if len(args) > 1 else 2048
    dens = float(args[2]) if len(args) > 2 else 0.01
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows, cols = random_sparse_pattern(m, m, dens, seed=0)
    pat = lt.SparsePattern(rows, cols, m, m, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    c, vals, h = device_sparse_inequality_lps(gen, lanes, rows, cols, m, m,
                                              dev)
    G = _densify_lanes(rows, cols, vals, m, m)

    gd = torch.Generator(device=dev).manual_seed(1)
    d = torch.exp(18.0 * torch.rand((lanes, 2 * m), generator=gd,
                                    device=dev) - 9.0)
    sp = _SparseSlackOp(pat.tables(dev), vals, m, m)
    dn = _SlackOp(G)
    ref = _SlackOp(G.double()).normal(d.double())
    scale = ref.abs().amax()
    out = {"run": "assembly", "lanes": lanes, "m": m, "density": dens,
           "nnz": int(rows.shape[0]),
           "sparse_ms": _ms(lambda: sp.normal(d)),
           "dense_gemm_ms": _ms(lambda: dn.normal(d)),
           "sparse_err": float((sp.normal(d).double() - ref).abs().amax()
                               / scale),
           "dense_err": float((dn.normal(d).double() - ref).abs().amax()
                              / scale),
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps(out), flush=True)
    del ref

    cfg = dict(eps_rel=1e-3, maxiters=40, frac=0.995)
    runs = [
        ("sparse_f32", lambda: lt.ipm_solve_batch_sparse_canonical(
            c, rows, cols, vals, h, (m, m), lt.IPMConfig(**cfg),
            pattern=pat)),
        ("dense_f32", lambda: lt.ipm_solve_batch_canonical(
            c, G, h, lt.IPMConfig(**cfg))),
        ("sparse_float64", lambda: lt.ipm_solve_batch_sparse_canonical(
            c, rows, cols, vals, h, (m, m),
            lt.IPMConfig(**cfg, dtype="float64"), pattern=pat)),
    ]
    for name, fn in runs:
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        print(json.dumps({"run": name, "wall_s": time.time() - t0,
                          "lane_status": _counts(res.status),
                          "newton_steps_median": int(res.iters.median()),
                          "newton_steps_max": int(res.iters.max())}),
              flush=True)


if __name__ == "__main__":
    main()
