#!/usr/bin/env python3
"""Time the streaming simplex kernel under each of its launch plans.

Run from the repository root on a machine with a CUDA device:

    python3 tools/time_stream_plans.py [B m n_g ...]

For each ``B m n_g`` triple (default: the m = 2048 path's shapes) it builds
the crossover-shaped batch of chip_smoke.py ([G | I], so n = n_g + m),
lists every candidate of ``stream_plans`` with the clusters the device
holds at once, and times a 24-pivot primal segment under each candidate
and, for the chosen cluster size, under other stage geometries of the same
ring.  It prints milliseconds per batch-iteration (the best of 3 launches;
CUDA events), the card's name and its power limit.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from linprog_tpu_torch.config import tuned_config  # noqa: E402
from linprog_tpu_torch.ops import _build  # noqa: E402
from linprog_tpu_torch.ops import solve_kernel as sk  # noqa: E402
from linprog_tpu_torch.ops import stream_kernel as ssk  # noqa: E402

ITERS = 24
DEFAULT = [(8, 2048, 4096), (7, 2048, 4096), (64, 2048, 2048),
           (64, 1024, 2048), (64, 1000, 1999)]


def time_plan(plan, A, c, apen, state0, kw):
    times = []
    for _ in range(3):
        s = sk.SegmentState(*(t.clone() for t in state0))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        ssk.launch_with_plan(plan, A, c, apen, 1 << 20, s, seg_len=ITERS, **kw)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / ITERS)
    return min(times)


def run(B, m, n_g):
    lib = _build.library()
    cfg = tuned_config(m, refactor_every=128, unroll=2)
    kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              dual=False, feas_tol=cfg.feas_tol, stall_limit=cfg.stall_limit,
              packed=cfg.packed_select)
    A, c, apen, _, state0 = cs._segment_instance(False, B, m, n_g, 3)
    n = A.shape[2]
    chosen = ssk._choose_plan(B, m, n, False, 0, True)
    print(f"B={B} (m, n)=({m}, {n}); the wrapper takes cluster "
          f"{chosen.cluster}", flush=True)
    variants = [("", p) for p in ssk.stream_plans(B, m, n)]
    if chosen.aligned:
        ring = chosen.stages * chosen.stage_floats
        variants += [(f" as {s} stages", chosen._replace(
            stages=s, stage_floats=ring // s // 4 * 4)) for s in (8, 2)]
        variants.append((" with a quarter of the ring", chosen._replace(
            stage_floats=chosen.stage_floats // 4 // 4 * 4,
            warp_stages=max(1, chosen.warp_stages // 2),
            chunk_floats=max(32, chosen.chunk_floats // 2 // 32 * 32))))
    for note, plan in variants:
        resident = lib.lp_solve_segment_stream_max_clusters(
            plan.cluster, int(plan.aligned), plan.smem_bytes)
        if resident <= 0:
            print(f"  cluster {plan.cluster}{note}: not granted ({resident})")
            continue
        ms = time_plan(plan, A, c, apen, state0, kw)
        print(f"  cluster {plan.cluster}{note}: "
              f"{'ring' if plan.aligned else 'scalar'} "
              f"{plan.stages} x {plan.stage_floats * 4 // 1024} KB, "
              f"{plan.smem_bytes} B shared, {resident} resident clusters "
              f"({-(-B // resident)} waves): {ms:.4f} ms/iteration", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("time_stream_plans needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    args = [int(a) for a in sys.argv[1:]]
    cases = list(zip(args[0::3], args[1::3], args[2::3])) or DEFAULT
    for B, m, n_g in cases:
        run(B, m, n_g)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
