#!/usr/bin/env python3
"""Time the whole-segment kernels (kernel 1, ``solve_segment``; with
``--bounded`` kernel 4, ``solve_bounded_segment``) under each launch plan.

Run from the repository root on a machine with a CUDA device:

    python3 tools/time_segment_plans.py [--bounded] [B m n_g ...]

For each ``B m n_g`` triple (default: the shapes the paths launch, and the
same lanes one at a time and one wave at a time, then kernel 1's streaming
branch at [64, 1024, 2048] and [32, 1024, 2048]; with ``--bounded`` the
lanes of chip_smoke.py's phase 16, 16 and 4 of (1280, 2560)) it builds the
crossover-shaped batch of chip_smoke.py ([G | I], so n = n_g + m; for
kernel 4 ``device_bounded_lps`` from its all-slack start), lists every
candidate of ``segment_plans`` with the clusters the device holds at once
(on a streaming branch also its scalar-load plans), and times a
1-pivot and a 65-pivot primal segment under each (the best of 3 launches;
CUDA events).  It prints milliseconds per batch-iteration inside
the segment, (t65 - t1) / 64, which leaves out the loading of the lanes, and
per iteration of one wave of resident clusters; the card's name and power
limit come first.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from linprog_tpu_torch.config import tuned_config  # noqa: E402
from linprog_tpu_torch.ops import bounded_kernel as bk  # noqa: E402
from linprog_tpu_torch.ops import solve_kernel as sk  # noqa: E402

ITERS = 65
DEFAULT = [(1024, 256, 256), (30, 256, 256), (1, 256, 256),
           (64, 512, 512), (7, 512, 512), (1, 512, 512),
           (256, 256, 256), (1024, 128, 256), (66, 128, 256),
           (1, 128, 256), (64, 1024, 1024), (32, 1024, 1024)]
BOUNDED_DEFAULT = [(16, 1280, 1280), (4, 1280, 1280)]


def _instance(bounded, B, m, n_g):
    """(kernel module, state type, launch(plan, state, seg_len), state0)."""
    cfg = tuned_config(m)
    if bounded:
        gen = torch.Generator(device="cuda").manual_seed(3)
        c, A, b, lb, ub = cs.device_bounded_lps(gen, B, m, n_g, "cuda")
        n = n_g + m
        zeros = torch.zeros((B, m), device="cuda")
        vs = torch.zeros((B, n), dtype=torch.int8, device="cuda")
        vs[:, n_g:] = bk.BASIC
        state0 = bk.BoundedSegmentState(
            invBT=torch.eye(m, device="cuda").expand(B, m, m).contiguous(),
            bfs=b.clone(), cB=zeros.clone(),
            basis=torch.arange(n_g, n, dtype=torch.int32,
                               device="cuda").expand(B, m).contiguous(),
            vstate=vs, lbB=zeros.clone(),
            ubB=torch.full((B, m), float("inf"), device="cuda"),
            iters=torch.zeros(B, dtype=torch.int32, device="cuda"),
            status=torch.zeros(B, dtype=torch.int32, device="cuda"))
        A, c, lb, ub = (t.contiguous() for t in (A, c, lb, ub))

        def launch(plan, s, seg_len):
            bk.launch_with_plan(plan, A, c, lb, ub, 1 << 20, s,
                                seg_len=seg_len, opt_tol=cfg.opt_tol,
                                pivot_tol=cfg.pivot_tol,
                                packed=cfg.packed_select)
        return bk, bk.BoundedSegmentState, launch, state0
    A, c, apen, _, state0 = cs._segment_instance(False, B, m, n_g, 3)

    def launch(plan, s, seg_len):
        sk.launch_with_plan(plan, A, c, apen, 1 << 20, s, seg_len=seg_len,
                            pricing=1, opt_tol=cfg.opt_tol,
                            pivot_tol=cfg.pivot_tol,
                            stall_limit=cfg.stall_limit,
                            packed=cfg.packed_select)
    return sk, sk.SegmentState, launch, state0


def time_plan(launch, kind, state0, plan, seg_len):
    times = []
    for _ in range(3):
        s = kind(*(t.clone() for t in state0))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        launch(plan, s, seg_len)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return min(times)


def _candidates(bounded, B, m, n):
    mod = bk if bounded else sk
    if not sk.resident(m, n, cbytes=mod.cluster_bytes):
        return mod.built_stream_plans(B, m, n)
    return mod.segment_plans(B, m, n)


def _label(plan):
    if isinstance(plan, sk.StreamingPlan):
        return (f"cluster {plan.cluster} ({plan.ctas_per_sm} an SM, "
                + (f"ring {plan.warp_stages} x {plan.chunk_floats}"
                   if plan.aligned else "scalar loads") + ")")
    return f"cluster {plan.cluster}"


def run(bounded, B, m, n_g):
    _, kind, launch, state0 = _instance(bounded, B, m, n_g)
    n = n_g + m
    print(f"{'bounded' if bounded else 'segment'} B={B} (m, n)=({m}, {n})",
          flush=True)
    for plan in _candidates(bounded, B, m, n):
        held = (bk if bounded else sk).clusters_held(plan)
        if held <= 0:
            print(f"  {_label(plan)}: not granted ({held})")
            continue
        one = time_plan(launch, kind, state0, plan, 1)
        seg = time_plan(launch, kind, state0, plan, ITERS)
        per = (seg - one) / (ITERS - 1)
        waves = -(-B // held)
        print(f"  {_label(plan)}: {plan.smem_bytes} B shared, "
              f"{held} resident clusters ({waves} waves): one pivot "
              f"{one:.4f} ms, {ITERS} pivots {seg:.3f} ms, "
              f"{per:.4f} ms/iteration in the segment, "
              f"{1e3 * per / waves:.2f} us an iteration of one wave",
              flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("time_segment_plans needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    argv = sys.argv[1:]
    bounded = "--bounded" in argv
    args = [int(a) for a in argv if a != "--bounded"]
    cases = (list(zip(args[0::3], args[1::3], args[2::3]))
             or (BOUNDED_DEFAULT if bounded else DEFAULT))
    for B, m, n_g in cases:
        run(bounded, B, m, n_g)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
