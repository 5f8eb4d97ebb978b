#!/usr/bin/env python3
"""Time the whole-segment kernels (kernel 1, ``solve_segment``; with
``--bounded`` kernel 4, ``solve_bounded_segment``) under each launch plan.

Run from the repository root on a machine with a CUDA device:

    python3 tools/time_segment_plans.py [--bounded | --unit] [B m n_g ...]

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

``--unit`` times kernel 1 in both layouts on the two-phase simplex's
Phase-I lanes (``[G | I | I]`` with the rows of h < 0 sign-flipped, from
the crash basis with Phase-I costs, n = n_g + 2m; default [1024, 256,
768]), then on the crossover-shaped batch above (n = n_g + m): every dense
plan, then every plan of the unit layout (the leading n_g columns held,
the unit columns as rows and values), with the same figures, the check
that the first unit plan leaves the first dense plan's state bit for bit,
the plain version's ms an iteration over 16 pivots, and each layout's
bounds of one iteration and of a 64-pivot launch an iteration (the unit
layout's from the work it does: the n_g held columns and the map read, one
product a unit column).
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
from linprog_tpu_torch.ops.plans import StreamingPlan, resident  # noqa: E402

ITERS = 65
DEFAULT = [(1024, 256, 256), (30, 256, 256), (1, 256, 256),
           (64, 512, 512), (7, 512, 512), (1, 512, 512),
           (256, 256, 256), (1024, 128, 256), (66, 128, 256),
           (1, 128, 256), (64, 1024, 1024), (32, 1024, 1024)]
BOUNDED_DEFAULT = [(16, 1280, 1280), (4, 1280, 1280)]
UNIT_DEFAULT = [(1024, 256, 256)]


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


def _unit_instance(kind, B, m, n_g):
    """Kernel 1's Phase-I lanes of the two-phase simplex (``kind``
    "two-phase") or the crossover-shaped batch ("crossover"): (A,
    launch(plan, state, seg_len, unit), state0)."""
    from linprog_tpu_torch.engine import slack_crash_state
    from linprog_tpu_torch.engine_batched import _segment_pack
    from linprog_tpu_torch.generators import (device_inequality_lps,
                                              device_standard_form_batch)

    cfg = tuned_config(m)
    if kind == "crossover":
        A, cost, apen, _, state0 = cs._segment_instance(False, B, m, n_g, 3)
    else:
        gen = torch.Generator(device="cuda").manual_seed(3)
        _, A, b = device_standard_form_batch(*device_inequality_lps(
            gen, B, m, n_g, "cuda"))
        A = torch.cat([A, torch.eye(m, device="cuda").expand(B, m, m)],
                      dim=2).contiguous()
        n = n_g + 2 * m
        cost = torch.cat([torch.zeros((B, n_g + m), device="cuda"),
                          torch.ones((B, m), device="cuda")], dim=1)
        apen, state0 = _segment_pack(cost, A,
                                     slack_crash_state(A, b, n_g + m),
                                     torch.ones(n, dtype=torch.bool,
                                                device="cuda"))

    def launch(plan, s, seg_len, unit=None, plain=False):
        kw = dict(seg_len=seg_len, pricing=1, opt_tol=cfg.opt_tol,
                  pivot_tol=cfg.pivot_tol, stall_limit=cfg.stall_limit,
                  packed=cfg.packed_select)
        if plain:
            sk.solve_segment_plain(A, cost, apen, 1 << 20, s, **kw)
        else:
            sk.launch_with_plan(plan, A, cost, apen, 1 << 20, s, unit=unit,
                                **kw)
    return A, launch, state0


def run_unit(kind, B, m, n_g):
    A, launch, state0 = _unit_instance(kind, B, m, n_g)
    n = A.shape[2]
    unit = sk.unit_columns(A)
    print(f"segment, {kind}, B={B} (m, n)=({m}, {n}), "
          f"unit columns from {unit.n_d}", flush=True)
    first = {}
    for name, layout, plans in (
            ("dense", None, sk.segment_plans(B, m, n)),
            ("unit", unit, sk.segment_plans(B, m, n, n_d=unit.n_d))):
        for plan in plans:
            held = sk.clusters_held(plan)
            if held <= 0:
                print(f"  {name} {_label(plan)}: not granted ({held})")
                continue

            def go(p, s, seg_len):
                launch(p, s, seg_len, unit=layout)
            one = time_plan(go, sk.SegmentState, state0, plan, 1)
            seg = time_plan(go, sk.SegmentState, state0, plan, ITERS)
            per = (seg - one) / (ITERS - 1)
            waves = -(-B // held)
            print(f"  {name} {_label(plan)}: {plan.smem_bytes} B shared, "
                  f"{held} resident clusters ({waves} waves): one pivot "
                  f"{one:.4f} ms, {ITERS} pivots {seg:.3f} ms, "
                  f"{per:.4f} ms/iteration in the segment, "
                  f"{1e3 * per / waves:.2f} us an iteration of one wave",
                  flush=True)
            if name not in first:
                s = sk.SegmentState(*(t.clone() for t in state0))
                go(plan, s, ITERS)
                first[name] = s
    same = all(cs.same_bits(a, b) for a, b in zip(first["dense"],
                                                  first["unit"]))
    print(f"  unit layout leaves the dense state bit for bit: {same}")

    def plain(s, seg_len):
        launch(None, s, seg_len, plain=True)
    p1 = time_plan(lambda _, s, k: plain(s, k), sk.SegmentState, state0,
                   None, 1)
    p17 = time_plan(lambda _, s, k: plain(s, k), sk.SegmentState, state0,
                    None, 17)
    print(f"  plain {(p17 - p1) / 16:.4f} ms/iteration (16 pivots)",
          flush=True)
    for name, n_d in (("dense", n), ("unit", unit.n_d)):
        one_bound, by = cs.segment_bound_ms(B, B, m, n, n_d)
        launch_bound, by_l = cs.launch_bound_ms(B, m, n, ITERS - 1, n_d)
        print(f"  {name} bounds: {one_bound:.4f} ms one iteration ({by}), "
              f"{launch_bound / (ITERS - 1):.4f} ms an iteration of a "
              f"{ITERS - 1}-pivot launch ({by_l})", flush=True)


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
    if not resident(m, n, mod.cluster_bytes):
        return mod.built_stream_plans(B, m, n)
    return mod.segment_plans(B, m, n)


def _label(plan):
    if isinstance(plan, StreamingPlan):
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
    unit = "--unit" in argv
    args = [int(a) for a in argv if a not in ("--bounded", "--unit")]
    cases = (list(zip(args[0::3], args[1::3], args[2::3]))
             or (BOUNDED_DEFAULT if bounded else UNIT_DEFAULT if unit
                 else DEFAULT))
    for B, m, n_g in cases:
        if unit:
            for kind in ("two-phase", "crossover"):
                run_unit(kind, B, m, n_g)
                torch.cuda.empty_cache()
        else:
            run(bounded, B, m, n_g)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
