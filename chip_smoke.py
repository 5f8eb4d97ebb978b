#!/usr/bin/env python3
"""Smoke run of linprog_tpu_torch on one NVIDIA GPU: the exact pipeline,
bounded-variable batches, the per-step batched engine, the batched front
door (pooled IPM straggler recovery, warm re-solves, the router,
calibrate()), the first-order and sparse families (PDHG, PDHG ->
crossover, the shared-pattern sparse IPM with its recovery, the sparse
front door), the general-form surface (the solver classes,
solve_batch_general, the primal-dual batch, IPMSolver, ranging), and the
parallel entry points with the last modules (data and tensor parallelism,
checkpoints, observability, MPS I/O, the dry run), and the reference's last
solver modes (split and sectional pricing, the ablation switch,
Newton-Schulz refactorization, the Gondzio and minv IPM, the slack basis
guess, the cumsum sparse assembly).

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line:
  0. environment: the card (nvidia-smi name and power limit), torch, CUDA
     and nvcc versions; TF32 is switched off and checked;
  1. build: compiles the CUDA kernels from csrc/ with nvcc, one process per
     source, all started together, and reports ptxas's registers and
     spills per kernel;
  2. panel_cholinv: CUDA kernel against its plain PyTorch version at the
     IPM's panels, [1024, 32, 32] (m = 256) and [64, 32, 32] (m = 2048), on
     the warp-per-matrix kernel, at [128, 32, 32] and [256, 32, 32] (the
     batches of phases 10-12), at [4, 32, 32] (m = 4096, phase 15) and at
     [1024, 48, 48] on the
     block-per-matrix kernel (SPD, cond ~1e3; a planted non-SPD lane;
     within 1e-4 relative, and whether bit for bit);
  3. solve_segment: CUDA kernel against its plain version at crossover
     shapes (B = 1024, m = 256, n = 512), primal and dual mode, one
     iteration and a full segment; at the shapes phases 10-12 give it
     ([64, 512, 1024], [256, 256, 512], [1024, 128, 384]), both modes and
     devex, one iteration and a 16-pivot segment in lockstep; the
     streaming branch at [64, 1024, 2048] (past the largest cluster: both
     modes and devex, its in-segment time beside the one-iteration bound
     and beside the block per lane it replaced); each shape with its launch
     plan, the same bits under every other planned cluster size and
     layout, and a 64-pivot segment's time an iteration beside the launch
     bound; kernel 1's unit layout (A's trailing unit columns as a row and
     a value a lane) at the two-phase simplex's Phase-I lanes [1024, 256,
     768] and the crossover's [1024, 256, 512], primal, dual and devex:
     one iteration and a 16-pivot segment in lockstep with the plain
     version, the dense launch's state bit for bit, whether solve_segment
     takes it (where it saves CTAs), its plan report beside the dense
     launch's in-segment time, with the bounds of the work it does; then
     devex pricing at [1024, 256, 512]: one iteration and a 16-pivot
     segment against the plain version, and a full solve_batch_two_phase
     run with pricing="devex" at B = 1024, m = n = 256 (all OPTIMAL, HiGHS
     gap on 4 lanes, its Phase-I lanes in the unit layout);
  4. the m = 256 path: solve_batch_exact at B = 1024, m = n = 256 (wall:
     the median of 10 runs after a warm-up; launch counts from the first),
     then the dd-KKT certificate and a HiGHS check on 16 lanes;
  5. solve_segment_stream: the cluster kernel against its plain version at
     B = 64, (m, n) = (2048, 4096), primal and dual (one iteration in
     lockstep, then a 64-pivot segment), at the two-phase shape
     (1024, 3072) and a ragged (1000, 2999), primal, and at the fallback's
     bucket, B = 8 at (2048, 6144), primal; each with its launch plan
     (cluster size, ring, shared memory) and its own bound, and the same
     bits required under the other built cluster size;
  6. the m = 2048 path: solve_batch_exact at B = 64, m = n = 2048 (a
     warm-up and one timed run, whose launch counts are kept, with the
     streaming kernel's time inside it from CUDA events) and the dd-KKT
     certificate on every lane.  HiGHS is skipped at this size
     (minutes per lane on the host); the oracle-free certificate is the
     check;
  7. solve_bounded_segment: CUDA kernel against its plain version at
     [1024, 256, 512] from the all-slack start of device_bounded_lps: one
     iteration (bit for bit), a 16-iteration segment, a full run by status
     and objective; then 16 iterations in lockstep at phase 3's shapes in
     packed and unpacked mode; each with its plan report as in phase 3;
  8. the bounded path: solve_batch_bounded at B = 1024, m = n = 256 (wall:
     the median of 5 runs after a warm-up; launch counts from the first):
     all lanes OPTIMAL, HiGHS gap on 4 lanes, x within its bounds, Ax = b;
     one more solve with refactor_every = 256 holds x to its bounds 20
     times tighter (the bench setting's slack is unrefactored f32 drift);
  9. step kernels: price_entering and ratio_eta_pivot against their plain
     versions at the Phase-I shape [1024, 256, 768], then 64 calls of
     batched_primal_step on the kernels, each held against the same step
     on the plain versions from the same state;
 10. recovery: (a) B = 256, m = n = 256, the IPM starved with maxiters = 4,
     then recover_stragglers_pooled: every lane OPTIMAL, its basis
     certified on >= 99 %, HiGHS gap on 4 lanes, kernel 1 launched in both
     modes; (b) 4 chunks of 128 lanes at m = n = 512,
     IPMConfig(eps_rel=1e-3, maxiters=40): raw wall and optimal count,
     recovered wall and optimal count, the bucket, the pivots;
 11. warm re-solves: (a) B = 1024, m = n = 256 in standard form, a
     two-phase base solve, the right-hand side scaled by 1 + 0.05 N(0, 1),
     then reoptimize_batch_new_rhs from the base bases (every lane OPTIMAL
     or DUAL_UNBOUNDED, HiGHS on 4 lanes, fewer pivots than the fresh
     solve); (b) 4 chunks of 128 at m = n = 512, h perturbed by 2 %,
     reoptimize_ipm_batch_canonical against a cold solve (costs within
     5e-3 relative of each other and of HiGHS on 4 lanes);
 12. router: solve_batch_auto at B = 1024, m = n = 128, accuracy 1e-6;
     B = 128, m = n = 512, accuracy 1e-3; B = 256, m = n = 256, accuracy
     1e-6 (wall: the median of 5 runs after a warm-up; launch counts from
     the first); B = 4, m = n = 4096, accuracy 1e-4 (the default table's
     pdhg_min_m: the median of 2 runs after a warm-up, all lanes OPTIMAL,
     against the exact pipeline's dd-certified vertices, HiGHS taking over
     ten minutes a lane there: lane 0 within 1e-3, every lane within 1e-2,
     x feasible to 2e-4); with the family each took (simplex,
     ipm, ipm+crossover and pdhg are all driven); an unbounded and an
     infeasible hand-built lane through solve_batch_two_phase give a ray
     and a Farkas vector;
 13. calibrate(sizes=(128, 256), lanes=64, pdhg_sizes=(1024,),
     pdhg_lanes=16) on the card: the table, the keys it measured (all six)
     and both sides' seconds of the PDHG leg;
 14. stream_m4096: the streaming kernel against its plain version at B = 4,
     (4096, 8192), primal with the blocked-factor direction sum and dual
     unblocked and unpacked (as the m = 4096 crossover launches them): one
     iteration,
     16 pivots in lockstep (bfs within 1e-4 of scale), the same bits under
     the other planned cluster size, each with its plan, the CTAs it
     occupies and the in-segment time a batch-iteration over 64 pivots
     beside the bound;
 15. the m = 4096 path: solve_batch_exact at B = 4, m = n = 4096 (the
     reference's exact_m4096 leg: a warm-up and one timed run, with
     CUDA-event spans of its stages, kernel 3's launches by mode and the
     peak device memory), then the dd-KKT certificate: every lane reported
     crossed is certified, no lane NUMERICAL_ERROR, kernel 3 ran in dual
     mode, the two-phase fallback did not run;
 16. bounded_block: the bounded kernel's streaming branch (a cluster of
     CTAs a lane, past the largest resident cluster) against its plain
     version at [16, 1280, 2560] (past the v5e line: one iteration bit for
     bit, 16 in lockstep, packed and unpacked, the same bits under every
     other planned layout; its plan, resident clusters and in-segment ms
     an iteration beside the bound and beside the block-per-lane branch it
     replaced), then
     solve_batch_bounded on B = 16, m = 1280 with phase 8's settings and
     guards (its iteration cap scaled by m^2; one run, no warm-up);
 17. pdhg_m256: pdhg_solve_batch_canonical at B = 1024, m = n = 256, eps
     1e-4, fixed-cadence restarts, 60000 iterations at most (the median
     wall of 5 runs after a warm-up, the iterations, the device's idle
     share over a profiled 640-iteration run, the GEMV bound of a step):
     1024/1024 OPTIMAL, HiGHS within 1e-3 on 16 lanes; then
     pdhg_crossover_batch_canonical on the same batch: crossed lanes,
     >= 99 % of them dd-KKT certified, kernel 1 launched in both modes;
 18. sparse_ipm_m2048: B = 128, m = n = 2048 at 1 % density from
     device_sparse_inequality_lps: the raw sparse IPM (eps 1e-3, 40 steps,
     frac 0.995: wall, OPTIMAL lanes, kernel 2's launches, peak device
     memory, idle share), recover_stragglers_sparse (no lane worse, kernel
     3 launched when there are stragglers), the sparse PDHG on the same
     instances (adaptive, eps 1e-4), solve_batch_auto_sparse at accuracy
     1e-3 (sparse-ipm) and 1e-2 (sparse-pdhg), HiGHS on two lanes (two
     worker processes, meanwhile), and the same bits from a repeat of each
     solve;
 19. general_form: the general-form surface.  (a) Single instances on the
     card: the diet LP through SimplexSolver (12.081337630748749 within
     1e-6), the published Bland path through PrimalRevisedSimplexSolver
     one solve(maxiters=1) at a time, the 15 instances of
     structured.default_suite() within 1e-5 of HiGHS; (b)
     solve_batch_general on 1024 instances of the 11 structured families
     (bounds as rows, padded to m = 240) with dantzig and with devex
     (median wall of 5 after a warm-up, pivots, kernel 1's plan and
     launches; every lane OPTIMAL, HiGHS within 1e-5 on 16), the default
     config once as a reading, presolve=True with a planted infeasible
     and a planted fixed lane (costs unchanged within 1e-5), and
     transportation_lps(1024, 32, 32) through solve_batch_two_phase; (c)
     solve_primal_dual_batch on 256 lanes of the textbook problems; (d)
     IPMSolver at m = 512 with 64 equality rows and 128 upper bounds
     (kernel 2's launches, HiGHS within 1e-3 in a worker process), and a
     warm resolve of h perturbed by 2 % in no more Newton steps than cold;
     (e) ranging_batch at phase 4's bases in f32 and in float64 on the
     card, each against a float64 host ranging on 4 lanes (float64 within
     1e-9; f32's error printed);
 20. parallel: (a) one rank over NCCL: sharded_two_phase_solve and
     sharded_ipm_batch_canonical at B = 1024, m = n = 256 bit for bit
     against the unsharded solves (walls in turns, kernels 1 and 2
     launched); (b) two processes sharing the card over gloo
     (chip_smoke.py --dp-worker), 512 lanes each: statuses equal to (a)'s
     unsharded run, costs within 1e-5, bit-identical lanes counted; (c)
     tp_solve on one LP at m = 1024, n = 2048 (dantzig, slack basis): the
     same status and basis as engine.run at B = 1, its vertex within 1e-5
     of HiGHS, ms a pivot; (d) a SimplexState (Phase I on kernel 1) and a
     PDHGState checkpointed mid-solve, loaded and resumed to the
     uninterrupted runs' bits; solve_report on (a)'s result with the lanes
     below x >= 0; a profiler trace holding its label; an LP written to
     MPS, read back and solved by SimplexSolver within 1e-6 of HiGHS;
     dryrun(1, "cuda");
 21. last_modes: the reference's last modes.  (a) kernel 1's split-bf16
     pricing at [1024, 256, 512], primal dantzig: 16 pivots in lockstep
     with its plain version on every lane (bfs within 1e-4 of scale), a
     full run on the
     segment driver with the unsplit run's statuses and costs within 1e-4;
     (b) the ablation modes 1-7 there (ablate = 0 the kernel's bits); the
     in-segment ms an iteration of unsplit, split and each mode, and of the
     plain versions; (c) kernel 3's sectional pricing at B = 64,
     (2048, 4096), n_blk 256 (16 sections): 16 pivots in lockstep with its
     plain version on every lane, the same bits at the other cluster size, ms an iteration
     against full pricing and against the section's bound, and 8 lanes
     solved to OPTIMAL with full and sectional pricing (costs within 1e-4,
     pivots compared); (d) solve_batch_two_phase with
     refactor_method="ns" at B = 1024, m = n = 256: every lane OPTIMAL,
     HiGHS within 1e-5 on 16; (e) the IPM at B = 1024, m = n = 256 in f32
     and float64: minv in float64 with at least the f32 default's OPTIMAL
     lanes, gondzio=2 with at least the default's in float64, the f32
     Gondzio and minv counts reported; (f) ipm_crossover_batch_canonical(guess="slack") at
     B = 256, m = n = 256: every crossed lane certified; (g) the sparse IPM
     with assembly="cumsum" against "segment" at B = 16, m = n = 2048, 1 %
     (statuses, costs, walls in turns);
 22. exact_m1024: the reference's ipm_xover_m1024 leg (bench.py:983):
     solve_batch_exact at B = 32, m = n = 1024, past the cluster line (a
     warm-up, then the median of 3 timed runs with CUDA events; crossed,
     retry_crossed and fallback; kernel 1's launches by branch and mode,
     the streaming branch in both; CUDA-event spans of kernel 1, the
     batched LU and the stages), the dd-KKT certificate on every lane
     outside the wall and HiGHS on one lane in a worker process: 32/32
     OPTIMAL, >= 31 certified, HiGHS gap <= 1e-5;
 23. dd_kernel: the double-word kernel (refine.py's split products and
     compensated sums in one launch) against refine.py's eager chain on the
     same card tensors, bit for bit: the residual bvec - y M and the product
     y M over a row-major M and over the transposed view at [1024, 256,
     256], the bounded right-hand side's A^T [1024, 512, 256], [32, 1024,
     1024], [64, 2048, 2048] and [4, 4096, 4096]; the sum-only entry point
     at the pricing's partials [1024, 32, 768], [32, 128, 2048], [64, 256,
     4096] and [4, 512, 8192]; each with the median ms of the kernel and of
     the plain chain and its bound.  Its launches are counted on phase 4's
     timed run, phases 6 and 8 and every path that counts launches.
 24. lu_kernel: the batched LU kernel (engine.inv_or_nan / solve_or_nan
     for float32 lanes up to m = 256, one launch a call) at [1024, 256,
     256], [8, 256, 256] and [1, 256, 256]: the inverse and the solve
     against torch.linalg in float64 (the kernel's largest error over lanes
     at most twice that of torch.linalg in float32) and against the plain
     version, with the median ms of the kernel, of the plain version and of
     torch.linalg's inv_ex / solve_ex (library_ms: the yardstick, which the
     port no longer calls at these shapes) and the bound.  Its launches are
     counted on phases 4, 6 (none: m = 2048 keeps torch.linalg) and 8 and
     every path that counts launches.
The line before the last lists each kernel (launches on its path, error
against its plain version, times, and the least time the card could take:
each input byte read once and each output byte written once at 3.35 TB/s,
or the operations at 67 TFLOP/s of f32, whichever is larger).  The last
line is
{"ok": true, "device": {...}} and is printed only if every phase passed;
any failure exits nonzero.  Without a CUDA device it exits nonzero at once.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

import linprog_tpu_torch as lt
from linprog_tpu_torch import refine as lr
from linprog_tpu_torch import status as st
from linprog_tpu_torch.config import tuned_config
from linprog_tpu_torch.engine import (basis_matrix, slack_crash_state,
                                      solve_or_nan)
from linprog_tpu_torch.engine_batched import _segment_pack
from linprog_tpu_torch.generators import (
    device_bounded_lps,
    device_inequality_lps,
    device_standard_form_batch,
)
from linprog_tpu_torch.ops import _build
from linprog_tpu_torch.ops import bounded_kernel as bk
from linprog_tpu_torch.ops import cholinv_kernel as ck
from linprog_tpu_torch.ops import dd_kernel as ddk
from linprog_tpu_torch.ops import lu_kernel as luk
from linprog_tpu_torch.ops.plans import StreamingPlan
from linprog_tpu_torch.ops import solve_kernel as sk
from linprog_tpu_torch.ops import step_kernels as stk
from linprog_tpu_torch.ops import stream_kernel as ssk

B = 1024
M = N = 256
SEED = 0
DEVICE = "cuda"
REPEATS = 10  # timed m = 256 runs after the warm-up (median reported)
XB, XM = 64, 2048  # the m = 2048 path: lanes, m = n
BOUNDED_REPEATS = 5  # timed bounded runs after the warm-up (median)
BOUNDED_MAXITERS = 6000
SPLIT_LANES = 16  # lanes of 1024 that may leave lockstep over 16 pivots
# kernel 1 on the front door's paths (lanes, m, structural n): the recovery
# bucket at m = 512, the crossover at m = 256, the two-phase simplex at
# m = 128 with its artificials
SEGMENT_SHAPES = [(64, 512, 512), (256, 256, 256), (1024, 128, 256)]
# kernel 1's streaming branch: a lane past the largest cluster
BLOCK_SHAPE = (64, 1024, 1024)
# kernel 1's unit layout at B = 1024, m = 256: the two-phase simplex's
# Phase-I lanes [G | I | I] (n = 768, 4 CTAs a lane against the dense 8)
# and the crossover's [G | I] (n = 512, 4 either way); the modes it holds
UNIT_KINDS = ("two_phase", "slack")
UNIT_MODES = ((False, 1), (True, 1), (False, 2))  # (dual, pricing)
# the block-per-lane branch it replaced there: ms a batch-iteration in a
# 64-pivot segment, primal and dual (PERF.md, section 6, kernel 1's history)
REPLACED_SEGMENT_BLOCK_MS = {"primal": 2.216, "dual": 2.859}
SEGMENT_PIVOTS = 64  # pivots of the segment timed inside one launch
# kernel 2 on those paths (lanes, mb): the IPM at B = 128 and at B = 256
CHOLINV_SHAPES = [(B, 32), (XB, 32), (128, 32), (256, 32), (B, 48),
                  (4, 32)]
RECOVERY_GUARD = (256, 256)  # phase 10a: lanes, m = n
IPM_CHUNKS = (4, 128, 512)  # phases 10b and 11b: chunks, lanes a chunk, m = n
ROUTER_REGIMES = [  # phase 12: expected family, lanes, m = n, accuracy
    ("simplex", 1024, 128, 1e-6),
    ("ipm", 128, 512, 1e-3),
    ("ipm+crossover", 256, 256, 1e-6),
]
ROUTER_REPEATS = 5  # timed runs of each regime after the warm-up (median)
# the first-order regime: the default table's pdhg_min_m at accuracy 1e-4;
# its runs take seconds, so fewer of them
ROUTER_PDHG = ("pdhg", 4, 4096, 1e-4)
ROUTER_PDHG_REPEATS = 2
CALIBRATE_SIZES = (128, 256)  # phase 13, at 64 lanes
CALIBRATE_PDHG = ((1024,), 16)  # phase 13's PDHG leg: sizes, lanes
# phase 17: the reference's pdhg_m256 leg (bench.py:430): lanes, m = n,
# eps, iteration cap; median of PDHG_REPEATS after a warm-up
PB, PM, PDHG_EPS, PDHG_MAXITERS = 1024, 256, 1e-4, 60_000
PDHG_REPEATS = 5
PROFILE_ITERS = 640  # the profiled window of a PDHG run: 10 chunks of 64
PROFILE_STEPS = 4  # the profiled window of a sparse IPM run: Newton steps
# phase 18: the reference's sparse_ipm_m2048 leg (bench.py:668): lanes,
# m = n, density
SB, SM, SDENS = 128, 2048, 0.01
# phases 14 and 15: the reference's exact_m4096 leg (bench.py:757): lanes,
# m = n; the crossover's lanes are (4096, 8192), past the blocked-factor line
XLB, XLM = 4, 4096
# phase 22: the reference's ipm_xover_m1024 leg (bench.py:983): lanes, m = n,
# timed runs after the warm-up (median)
XMB, XMM, XM_REPEATS = 32, 1024, 3
# phase 16: kernel 4's streaming branch past the v5e line: lanes, m = n
# (lanes of (1280, 2560)).  The iteration cap scales phase 8's with m^2, as
# the iterations a lane of device_bounded_lps needs grow
BBB, BBM = 16, 1280
BLOCK_BOUNDED_MAXITERS = BOUNDED_MAXITERS * (BBM // M) ** 2
# the block-per-lane branch the streaming branch replaced, at [16, 1280,
# 2560]: ms a batch-iteration in a 64-pivot segment, packed (PERF.md,
# section 6, kernel 4's history)
REPLACED_BLOCK_MS = 3.182
# phase 23: the double-word kernel at the paths' shapes (lanes, m, n): the
# m = 256 basis matrices, the bounded right-hand side over A^T, the m = 1024,
# 2048 and 4096 basis matrices; its sum-only entry point at the partials
# P[lanes, m / 8, n] of the pricing over each path's [G | I] (m = 256: the
# two-phase simplex's Phase-I [G | I | I])
DD_SHAPES = [(B, M, M), (B, 2 * M, M), (XMB, XMM, XMM), (XB, XM, XM),
             (XLB, XLM, XLM)]
DD_SUM_SHAPES = [(B, M // 8, 3 * M), (XMB, XMM // 8, 2 * XMM),
                 (XB, XM // 8, 2 * XM), (XLB, XLM // 8, 2 * XLM)]
DD_REPS, DD_PLAIN_REPS = 20, 5  # timed calls of the kernel, of the plain chain
# phase 24: the batched LU kernel at the m = 256 paths' lanes (B, m)
LU_SHAPES = [(B, M), (8, M), (1, M)]
LU_REPS, LU_PLAIN_REPS = 10, 2  # timed calls: the kernel, the plain version
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores


REPORTS = {}  # each phase's last printed report, by its name
DD_PATHS = {}  # the double-word kernel's launches on phase 8's timed run
LU_PATHS = {}  # the batched LU kernel's launches on phase 8's timed run
MAIN_PATH = {}  # phase 4's exact bases, for phase 19's ranging
T0 = time.time()  # the script's start: each phase report carries its time


def emit(obj):
    if "phase" in obj:
        obj["t_s"] = time.time() - T0
        REPORTS[obj["phase"]] = obj
    print(json.dumps(obj), flush=True)


def flush_native_stdout():
    """Flush the C library's stdio buffers: a library that prints through
    them (MAGMA notes each large batched factorization of phase 15) would
    otherwise land after the last line."""
    import ctypes

    sys.stdout.flush()
    ctypes.CDLL(None).fflush(None)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def bound_ms(n_bytes, n_flops):
    """The least milliseconds the card could take: each input byte read
    once and each output byte written once at the device-memory rate, or
    the operations at the f32 rate, whichever is larger."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * n_flops / F32_FLOPS_PER_S
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def _a_work(m, n, n_d):
    """Floats of A a lane reads and products its pricing takes: all of A,
    m n; in kernel 1's unit layout (``n_d`` < n) the leading n_d columns
    and the row and value of each unit column, m n_d + 2 (n - n_d), and
    one product a unit column, m n_d + (n - n_d)."""
    n_d = n if n_d is None else n_d
    return m * n_d + 2 * (n - n_d), m * n_d + (n - n_d)


def segment_bound_ms(lanes, pivoting, m, n, n_d=None):
    """One batch-iteration of a whole-segment simplex kernel: A (in the
    unit layout its held columns and map, :func:`_a_work`) and the factor
    read once per lane, the factor written once per pivoting lane, the
    O(m + n) rows read and written once."""
    a_floats, products = _a_work(m, n, n_d)
    n_bytes = 4 * (lanes * (a_floats + m * m + 2 * (5 * m + 3 * n))
                   + pivoting * m * m)
    n_flops = lanes * (2 * products + 4 * m * m) + pivoting * 2 * m * m
    return bound_ms(n_bytes, n_flops)


def launch_bound_ms(lanes, m, n, pivots, n_d=None):
    """One launch of a whole-segment kernel that runs ``pivots`` iterations
    on every lane: A (in the unit layout its held columns and map,
    :func:`_a_work`), the factor and the O(m + n) rows read once, the
    factor and the rows written once; the iterations' operations (pricing
    2mn, or 2 (m n_d + n - n_d) in the unit layout, the duals, the
    direction and the eta update 2m^2 each) at the f32 rate."""
    a_floats, products = _a_work(m, n, n_d)
    n_bytes = 4 * lanes * (a_floats + 2 * m * m + 2 * (5 * m + 3 * n))
    n_flops = lanes * pivots * (2 * products + 6 * m * m)
    return bound_ms(n_bytes, n_flops)


def same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _branch(plan):
    """The branch of a whole-segment kernel's plan (kernels 1 and 4)."""
    return "streaming" if isinstance(plan, StreamingPlan) else "cluster"


def _layout(plan):
    """A plan in words: its CTAs a lane, and a streaming plan's CTAs an SM
    and load branch."""
    if isinstance(plan, StreamingPlan):
        return (f"{plan.cluster} CTAs a lane ({plan.ctas_per_sm} an SM, "
                f"{'ring' if plan.aligned else 'scalar loads'})")
    return f"{plan.cluster} CTAs a lane"


def _plan_report(kernel, run_plan, fresh, shape, ref16, label, devex=False,
                 n_d=None):
    """The launch plan of a whole-segment kernel (``kernel`` is the module:
    ``solve_kernel`` or ``bounded_kernel``; ``n_d``: kernel 1's unit layout,
    its plans and bounds) at ``shape`` and what it gives:
    the plan ``ref16`` was run under (the last launch's) and the clusters
    the card holds at once; the same state bit for bit after 16 pivots
    under every other planned cluster size (and, on a streaming branch,
    every other built layout); a 64-pivot segment's time (CUDA events,
    median of 3 from fresh states) and its time an iteration, beside the
    launch bound and the one-iteration bound."""
    b, m, n = shape
    chosen = kernel.last_plan
    others = []
    if kernel is sk and isinstance(chosen, StreamingPlan):
        plans = sk.built_stream_plans(b, m, n, devex=devex)
    elif kernel is sk:
        plans = sk.segment_plans(b, m, n, devex=devex, n_d=n_d)
    else:
        plans = kernel.segment_plans(b, m, n)
    for plan in plans:
        if plan == chosen:
            continue
        s = run_plan(plan, fresh(), 16)
        torch.cuda.synchronize()
        for name, x, y in zip(s._fields, s, ref16):
            if not same_bits(x, y):
                fail(f"{label} {list(shape)}: {name} after 16 pivots differs "
                     f"between {_layout(plan)} and {_layout(chosen)}")
        others.append(_layout(plan) if isinstance(plan, StreamingPlan)
                      else plan.cluster)
        del s
    last = []

    def timed(pivots):
        states = iter([fresh() for _ in range(3)])

        def seg():
            last[:] = [run_plan(chosen, next(states), pivots)]

        return cuda_ms(seg, 3)

    ms1 = timed(1)
    ms = timed(SEGMENT_PIVOTS)
    held = kernel.clusters_held(chosen)
    lb_ms, lb_by = launch_bound_ms(b, m, n, SEGMENT_PIVOTS, n_d)
    return {"plan": chosen._asdict(),
            "branch": _branch(chosen),
            "resident_clusters": held,
            "same_bits_at_clusters": others,
            "segment": {"pivots": SEGMENT_PIVOTS, "ms": ms, "one_pivot_ms": ms1,
                        # inside the segment: the launch's loading left out
                        "ms_per_iter": (ms - ms1) / (SEGMENT_PIVOTS - 1),
                        "max_iters": int(last[0].iters.max()),
                        "launch_bound_ms": lb_ms, "launch_bound_by": lb_by,
                        "launch_bound_ms_per_iter": lb_ms / SEGMENT_PIVOTS}}


def status_counts(status):
    return {st.status_name(k): int(v) for k, v in
            zip(*torch.unique(status, return_counts=True))}


def highs_gap(cost, c, lanes, **problem):
    """Largest relative objective gap of ``cost`` against HiGHS on the
    first ``lanes`` lanes; ``problem`` holds per-lane keyword arrays of
    scipy's linprog (``bounds`` as a [B, n, 2] array with inf for none)."""
    from scipy.optimize import linprog

    gaps = []
    for i in range(lanes):
        kw = {k: v[i].double().cpu().numpy() for k, v in problem.items()}
        if "bounds" in kw:
            kw["bounds"] = [(lo, None if np.isinf(hi) else hi)
                            for lo, hi in kw["bounds"]]
        ref = linprog(c[i].double().cpu().numpy(), method="highs", **kw)
        if ref.status != 0:
            fail(f"HiGHS did not solve lane {i} ({ref.message})")
        gaps.append(abs(float(cost[i]) - ref.fun) / max(1.0, abs(ref.fun)))
    return float(max(gaps))


def exact_check(x, cost, c, G, h):
    """``x``, ``cost`` against the exact pipeline's vertices on the lanes
    whose basis the dd-KKT certificate passes: each lane's relative
    objective gap (None where uncertified) and its primal infeasibility
    ``||max(Gx - h, 0)|| / (1 + ||h||)`` in float64."""
    exact, _ = lt.solve_batch_exact(c, G, h)
    ok = lt.certify_vertex_batch(c, G, h, exact.basis)["certified"].tolist()
    opt = exact.cost.double()
    rel = ((cost.double() - opt).abs() / opt.abs().clamp_min(1.0)).tolist()
    viol = torch.clamp_min(torch.einsum("bmn,bn->bm", G.double(), x.double())
                           - h.double(), 0.0)
    infeas = (torch.linalg.vector_norm(viol, dim=1)
              / (1.0 + torch.linalg.vector_norm(h.double(), dim=1)))
    return {"gaps": [g if k else None for g, k in zip(rel, ok)],
            "optimum": opt.tolist(), "primal_infeasibility": infeas.tolist()}


def phase_environment():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = _build._nvcc()
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    nvcc_version = out[-1] if out else None
    env = {
        "phase": "environment",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_version,
        "nvcc_path": nvcc,
        "tf32": False,
    }
    emit(env)
    return env


def phase_build():
    t0 = time.time()
    path = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.time() - t0,
          "nvcc_seconds": _build.build_seconds, "library": path,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in _build.build_log.items()}})


def spd_batch(gen, b, mb, cond):
    """Random SPD matrices with eigenvalues log-spaced over [1/cond, 1]."""
    X = torch.randn((b, mb, mb), generator=gen, device=DEVICE,
                    dtype=torch.float64)
    Q, _ = torch.linalg.qr(X)
    lam = torch.logspace(0, -np.log10(cond), mb, device=DEVICE,
                         dtype=torch.float64)
    Mat = (Q * lam[None, None, :]) @ Q.transpose(1, 2)
    return (0.5 * (Mat + Mat.transpose(1, 2))).float().contiguous()


def _hold_cholinv(gen, b, mb):
    """panel_cholinv's kernel against its plain version on ``b`` SPD
    matrices of size ``mb`` (cond ~1e3) with one planted non-SPD lane."""
    Mat = spd_batch(gen, b, mb, 1e3)
    bad = min(7, b - 1)
    Mat[bad] = -Mat[bad]  # planted non-SPD lane
    W = ck.panel_cholinv(Mat)
    Wp = ck.panel_cholinv_plain(Mat)
    torch.cuda.synchronize()
    good = torch.ones(b, dtype=torch.bool, device=DEVICE)
    good[bad] = False
    shape = [b, mb, mb]
    for name, w in (("kernel", W), ("plain", Wp)):
        if torch.isfinite(w[bad]).all():
            fail(f"panel_cholinv {shape} {name}: planted non-SPD lane came "
                 "out finite")
        if not torch.isfinite(w[good]).all():
            fail(f"panel_cholinv {shape} {name}: non-finite output on an SPD "
                 "lane")
    err = (W[good] - Wp[good]).abs().max().item()
    rel = err / Wp[good].abs().max().item()
    if not rel <= 1e-4:
        fail(f"panel_cholinv {shape}: kernel vs plain max relative diff "
             f"{rel:.3e} > 1e-4")
    ms = cuda_ms(lambda: ck.panel_cholinv(Mat), 20)
    plain_ms = cuda_ms(lambda: ck.panel_cholinv_plain(Mat), 20)

    # a single launch this short is timed with its own launch latency; 50
    # launches back to back between two events show the kernel's share
    def burst():
        for _ in range(50):
            ck.panel_cholinv(Mat)

    burst_ms = cuda_ms(burst, 5) / 50
    # no single PyTorch call computes the inverse factor; the nearest is a
    # pair of calls, timed as a yardstick (the port never uses it)
    eye = torch.eye(mb, device=DEVICE).expand(b, mb, mb)
    spd = Mat[good]

    def two_calls():
        L, _ = torch.linalg.cholesky_ex(spd)
        return torch.linalg.solve_triangular(L, eye[:spd.shape[0]],
                                             upper=False)

    two_call_ms = cuda_ms(two_calls, 20)
    b_ms, b_by = bound_ms(2 * b * mb * mb * 4, b * 2 * mb ** 3 // 3)
    return {"shape": shape, "cond": 1e3,
            "design": "warp per matrix" if mb <= 32 else "block per matrix",
            "max_abs_err": err, "max_rel_err": rel, "tol_rel": 1e-4,
            "bit_for_bit": bool(torch.equal(W[good], Wp[good])),
            "ms": ms, "plain_ms": plain_ms, "reps": 20,
            "ms_back_to_back": burst_ms,
            "cholesky_ex_plus_solve_triangular_ms": two_call_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_cholinv():
    """Phase 2: the IPM's panels at every batch size the paths give
    ([1024, 32, 32] at m = 256, [64, 32, 32] at m = 2048, [128, 32, 32] and
    [256, 32, 32] on the front door's) on the warp-per-matrix kernel, and
    one size past 32 on the block-per-matrix kernel."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    runs = [_hold_cholinv(gen, b, mb) for b, mb in CHOLINV_SHAPES]
    out = dict(runs[0], phase="panel_cholinv", other_shapes=runs[1:])
    emit(out)
    return out


def _segment_instance(dual, b=B, m=M, n_g=N, seed=SEED + 2):
    """A crossover-shaped lane batch ([G | I], b x m x (n_g + m)) from the
    slack basis: primal mode on Gx <= |h| (feasible start), dual mode on
    min |c|'x, Gx <= h (dual-feasible start)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    c, G, h = device_inequality_lps(gen, b, m, n_g, DEVICE)
    if dual:
        c = c.abs()
    else:
        h = h.abs()
    eye = torch.eye(m, device=DEVICE).expand(b, m, m)
    A = torch.cat([G, eye], dim=2).contiguous()
    cs = torch.cat([c, torch.zeros((b, m), device=DEVICE)], dim=1).contiguous()
    n = n_g + m
    basis = torch.arange(n_g, n, dtype=torch.int32, device=DEVICE).expand(b, m)
    pen = torch.zeros((b, n), device=DEVICE)
    pen[:, n_g:] = float("inf")
    state = sk.SegmentState(
        invBT=eye.contiguous().clone(),
        bfs=h.contiguous().clone(),
        cB=torch.zeros((b, m), device=DEVICE),
        basis=basis.contiguous().clone(),
        pen=pen,
        gamma=torch.ones((b, n), device=DEVICE),
        iters=torch.zeros(b, dtype=torch.int32, device=DEVICE),
        status=torch.zeros(b, dtype=torch.int32, device=DEVICE),
    )
    apen = torch.zeros((b, n), device=DEVICE)
    return A, cs, apen, h, state


def _near_tie(keys, bits):
    """bool[B]: the two smallest packed keys lie within one tie bucket."""
    k = keys.long().sort(dim=1).values
    k1, k2 = k[:, 0], k[:, 1]
    return (k2 != sk.INTMAX) & ((k2 >> bits) - (k1 >> bits) <= 1)


def _tie_lanes(A, c, state, dual, cfg):
    """Lanes whose one-iteration choice may flip under summation-order
    noise: the two best packed keys (entering, then leaving) are within
    one low-bit tie bucket."""
    Bn, m, n = A.shape
    bits_n = max(1, (n - 1).bit_length())
    bits_m = max(1, (m - 1).bit_length())
    lane_n = torch.arange(n, dtype=torch.int32, device=DEVICE)
    lane_m = torch.arange(m, dtype=torch.int32, device=DEVICE)
    invBT, bfs, cB, pen = state.invBT, state.bfs, state.cB, state.pen
    y = torch.einsum("bi,bji->bj", cB, invBT)
    if dual:
        neg = bfs < -cfg.feas_tol
        kl = sk.pack_min_keys(bfs, neg, lane_m, bits_m, True).min(dim=1).values
        leave = torch.where(kl != sk.INTMAX, kl & ((1 << bits_m) - 1), 0)
        w = torch.gather(invBT, 2, leave.long()[:, None, None].expand(Bn, m, 1))[:, :, 0]
        urow = torch.einsum("bj,bjk->bk", w, A)
        r = c - torch.einsum("bj,bjk->bk", y, A)
        cand = (urow < -cfg.pivot_tol) & (pen == 0.0)
        theta = torch.where(cand, -r / torch.where(cand, urow, -1.0), float("inf"))
        keys = sk.pack_min_keys(torch.clamp_min(theta, 0.0) + 0.0, cand, lane_n,
                             bits_n, False)
        return _near_tie(keys, bits_n)
    r = c - torch.einsum("bj,bjk->bk", y, A) + pen
    neg = r < -cfg.opt_tol
    keys = sk.pack_min_keys(r, neg, lane_n, bits_n, True)
    tie = _near_tie(keys, bits_n)
    k0 = keys.min(dim=1).values
    enter = torch.where(k0 != sk.INTMAX, k0 & ((1 << bits_n) - 1), 0)
    a = torch.gather(A, 2, enter.long()[:, None, None].expand(Bn, m, 1))[:, :, 0]
    d = torch.einsum("bj,bji->bi", a, invBT)
    pos = d > cfg.pivot_tol
    theta = torch.where(pos, (torch.clamp_min(bfs, 0.0) + 0.0)
                        / torch.where(pos, d, 1.0), float("inf"))
    tkeys = sk.pack_min_keys(theta, pos, lane_m, bits_m, False)
    return tie | _near_tie(tkeys, bits_m)


def _exact_objective(A, c, h, seg):
    xB = solve_or_nan(basis_matrix(A, seg.basis), h)
    cB = torch.gather(c, 1, seg.basis.long())
    return (cB.double() * xB.double()).sum(dim=1)


def _hold_segment(dual, b, m, n_g, pricing=1):
    """Kernel 1 against its plain version at [b, m, n_g + m] with the
    settings of the tuned configuration: one iteration (basis and status
    equal on every lane without a near tie) and a 16-pivot segment (basis,
    status, iteration count, penalties and basic costs equal on all but
    ``SPLIT_LANES`` of 1024 lanes, at least 2; ``bfs`` within 1e-4 of its
    scale on the lanes in lockstep)."""
    cfg = tuned_config(m)
    A, c, apen, h, state0 = _segment_instance(dual, b, m, n_g,
                                              seed=SEED + 2 + m)
    kw = dict(pricing=pricing, opt_tol=cfg.opt_tol,
              pivot_tol=cfg.pivot_tol, dual=dual, feas_tol=cfg.feas_tol,
              stall_limit=cfg.stall_limit, packed=cfg.packed_select)
    mode = ("dual" if dual else "primal") + (" devex" if pricing == 2 else "")
    shape = [b, m, n_g + m]

    def fresh():
        return sk.SegmentState(*(t.clone() for t in state0))

    k1 = sk.solve_segment(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
    p1 = sk.solve_segment_plain(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
    torch.cuda.synchronize()
    tie = _tie_lanes(A, c, state0, dual, cfg)
    bad = ~tie & ~_lockstep_lanes(k1, p1, ("basis", "status"))
    if bad.any():
        fail(f"solve_segment {mode} {shape}: one-iteration basis/status "
             f"differ on {int(bad.sum())} non-tied lanes")
    err1 = (k1.bfs[~tie] - p1.bfs[~tie]).abs().max().item()
    pivoted = int((k1.basis != state0.basis).any(dim=1).sum())
    if pivoted == 0:
        fail(f"solve_segment {mode} {shape}: no lane pivoted")

    k16 = sk.solve_segment(A, c, apen, 1 << 20, fresh(), seg_len=16, **kw)
    p16 = sk.solve_segment_plain(A, c, apen, 1 << 20, fresh(), seg_len=16,
                                 **kw)
    torch.cuda.synchronize()
    if (_branch(sk.last_plan) == "streaming") != ((m, n_g) == BLOCK_SHAPE[1:]):
        fail(f"solve_segment {mode} {shape}: took the "
             f"{_branch(sk.last_plan)} branch")
    same = _lockstep_lanes(k16, p16, ("basis", "status", "iters", "pen",
                                      "cB"))
    split, allowed = int((~same).sum()), max(2, b * SPLIT_LANES // B)
    if split > allowed:
        fail(f"solve_segment {mode} {shape}: the 16-pivot segment left "
             f"lockstep on {split} lanes (> {allowed})")
    scale = p16.bfs[same].abs().max().item()
    err16 = (k16.bfs[same] - p16.bfs[same]).abs().max().item()
    if not err16 <= 1e-4 * scale:
        fail(f"solve_segment {mode} {shape}: bfs differs by {err16:.3e} "
             f"after 16 pivots (> 1e-4 of {scale:.3e})")
    states = iter([fresh() for _ in range(10)])
    ms_k = cuda_ms(lambda: sk.solve_segment(A, c, apen, 1 << 20, next(states),
                                            seg_len=1, **kw), 10)
    states = iter([fresh() for _ in range(10)])
    ms_p = cuda_ms(lambda: sk.solve_segment_plain(
        A, c, apen, 1 << 20, next(states), seg_len=1, **kw), 10)
    b_ms, b_by = segment_bound_ms(b, pivoted, m, n_g + m)
    plan = _plan_report(sk, lambda pl, s, n_piv: sk.launch_with_plan(
        pl, A, c, apen, 1 << 20, s, seg_len=n_piv, **kw), fresh, tuple(shape),
        k16, f"solve_segment {mode}", devex=pricing == 2)
    return {"shape": shape, "mode": mode, **plan,
            "one_iter": {"excluded_tie_lanes": int(tie.sum()),
                         "pivoted_lanes": pivoted, "max_abs_err_bfs": err1,
                         "ms": ms_k, "plain_ms": ms_p, "reps": 10,
                         "bound_ms": b_ms, "bound_by": b_by},
            "segment16": {"lanes_in_lockstep": int(same.sum()),
                          "allowed_split": allowed,
                          "max_iters": int(k16.iters.max()),
                          "max_abs_err_bfs": err16, "tol": "1e-4 of scale",
                          "bfs_scale": scale}}


def _unit_instance(kind, dual):
    """``(A, c, apen, state0)`` for :func:`_hold_unit`: ``"slack"`` is
    :func:`_segment_instance`; ``"two_phase"`` the Phase-I lanes of the
    two-phase simplex at [B, M, N + 2M] (the standard form's sign-flipped
    rows, then the artificials) from the crash basis, with the Phase-I
    costs (primal mode) or, as in Phase II, |c| with the artificials barred
    and every third basic value negated (dual mode)."""
    if kind == "slack":
        A, c, apen, _, state0 = _segment_instance(dual)
        return A, c, apen, state0
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    c_std, A, b = device_standard_form_batch(*device_inequality_lps(
        gen, B, M, N, DEVICE))
    A = torch.cat([A, torch.eye(M, device=DEVICE).expand(B, M, M)],
                  dim=2).contiguous()
    crash = slack_crash_state(A, b, N + M)
    zeros = torch.zeros((B, M), device=DEVICE)
    if dual:
        cost = torch.cat([c_std.abs(), zeros], dim=1)
        crash = crash._replace(bfs=torch.where(
            torch.arange(M, device=DEVICE) % 3 == 0, -crash.bfs, crash.bfs))
        allowed = torch.arange(A.shape[2], device=DEVICE) < N + M
    else:
        cost = torch.cat([torch.zeros_like(c_std), zeros + 1.0], dim=1)
        allowed = torch.ones(A.shape[2], dtype=torch.bool, device=DEVICE)
    apen, state0 = _segment_pack(cost, A, crash, allowed)
    return A, cost.contiguous(), apen, state0


def _hold_unit(kind, dual, pricing):
    """Kernel 1's unit layout (the map of ``unit_columns``) against its
    plain version at ``kind``'s [1024, 256, n] with the tuned settings:
    one iteration (basis and status equal on every lane without a near
    tie) and a 16-pivot segment in lockstep (as :func:`_hold_segment`);
    the dense launch's state bit for bit after 16 pivots; whether
    ``solve_segment`` takes the layout (where it saves CTAs: n = 768);
    the plan report of the unit layout beside the dense launch's 64-pivot
    time an iteration, with the bounds of the work the layout does."""
    cfg = tuned_config(M)
    A, c, apen, state0 = _unit_instance(kind, dual)
    b, m, n = A.shape
    mode = ("dual" if dual else "primal") + (" devex" if pricing == 2 else "")
    label = f"solve_segment unit {kind} {mode} {[b, m, n]}"
    unit = sk.unit_columns(A)
    if unit is None or unit.n_d != N:
        fail(f"{label}: unit columns from "
             f"{None if unit is None else unit.n_d}, not {N}")
    kw = dict(pricing=pricing, opt_tol=cfg.opt_tol,
              pivot_tol=cfg.pivot_tol, dual=dual, feas_tol=cfg.feas_tol,
              stall_limit=cfg.stall_limit, packed=cfg.packed_select)
    devex = pricing == 2
    unit_plan = sk.segment_plans(b, m, n, devex=devex, n_d=unit.n_d)[0]
    dense_plan = sk.segment_plans(b, m, n, devex=devex)[0]

    def fresh():
        return sk.SegmentState(*(t.clone() for t in state0))

    def run(plan, s, pivots, layout=unit):
        return sk.launch_with_plan(plan, A, c, apen, 1 << 20, s,
                                   seg_len=pivots, unit=layout, **kw)

    before = sk.launches_unit
    k1 = run(unit_plan, fresh(), 1)
    p1 = sk.solve_segment_plain(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
    torch.cuda.synchronize()
    tie = _tie_lanes(A, c + apen, state0, dual, cfg)  # barred: never taken
    bad = ~tie & ~_lockstep_lanes(k1, p1, ("basis", "status"))
    if bad.any():
        fail(f"{label}: one-iteration basis/status differ on "
             f"{int(bad.sum())} non-tied lanes")
    err1 = (k1.bfs[~tie] - p1.bfs[~tie]).abs().max().item()
    pivoted = int((k1.basis != state0.basis).any(dim=1).sum())
    if pivoted == 0:
        fail(f"{label}: no lane pivoted")
    del k1, p1

    d16 = run(dense_plan, fresh(), 16, layout=None)
    k16 = run(unit_plan, fresh(), 16)
    p16 = sk.solve_segment_plain(A, c, apen, 1 << 20, fresh(), seg_len=16,
                                 **kw)
    torch.cuda.synchronize()
    if sk.launches_unit - before != 2:
        fail(f"{label}: the unit layout was not taken")
    for name, x, y in zip(k16._fields, k16, d16):
        if not same_bits(x, y):
            fail(f"{label}: {name} after 16 pivots differs from the dense "
                 "launch")
    same = _lockstep_lanes(k16, p16, ("basis", "status", "iters", "pen",
                                      "cB"))
    split = int((~same).sum())
    if split > SPLIT_LANES:
        fail(f"{label}: the 16-pivot segment left lockstep on {split} "
             f"lanes (> {SPLIT_LANES})")
    scale = p16.bfs[same].abs().max().item()
    err16 = (k16.bfs[same] - p16.bfs[same]).abs().max().item()
    if not err16 <= 1e-4 * scale:
        fail(f"{label}: bfs differs by {err16:.3e} after 16 pivots "
             f"(> 1e-4 of {scale:.3e})")
    del d16, p16
    takes = sk.unit_pays(b, m, n, unit.n_d, DEVICE)
    if takes != (kind == "two_phase"):
        fail(f"{label}: unit_pays is {takes}")

    states = iter([fresh() for _ in range(10)])
    ms_k = cuda_ms(lambda: run(unit_plan, next(states), 1), 10)
    states = iter([fresh() for _ in range(10)])
    ms_p = cuda_ms(lambda: sk.solve_segment_plain(
        A, c, apen, 1 << 20, next(states), seg_len=1, **kw), 10)
    dense_ms = {}
    for pivots in (1, SEGMENT_PIVOTS):
        states = iter([fresh() for _ in range(3)])
        dense_ms[pivots] = cuda_ms(
            lambda: run(dense_plan, next(states), pivots, layout=None), 3)
    del states
    b_ms, b_by = segment_bound_ms(b, pivoted, m, n, unit.n_d)
    run(unit_plan, fresh(), 1)  # the plan report's chosen plan
    plan = _plan_report(sk, lambda pl, s, n_piv: run(pl, s, n_piv), fresh,
                        (b, m, n), k16, label, devex=devex, n_d=unit.n_d)
    return {"shape": [b, m, n], "kind": kind, "mode": mode,
            "n_d": unit.n_d, "solve_segment_takes_it": takes, **plan,
            "dense": {"cluster": dense_plan.cluster,
                      "resident_clusters": sk.clusters_held(dense_plan),
                      "segment_ms_per_iter": (
                          (dense_ms[SEGMENT_PIVOTS] - dense_ms[1])
                          / (SEGMENT_PIVOTS - 1)),
                      "one_pivot_ms": dense_ms[1]},
            "one_iter": {"excluded_tie_lanes": int(tie.sum()),
                         "pivoted_lanes": pivoted, "max_abs_err_bfs": err1,
                         "ms": ms_k, "plain_ms": ms_p, "reps": 10,
                         "bound_ms": b_ms, "bound_by": b_by},
            "segment16": {"lanes_in_lockstep": int(same.sum()),
                          "allowed_split": SPLIT_LANES,
                          "same_bits_as_dense": True,
                          "max_abs_err_bfs": err16, "tol": "1e-4 of scale",
                          "bfs_scale": scale}}


def phase_segment():
    cfg = tuned_config(M)
    out = {"phase": "solve_segment", "shape": [B, M, N + M],
           "config": {"pricing": cfg.pricing, "packed": cfg.packed_select,
                      "stall_limit": cfg.stall_limit}}
    worst_err = 0.0
    one_ms, plans = {}, {}
    for mode in ("primal", "dual"):
        dual = mode == "dual"
        A, c, apen, h, state0 = _segment_instance(dual)
        kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
                  dual=dual, feas_tol=cfg.feas_tol,
                  stall_limit=cfg.stall_limit, packed=cfg.packed_select)

        def fresh():
            return sk.SegmentState(*(t.clone() for t in state0))

        # (a) one iteration from the same state
        sk_k = sk.solve_segment(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
        sk_p = sk.solve_segment_plain(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
        torch.cuda.synchronize()
        tie = _tie_lanes(A, c, state0, dual, cfg)
        keep = ~tie
        same_basis = (sk_k.basis == sk_p.basis).all(dim=1)
        same_status = sk_k.status == sk_p.status
        bad = keep & ~(same_basis & same_status)
        if bad.any():
            fail(f"solve_segment {mode}: one-iteration basis/status differ on "
                 f"{int(bad.sum())} non-tied lanes")
        err1 = (sk_k.bfs[keep] - sk_p.bfs[keep]).abs().max().item()
        worst_err = max(worst_err, err1)
        pivoted = int((sk_k.basis != state0.basis).any(dim=1).sum())
        k16 = sk.solve_segment(A, c, apen, 1 << 20, fresh(), seg_len=16, **kw)
        plans[mode] = _plan_report(
            sk, lambda pl, s, n_piv: sk.launch_with_plan(
                pl, A, c, apen, 1 << 20, s, seg_len=n_piv, **kw),
            fresh, (B, M, N + M), k16, f"solve_segment {mode}")
        del k16

        # one-iteration times (state copies outside the timed region)
        states = [fresh() for _ in range(21)]
        it_k = iter(states)
        ms_k = cuda_ms(lambda: sk.solve_segment(A, c, apen, 1 << 20, next(it_k),
                                                seg_len=1, **kw), 20)
        states = [fresh() for _ in range(21)]
        it_p = iter(states)
        ms_p = cuda_ms(lambda: sk.solve_segment_plain(
            A, c, apen, 1 << 20, next(it_p), seg_len=1, **kw), 20)
        one_ms[mode] = (ms_k, ms_p)

        # (b) a full segment from the same state: every lane terminates
        seg_len = 8 * M
        full = {}
        for name, fn in (("kernel", sk.solve_segment),
                         ("plain", sk.solve_segment_plain)):
            s = fresh()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(A, c, apen, seg_len, s, seg_len=seg_len, **kw)
            t1.record()
            torch.cuda.synchronize()
            full[name] = (s, t0.elapsed_time(t1))
        sk_full, ms_full_k = full["kernel"]
        sp_full, ms_full_p = full["plain"]
        if not torch.equal(sk_full.status, sp_full.status):
            fail(f"solve_segment {mode}: full-segment statuses differ on "
                 f"{int((sk_full.status != sp_full.status).sum())} lanes")
        both = (sk_full.status == st.OPTIMAL) & (sp_full.status == st.OPTIMAL)
        ok_k = _exact_objective(A, c, h, sk_full)
        ok_p = _exact_objective(A, c, h, sp_full)
        rel = ((ok_k - ok_p).abs() / ok_p.abs().clamp_min(1.0))[both]
        rel_max = rel.max().item() if rel.numel() else 0.0
        if not rel_max <= 1e-5:
            fail(f"solve_segment {mode}: full-segment objectives differ by "
                 f"{rel_max:.3e} relative (> 1e-5)")
        out[mode] = {
            **plans[mode],
            "one_iter": {"excluded_tie_lanes": int(tie.sum()),
                         "pivoted_lanes": pivoted,
                         "max_abs_err_bfs": err1,
                         "ms": ms_k, "plain_ms": ms_p, "reps": 20},
            "full_segment": {
                "seg_len": seg_len,
                "status_counts": {st.status_name(k): int(v) for k, v in zip(
                    *torch.unique(sk_full.status, return_counts=True))},
                "optimal_both": int(both.sum()),
                "max_rel_obj_diff": rel_max, "tol_rel": 1e-5,
                "max_iters_kernel": int(sk_full.iters.max()),
                "max_iters_plain": int(sp_full.iters.max()),
                "ms": ms_full_k, "plain_ms": ms_full_p,
            },
        }
    b_ms, b_by = segment_bound_ms(
        B, out["primal"]["one_iter"]["pivoted_lanes"], M, N + M)
    out["bound_ms"], out["bound_by"] = b_ms, b_by
    out["other_shapes"] = [_hold_segment(dual, *shape)
                           for shape in SEGMENT_SHAPES + [BLOCK_SHAPE]
                           for dual in (False, True)]
    out["other_shapes"] += [_hold_segment(False, *shape, pricing=2)
                            for shape in SEGMENT_SHAPES + [BLOCK_SHAPE]]
    out["unit_layout"] = [_hold_unit(kind, dual, pricing)
                          for kind in UNIT_KINDS
                          for dual, pricing in UNIT_MODES]
    # the streaming branch past the largest cluster, beside the block per
    # lane it replaced and the one-iteration bound (A read once, the factor
    # read and written once a lane)
    b, m, n_g = BLOCK_SHAPE
    big = [r for r in out["other_shapes"] if r["shape"] == [b, m, n_g + m]]
    s_bound, s_by = segment_bound_ms(b, b, m, n_g + m)
    out["streaming"] = {
        "shape": [b, m, n_g + m], "plan": big[0]["plan"],
        "resident_clusters": big[0]["resident_clusters"],
        "same_bits_under": big[0]["same_bits_at_clusters"],
        "segment_ms_per_iter": {r["mode"]: r["segment"]["ms_per_iter"]
                                for r in big},
        "bound_ms": s_bound, "bound_by": s_by,
        "replaced_block_ms_per_iter": REPLACED_SEGMENT_BLOCK_MS}
    emit(out)
    return {"max_abs_err": worst_err, "ms": one_ms["primal"][0],
            "plain_ms": one_ms["primal"][1], "bound_ms": b_ms,
            "bound_by": b_by, "streaming_shapes": big,
            "unit_layout": out["unit_layout"], **_plan_summary(
                [(B, M, N + M, "primal", plans["primal"]),
                 (B, M, N + M, "dual", plans["dual"])]
                + [(*r["shape"], r["mode"], r) for r in out["other_shapes"]])}


def _plan_summary(reports):
    """The kernels line's summary of plan reports: each shape and mode's
    plan, resident clusters, in-segment time an iteration and launch
    bound."""
    return {"plans": [
        {"shape": [b, m, n], "mode": mode, "cluster": r["plan"]["cluster"],
         "smem_bytes": r["plan"]["smem_bytes"],
         "resident_clusters": r["resident_clusters"],
         "segment_ms_per_iter": r["segment"]["ms_per_iter"],
         "launch_bound_ms_per_iter": r["segment"]["launch_bound_ms_per_iter"],
         "launch_bound_by": r["segment"]["launch_bound_by"]}
        for b, m, n, mode, r in reports]}


def _lockstep_lanes(k, p, names):
    """bool[B]: lanes on which every named field of the two states is
    equal."""
    same = torch.ones(k.iters.shape[0], dtype=torch.bool, device=DEVICE)
    for name in names:
        a, b = getattr(k, name), getattr(p, name)
        same &= (a == b).reshape(a.shape[0], -1).all(dim=1)
    return same


def phase_segment_devex():
    """Phase 3, devex: kernel 1 with pricing = 2 against its plain version
    at [1024, 256, 512] (one iteration from the slack basis, where every
    sum has one nonzero term, so bit for bit; then a 16-pivot segment, where
    summation order may flip a near tie on a few lanes), and a full
    two-phase run with devex pricing."""
    cfg = tuned_config(M, pricing="devex")
    A, c, apen, h, state0 = _segment_instance(False)
    kw = dict(pricing=2, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              feas_tol=cfg.feas_tol, stall_limit=cfg.stall_limit,
              packed=cfg.packed_select)

    def fresh():
        return sk.SegmentState(*(t.clone() for t in state0))

    ints = ("basis", "status", "iters", "pen", "cB")
    k1 = sk.solve_segment(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
    p1 = sk.solve_segment_plain(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
    torch.cuda.synchronize()
    same1 = _lockstep_lanes(k1, p1, ints)
    if not same1.all():
        fail(f"solve_segment devex: one iteration differs on "
             f"{int((~same1).sum())} lanes")
    err_gamma = ((k1.gamma - p1.gamma).abs()
                 / p1.gamma.abs().clamp_min(1.0)).max().item()
    if not err_gamma <= 1e-4:
        fail(f"solve_segment devex: weights differ by {err_gamma:.3e} "
             "relative after one iteration (> 1e-4)")
    if not (k1.gamma != 1.0).any():
        fail("solve_segment devex: no weight moved off 1")
    states = iter([fresh() for _ in range(20)])
    ms_k = cuda_ms(lambda: sk.solve_segment(A, c, apen, 1 << 20, next(states),
                                            seg_len=1, **kw), 20)
    states = iter([fresh() for _ in range(20)])
    ms_p = cuda_ms(lambda: sk.solve_segment_plain(
        A, c, apen, 1 << 20, next(states), seg_len=1, **kw), 20)
    del states

    k16 = sk.solve_segment(A, c, apen, 1 << 20, fresh(), seg_len=16, **kw)
    p16 = sk.solve_segment_plain(A, c, apen, 1 << 20, fresh(), seg_len=16,
                                 **kw)
    torch.cuda.synchronize()
    same16 = _lockstep_lanes(k16, p16, ints)
    split = int((~same16).sum())
    if split > SPLIT_LANES:
        fail(f"solve_segment devex: the 16-pivot segment left lockstep on "
             f"{split} lanes (> {SPLIT_LANES})")
    if not torch.equal(k16.iters, p16.iters):
        fail("solve_segment devex: 16-pivot iteration counts differ")
    err16 = ((k16.gamma - p16.gamma).abs()
             / p16.gamma.abs().clamp_min(1.0))[same16].max().item()
    if not err16 <= 1e-3:
        fail(f"solve_segment devex: weights differ by {err16:.3e} relative "
             "after 16 pivots (> 1e-3)")
    plan = _plan_report(sk, lambda pl, s, n_piv: sk.launch_with_plan(
        pl, A, c, apen, 1 << 20, s, seg_len=n_piv, **kw), fresh,
        (B, M, N + M), k16, "solve_segment devex")
    del A, c, apen, state0, k1, p1, k16, p16

    # the full two-phase run on devex
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cc, G, hh = device_inequality_lps(gen, B, M, N, DEVICE)
    cs, As, bs = device_standard_form_batch(cc, G, hh)
    lt.solve_batch_two_phase(cs, As, bs, 4000, 4000, cfg)  # warm-up
    sk.launches = sk.launches_unit = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res = lt.solve_batch_two_phase(cs, As, bs, 4000, 4000, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, launches_unit = sk.launches, sk.launches_unit
    gap = highs_gap(res.cost, cc, 4, A_ub=G, b_ub=hh)
    out = {"phase": "solve_segment_devex", "shape": [B, M, N + M], **plan,
           "one_iter": {"lanes_equal": int(same1.sum()),
                        "max_rel_err_gamma": err_gamma, "ms": ms_k,
                        "plain_ms": ms_p, "reps": 20},
           "segment16": {"lanes_in_lockstep": int(same16.sum()),
                         "allowed_split": SPLIT_LANES,
                         "max_rel_err_gamma": err16},
           "two_phase": {"lanes": B, "m": M, "n": N,
                         "lane_status": status_counts(res.status),
                         "wall_s": wall, "launches": launches,
                         "launches_unit": launches_unit,
                         "iters_total": int(res.iters.sum()),
                         "highs_lanes": 4, "max_rel_gap_vs_highs": gap}}
    emit(out)
    if int((res.status == st.OPTIMAL).sum()) != B:
        fail(f"devex two-phase: {out['two_phase']['lane_status']}")
    if not gap <= 1e-5:
        fail(f"devex two-phase: HiGHS gap {gap:.3e} > 1e-5")
    if launches <= 0:
        fail("devex two-phase: kernel solve_segment was never launched")
    if launches_unit <= 0:
        fail("devex two-phase: the [1024, 256, 768] Phase-I lanes never took "
             "the unit layout")
    return {"solve_segment": launches, "solve_segment_unit": launches_unit}


def phase_main_path():
    """Phase 4: solve_batch_exact at B = 1024, m = n = 256."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, B, M, N, DEVICE)

    t0 = time.time()
    lt.solve_batch_exact(c, G, h)  # warm-up
    torch.cuda.synchronize()
    warm = time.time() - t0

    sk.launches = sk.launches_unit = 0
    ck.launches = ddk.launches = luk.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res, info = lt.solve_batch_exact(c, G, h)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"solve_segment": sk.launches,
                "solve_segment_unit": sk.launches_unit,
                "panel_cholinv": ck.launches, "dd_residual": ddk.launches,
                "batched_lu": luk.launches}
    MAIN_PATH["basis"] = res.basis

    walls = [wall]
    for _ in range(REPEATS - 1):
        t0 = time.time()
        lt.solve_batch_exact(c, G, h)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall_med = float(np.median(walls))

    t1 = time.time()
    cert = lt.certify_vertex_batch(c, G, h, res.basis)
    summ = lt.certificate_summary(cert)
    torch.cuda.synchronize()
    cert_wall = time.time() - t1
    okc = cert["certified"]
    worst = None
    if okc.any():
        worst = max(cert["primal_residual"][okc].max().item(),
                    cert["gap"][okc].max().item())

    status = res.status.cpu().numpy()
    counts = {st.status_name(k): int(v)
              for k, v in zip(*np.unique(status, return_counts=True))}
    if res.x.shape != (B, N) or not torch.isfinite(res.cost).all():
        fail("main path: result has the wrong shape or non-finite costs")

    from scipy.optimize import linprog

    k = 16
    cs, Gs, hs = (t[:k].double().cpu().numpy() for t in (c, G, h))
    cost = res.cost[:k].double().cpu().numpy()
    gaps, highs_s = [], []
    for i in range(k):
        t2 = time.time()
        ref = linprog(cs[i], A_ub=Gs[i], b_ub=hs[i], bounds=(0, None),
                      method="highs")
        highs_s.append(time.time() - t2)
        if ref.status != 0:
            fail(f"main path: HiGHS did not solve lane {i} ({ref.message})")
        gaps.append(abs(cost[i] - ref.fun) / max(1.0, abs(ref.fun)))
    max_gap = float(max(gaps))

    out = {
        "phase": "main_path", "lanes": B, "m": M, "n": N, "seed": SEED,
        "lane_status": counts, "crossed": info["crossed"],
        "fallback": info["fallback"], "certified": summ["certified"],
        "certificate": summ, "max_kkt_residual": worst,
        "wall_s": wall_med, "walls_s": walls, "warmup_wall_s": warm,
        "lps_per_sec": B / wall_med,
        "cert_wall_s": cert_wall, "launches": launches,
        "highs_lanes": k, "max_rel_gap_vs_highs": max_gap,
        "highs_median_s": float(np.median(highs_s)),
        "iters_total": int(res.iters.sum()),
    }
    emit(out)
    n_opt = int((status == st.OPTIMAL).sum())
    if n_opt != B:
        fail(f"main path: {n_opt}/{B} lanes OPTIMAL")
    if summ["certified"] < 1020:
        fail(f"main path: {summ['certified']}/{B} certified (< 1020)")
    if not max_gap <= 1e-5:
        fail(f"main path: HiGHS gap {max_gap:.3e} > 1e-5")
    # the unit layout is counted, not required: the crossover's [G | I]
    # saves no CTA by it, so it keeps the dense launch
    for name, cnt in launches.items():
        if cnt <= 0 and name != "solve_segment_unit":
            fail(f"main path: kernel {name} was never launched")
    return launches


def _hold_stream(label, A, c, apen, h, state0, cfg, dual, seg_len, reps):
    """The cluster kernel against its plain version from one state: one
    iteration in lockstep (the same basis and status on every lane that
    _tie_lanes does not exclude), then a ``seg_len``-pivot segment (the
    same statuses, float64 objectives at the final bases within 1e-5
    relative; the same bits under the other built cluster size).  Returns a report with CUDA-event times of both."""
    kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              dual=dual, feas_tol=cfg.feas_tol, stall_limit=cfg.stall_limit,
              packed=cfg.packed_select, a_resident=False, n_blk=512)

    def fresh():
        return sk.SegmentState(*(t.clone() for t in state0))

    k1 = ssk.solve_segment_stream(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
    p1 = ssk.solve_segment_stream_plain(A, c, apen, 1 << 20, fresh(),
                                        seg_len=1, **kw)
    torch.cuda.synchronize()
    keep = ~_tie_lanes(A, c, state0, dual, cfg)
    same = (k1.basis == p1.basis).all(dim=1) & (k1.status == p1.status)
    if (keep & ~same).any():
        fail(f"solve_segment_stream {label}: one-iteration basis/status "
             f"differ on {int((keep & ~same).sum())} non-tied lanes")
    err1 = (k1.bfs[keep] - p1.bfs[keep]).abs().max().item()
    pivoted = int((k1.basis != state0.basis).any(dim=1).sum())
    plan = ssk.last_plan
    b_ms, b_by = segment_bound_ms(A.shape[0], pivoted, A.shape[1], A.shape[2])
    del k1, p1

    # one-iteration times (state copies outside the timed region)
    times = {}
    for name, fn in (("kernel", ssk.solve_segment_stream),
                     ("plain", ssk.solve_segment_stream_plain)):
        states = iter([fresh() for _ in range(reps)])
        times[name] = cuda_ms(lambda: fn(A, c, apen, 1 << 20, next(states),
                                         seg_len=1, **kw), reps)
        del states

    full = {}
    for name, fn in (("kernel", ssk.solve_segment_stream),
                     ("plain", ssk.solve_segment_stream_plain)):
        s = fresh()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(A, c, apen, 1 << 20, s, seg_len=seg_len, **kw)
        t1.record()
        torch.cuda.synchronize()
        full[name] = (s, t0.elapsed_time(t1))
    sk_full, sp_full = full["kernel"][0], full["plain"][0]
    if not torch.equal(sk_full.status, sp_full.status):
        fail(f"solve_segment_stream {label}: {seg_len}-pivot statuses differ "
             f"on {int((sk_full.status != sp_full.status).sum())} lanes")
    ok_k = _exact_objective(A, c, h, sk_full)
    ok_p = _exact_objective(A, c, h, sp_full)
    rel = ((ok_k - ok_p).abs() / ok_p.abs().clamp_min(1.0)).max().item()
    split = int((sk_full.basis != sp_full.basis).any(dim=1).sum())
    if not rel <= 1e-5:
        fail(f"solve_segment_stream {label}: {seg_len}-pivot objectives "
             f"differ by {rel:.3e} relative (> 1e-5); bases split on {split} "
             "lanes")
    # the other built cluster size gives the same bits: every sum runs over
    # the lane's eight row bands in one order, whatever the plan
    launch_kw = {k: v for k, v in kw.items() if k not in ("a_resident", "n_blk")}
    others = [p for p in ssk.stream_plans(*A.shape, dual=dual)
              if p.cluster != plan.cluster and p.aligned == plan.aligned]
    for other in others:
        s = fresh()
        ssk.launch_with_plan(other, A, c, apen, 1 << 20, s, seg_len=seg_len,
                             **launch_kw)
        torch.cuda.synchronize()
        for name, a, b in zip(s._fields, s, sk_full):
            if not torch.equal(a, b):
                fail(f"solve_segment_stream {label}: {name} after {seg_len} "
                     f"pivots differs between {other.cluster} and "
                     f"{plan.cluster} blocks a lane")
        del s
    return {
        "shape": list(A.shape), "mode": "dual" if dual else "primal",
        "plan": plan._asdict(),
        "same_bits_at_clusters": [p.cluster for p in others],
        "resident_clusters": _build.library()
        .lp_solve_segment_stream_max_clusters(plan.cluster, int(plan.aligned),
                                              plan.smem_bytes),
        "bound_ms": b_ms, "bound_by": b_by,
        "one_iter": {"excluded_tie_lanes": int((~keep).sum()),
                     "pivoted_lanes": pivoted,
                     "max_abs_err_bfs": err1, "ms": times["kernel"],
                     "plain_ms": times["plain"], "reps": reps},
        "segment": {"seg_len": seg_len,
                    "status_counts": {st.status_name(k): int(v) for k, v in
                                      zip(*torch.unique(sk_full.status,
                                                        return_counts=True))},
                    "lanes_with_other_basis": split,
                    "max_rel_obj_diff": rel, "tol_rel": 1e-5,
                    "ms": full["kernel"][1], "plain_ms": full["plain"][1]},
    }


def phase_stream():
    """Phase 5: the cluster kernel at the m = 2048 path's shapes."""
    cfg = tuned_config(XM, refactor_every=128, unroll=2)
    out = {"phase": "solve_segment_stream",
           "config": {"pricing": cfg.pricing, "packed": cfg.packed_select,
                      "stall_limit": cfg.stall_limit}, "runs": []}
    cases = [("crossover primal", False, XB, XM, XM),
             ("crossover dual", True, XB, XM, XM),
             ("two-phase 1024", False, XB, 1024, 2048),
             ("ragged", False, XB, 1000, 1999),
             ("fallback bucket", False, 8, XM, 2 * XM)]
    for label, dual, b, m, n_g in cases:
        A, c, apen, h, state0 = _segment_instance(dual, b, m, n_g, SEED + 3)
        out["runs"].append(_hold_stream(label, A, c, apen, h, state0, cfg,
                                        dual, 64, 5))
        del A, c, apen, h, state0
        torch.cuda.empty_cache()
    emit(out)
    first = out["runs"][0]
    return {"max_abs_err": max(r["one_iter"]["max_abs_err_bfs"]
                               for r in out["runs"]),
            "ms": first["one_iter"]["ms"],
            "plain_ms": first["one_iter"]["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"]}


@contextlib.contextmanager
def _stage_spans(targets):
    """While the block runs, every call of ``getattr(module, attr)`` for
    ``(name, module, attr, label_fn)`` in ``targets`` is bracketed by two
    CUDA events (no synchronisation, so the run is not perturbed).  Yields
    the list of ``(name, label, start, end)``; ``label_fn(*args, **kw)`` is
    called after the wrapped call.  Read the events after a synchronize."""
    spans, saved = [], []

    def wrap(name, fn, label_fn):
        def timed(*args, **kw):
            t_a = torch.cuda.Event(enable_timing=True)
            t_b = torch.cuda.Event(enable_timing=True)
            t_a.record()
            out = fn(*args, **kw)
            t_b.record()
            label = label_fn(*args, **kw) if label_fn else None
            spans.append((name, label, t_a, t_b))
            return out
        return timed

    for name, module, attr, label_fn in targets:
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, wrap(name, getattr(module, attr), label_fn))
    try:
        yield spans
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def phase_exact_m2048():
    """Phase 6: solve_batch_exact at B = 64, m = n = 2048."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, XB, XM, XM, DEVICE)

    t0 = time.time()
    lt.solve_batch_exact(c, G, h)  # warm-up
    torch.cuda.synchronize()
    warm = time.time() - t0

    # CUDA events around the stages of the timed run (nested stages overlap:
    # the fallback holds streaming launches and refactorizations, the
    # crossover holds the polish) and around every launch of the streaming
    # kernel, by batch size: the fallback's bucket is 8
    import linprog_tpu_torch.batch as lb
    import linprog_tpu_torch.crossover as lx
    import linprog_tpu_torch.engine_batched as le
    import linprog_tpu_torch.ipm as li
    import linprog_tpu_torch.refine as lr

    def stream_label(A, *args, **kw):
        return (f"B={A.shape[0]} {tuple(A.shape[1:])} "
                f"cluster={ssk.last_plan.cluster}")

    sk.launches = ck.launches = ssk.launches = ddk.launches = 0
    luk.launches = 0
    with _stage_spans([
            ("ipm", li, "ipm_canonical_state", None),
            ("crossover", lx, "crossover_batch_canonical", None),
            ("polish", lr, "polish_batch", None),
            ("fallback_two_phase", lb, "solve_batch_two_phase", None),
            ("refactorize", le, "refresh_running_lanes", None),
            ("stream_kernel", le, "solve_segment_stream", stream_label),
    ]) as spans:
        torch.cuda.synchronize()
        t0 = time.time()
        res, info = lt.solve_batch_exact(c, G, h)
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = {"solve_segment_stream": ssk.launches,
                "panel_cholinv": ck.launches, "solve_segment": sk.launches,
                "dd_residual": ddk.launches, "batched_lu": luk.launches}
    stage_s, stream_s = {}, {}
    for name, label, t_a, t_b in spans:
        sec = t_a.elapsed_time(t_b) / 1e3
        entry = stage_s.setdefault(name, {"calls": 0, "seconds": 0.0})
        entry["calls"] += 1
        entry["seconds"] += sec
        if label is not None:
            entry = stream_s.setdefault(label, {"launches": 0, "seconds": 0.0})
            entry["launches"] += 1
            entry["seconds"] += sec

    t1 = time.time()
    cert = lt.certify_vertex_batch(c, G, h, res.basis)
    summ = lt.certificate_summary(cert)
    torch.cuda.synchronize()
    cert_wall = time.time() - t1

    uncertified = [
        {"lane": i, **{k: float(cert[k][i]) for k in
                       ("primal_residual", "min_xB", "min_reduced_cost", "gap")}}
        for i in torch.nonzero(~cert["certified"]).flatten().tolist()
    ]

    status = res.status.cpu().numpy()
    counts = {st.status_name(k): int(v)
              for k, v in zip(*np.unique(status, return_counts=True))}
    out = {
        "phase": "exact_m2048", "lanes": XB, "m": XM, "n": XM, "seed": SEED,
        "lane_status": counts, "crossed": info["crossed"],
        "retry_crossed": info["retry_crossed"], "fallback": info["fallback"],
        "certified": summ["certified"], "certificate": summ,
        "uncertified": uncertified,
        "wall_s": wall, "warmup_wall_s": warm,
        "lps_per_sec": XB / wall, "cert_wall_s": cert_wall,
        "launches": launches, "iters_total": int(res.iters.sum()),
        "stages_s": stage_s,
        "stream_kernel_s": stage_s.get("stream_kernel", {}).get("seconds"),
        "stream_kernel_by_batch": stream_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(out)
    if res.x.shape != (XB, XM) or not torch.isfinite(res.cost).all():
        fail("m = 2048 path: result has the wrong shape or non-finite costs")
    n_opt = int((status == st.OPTIMAL).sum())
    if n_opt != XB:
        fail(f"m = 2048 path: {n_opt}/{XB} lanes OPTIMAL")
    if summ["certified"] < XB - 1:
        fail(f"m = 2048 path: {summ['certified']}/{XB} certified (< {XB - 1})")
    for name in ("solve_segment_stream", "panel_cholinv"):
        if launches[name] <= 0:
            fail(f"m = 2048 path: kernel {name} was never launched")
    if launches["batched_lu"] != 0:
        fail("m = 2048 path: the batched LU kernel ran past its range")
    return launches


def _bounded_start(seed=SEED, b=B, m=M, n_g=N):
    """device_bounded_lps at [b, m, n_g + m] (default [1024, 256, 512])
    with its all-slack start: the problem, the (basis, var_state) a user
    passes, and the same start in the kernel's layout."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    c, A, rhs, lb, ub = device_bounded_lps(gen, b, m, n_g, DEVICE)
    ntot = n_g + m
    basis = torch.arange(n_g, ntot, dtype=torch.int32,
                         device=DEVICE).expand(b, m).contiguous()
    vs = torch.zeros((b, ntot), dtype=torch.int8, device=DEVICE)
    vs[:, n_g:] = bk.BASIC
    zeros = torch.zeros((b, m), device=DEVICE)
    state = bk.BoundedSegmentState(
        invBT=torch.eye(m, device=DEVICE).expand(b, m, m).contiguous(),
        bfs=rhs.clone(), cB=zeros.clone(), basis=basis.clone(),
        vstate=vs.clone(), lbB=zeros.clone(),
        ubB=torch.full((b, m), float("inf"), device=DEVICE),
        iters=torch.zeros(b, dtype=torch.int32, device=DEVICE),
        status=torch.zeros(b, dtype=torch.int32, device=DEVICE))
    prob = tuple(t.contiguous() for t in (c, A, rhs, lb, ub))
    return prob, basis, vs, state


def _bounded_objective(prob, s):
    """float64 objective at a kernel state's basis and bound assignment
    (exact solve of B x_B = b - A x_N)."""
    c, A, b, lb, ub = prob
    x_n = torch.where(s.vstate == bk.AT_UB, ub, torch.zeros_like(ub))
    rhs = b - torch.einsum("bmn,bn->bm", A, x_n)
    xB = solve_or_nan(basis_matrix(A, s.basis), rhs)
    x = x_n.scatter(1, s.basis.long(), xB)
    return (c.double() * x.double()).sum(dim=1)


def _bound_violation(prob, x):
    """How far ``x[B, n]`` lies outside ``[lb, ub]``: the largest excess, and
    the largest excess as a share of its lane's scale ``max(1, max|b|)``."""
    _, _, b, lb, ub = prob
    x = x.double()
    scale = b.abs().max(dim=1).values.double().clamp_min(1.0)
    out_of = torch.maximum(lb.double() - x, x - ub.double()).clamp_min(0.0)
    return (out_of.max().item(),
            (out_of.max(dim=1).values / scale).max().item())


def _bounded_drift(prob, s):
    """A kernel state's f32 basic values against the float64 solve of
    ``B x_B = b - A x_N`` at the same basis and bound assignment: the
    largest difference as a share of the lane's scale (the drift of the
    incremental updates), and how far the float64 vertex leaves its bounds
    (:func:`_bound_violation`).  Lanes with a singular basis are left out."""
    _, A, b, _, ub = prob
    x_n = torch.where(s.vstate == bk.AT_UB, ub, torch.zeros_like(ub)).double()
    rhs = b.double() - torch.einsum("bmn,bn->bm", A.double(), x_n)
    xB, info = torch.linalg.solve_ex(basis_matrix(A, s.basis).double(), rhs)
    ok = (info == 0) & torch.isfinite(xB).all(dim=1)
    scale = b.abs().max(dim=1).values.double().clamp_min(1.0)
    drift = ((s.bfs.double() - xB).abs().max(dim=1).values / scale)[ok]
    x = x_n.scatter(1, s.basis.long(), xB)
    sub = tuple(t[ok] for t in prob)
    viol_abs, viol_rel = _bound_violation(sub, x[ok])
    return {"max_rel_drift_bfs": drift.max().item(),
            "max_bound_violation": viol_abs,
            "max_rel_bound_violation": viol_rel,
            "lanes": int(ok.sum())}


def _hold_bounded(b, m, n_g, packed, block=False):
    """Kernel 4 against its plain version at [b, m, n_g + m] from the
    all-slack start: 16 iterations in lockstep (basis, variable states,
    status, iterations, c_B and the basic bounds equal on all but
    max(2, 16 of 1024) lanes; bfs within 1e-4 of scale there) on the
    cluster-resident branch (``block``: on the streaming branch, which
    replaced the block per lane past the largest cluster), its plan report,
    and one mid-solve iteration's time against the plain version's, beside
    its bound (the lanes that pivot in it)."""
    cfg = tuned_config(m)
    prob, _, _, state0 = _bounded_start(SEED + 7 + m, b, m, n_g)
    c, A, _, lb, ub = prob
    kw = dict(opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol, packed=packed)
    shape = [b, m, n_g + m]
    label = f"solve_bounded_segment {'packed' if packed else 'unpacked'}"

    def fresh(s=state0):
        return bk.BoundedSegmentState(*(t.clone() for t in s))

    k16 = bk.solve_bounded_segment(A, c, lb, ub, 1 << 20, fresh(),
                                   seg_len=16, **kw)
    p16 = bk.solve_bounded_segment_plain(A, c, lb, ub, 1 << 20, fresh(),
                                         seg_len=16, **kw)
    torch.cuda.synchronize()
    if isinstance(bk.last_plan, StreamingPlan) != block:
        fail(f"{label} {shape}: took the {_branch(bk.last_plan)} branch")
    same = _lockstep_lanes(k16, p16, ("basis", "vstate", "status", "iters",
                                      "cB", "lbB", "ubB"))
    split, allowed = int((~same).sum()), max(2, b * SPLIT_LANES // B)
    if split > allowed:
        fail(f"{label} {shape}: the 16-iteration segment left lockstep on "
             f"{split} lanes (> {allowed})")
    scale = max(p16.bfs[same].abs().max().item(), 1.0)
    err = (k16.bfs[same] - p16.bfs[same]).abs().max().item()
    if not err <= 1e-4 * scale:
        fail(f"{label} {shape}: bfs differs by {err:.3e} after 16 "
             f"iterations (> 1e-4 of {scale:.3e})")
    plan = _plan_report(bk, lambda pl, s, n_piv: bk.launch_with_plan(
        pl, A, c, lb, ub, 1 << 20, s, seg_len=n_piv, **kw), fresh,
        tuple(shape), k16, label)
    times = {}
    for name, fn in (("kernel", bk.solve_bounded_segment),
                     ("plain", bk.solve_bounded_segment_plain)):
        states = iter([fresh(k16) for _ in range(10)])
        times[name] = cuda_ms(lambda: fn(A, c, lb, ub, 1 << 20, next(states),
                                         seg_len=1, **kw), 10)
    k17 = bk.solve_bounded_segment(A, c, lb, ub, 1 << 20, fresh(k16),
                                   seg_len=1, **kw)
    pivoting = int((k17.basis != k16.basis).any(dim=1).sum())
    b_ms, b_by = segment_bound_ms(b, pivoting, m, n_g + m)
    return {"shape": shape, "mode": "packed" if packed else "unpacked",
            **plan,
            "segment16": {"lanes_in_lockstep": int(same.sum()),
                          "allowed_split": allowed, "max_abs_err_bfs": err,
                          "bfs_scale": scale, "tol": "1e-4 of scale"},
            "one_iter_mid_solve": {"ms": times["kernel"],
                                   "plain_ms": times["plain"], "reps": 10,
                                   "pivoting_lanes": pivoting,
                                   "bound_ms": b_ms, "bound_by": b_by}}


def phase_bounded_segment():
    """Phase 7: kernel 4 against its plain version at [1024, 256, 512], and
    at the segment kernels' other shapes in both selection modes."""
    cfg = tuned_config(M)
    prob, _, _, state0 = _bounded_start()
    c, A, b, lb, ub = prob
    kw = dict(opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              packed=cfg.packed_select)
    names = ("basis", "vstate", "status", "iters", "cB", "lbB", "ubB")

    def fresh(s=state0):
        return bk.BoundedSegmentState(*(t.clone() for t in s))

    def both(seg_len, s=state0):
        k = bk.solve_bounded_segment(A, c, lb, ub, 1 << 20, fresh(s),
                                     seg_len=seg_len, **kw)
        p = bk.solve_bounded_segment_plain(A, c, lb, ub, 1 << 20, fresh(s),
                                           seg_len=seg_len, **kw)
        torch.cuda.synchronize()
        return k, p

    # (a) one iteration from the all-slack start: the duals are zero and
    # the factor is the identity, so every sum has one nonzero term and the
    # kernel must equal the plain version on every lane, bit for bit
    k1, p1 = both(1)
    same1 = _lockstep_lanes(k1, p1, names + ("bfs",))
    if not same1.all():
        fail(f"solve_bounded_segment: one iteration differs on "
             f"{int((~same1).sum())} lanes")
    err1 = (k1.bfs - p1.bfs).abs().max().item()
    flips1 = int(((k1.vstate != state0.vstate).any(dim=1)
                  & (k1.basis == state0.basis).all(dim=1)).sum())

    # (b) a 16-iteration segment: summation order differs, so a near tie
    # may flip on a few of the 1024 lanes
    k16, p16 = both(16)
    same16 = _lockstep_lanes(k16, p16, names)
    split = int((~same16).sum())
    if split > SPLIT_LANES:
        fail(f"solve_bounded_segment: the 16-iteration segment left "
             f"lockstep on {split} lanes (> {SPLIT_LANES})")
    if not (torch.equal(k16.iters, p16.iters)
            and torch.equal(k16.status, p16.status)):
        fail("solve_bounded_segment: 16-iteration counts or statuses differ")
    err16 = (k16.bfs - p16.bfs).abs()[same16].max().item()
    scale16 = p16.bfs.abs().max().item()
    if not err16 <= 1e-4 * max(scale16, 1.0):
        fail(f"solve_bounded_segment: bfs differs by {err16:.3e} after 16 "
             "iterations (> 1e-4 of scale)")
    plan = _plan_report(bk, lambda pl, s, n_piv: bk.launch_with_plan(
        pl, A, c, lb, ub, 1 << 20, s, seg_len=n_piv, **kw), fresh,
        (B, M, N + M), k16, "solve_bounded_segment")
    if plan["branch"] != "cluster":
        fail("solve_bounded_segment: the bounded leg's shape took the "
             f"{plan['branch']} branch")

    # one-iteration times from the mid-solve state (state copies outside
    # the timed region); the bound counts what this iteration moves
    k17, _ = both(1, k16)
    pivoting = int((k17.basis != k16.basis).any(dim=1).sum())
    flipping = int(((k17.vstate != k16.vstate).any(dim=1)
                    & (k17.basis == k16.basis).all(dim=1)).sum())
    states = iter([fresh(k16) for _ in range(20)])
    ms_k = cuda_ms(lambda: bk.solve_bounded_segment(
        A, c, lb, ub, 1 << 20, next(states), seg_len=1, **kw), 20)
    states = iter([fresh(k16) for _ in range(20)])
    ms_p = cuda_ms(lambda: bk.solve_bounded_segment_plain(
        A, c, lb, ub, 1 << 20, next(states), seg_len=1, **kw), 20)
    del states, k1, p1, p16, k17

    # (c) a full run in one segment: every lane terminates
    full = {}
    for name, fn in (("kernel", bk.solve_bounded_segment),
                     ("plain", bk.solve_bounded_segment_plain)):
        sfull = fresh()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(A, c, lb, ub, BOUNDED_MAXITERS, sfull, seg_len=BOUNDED_MAXITERS,
           **kw)
        t1.record()
        torch.cuda.synchronize()
        full[name] = (sfull, t0.elapsed_time(t1))
    kf, pf = full["kernel"][0], full["plain"][0]
    if not torch.equal(kf.status, pf.status):
        fail(f"solve_bounded_segment: full-run statuses differ on "
             f"{int((kf.status != pf.status).sum())} lanes")
    if not (kf.status == st.OPTIMAL).all():
        fail(f"solve_bounded_segment: full run {status_counts(kf.status)}")
    ok, op = _bounded_objective(prob, kf), _bounded_objective(prob, pf)
    rel = ((ok - op).abs() / op.abs().clamp_min(1.0)).max().item()
    if not rel <= 1e-5:
        fail(f"solve_bounded_segment: full-run objectives differ by "
             f"{rel:.3e} relative (> 1e-5)")
    # the unrefactored run's drift, kernel and plain version alike: the f32
    # basic values against the float64 vertex of the terminal basis, and how
    # far that vertex leaves its bounds
    drift_k, drift_p = _bounded_drift(prob, kf), _bounded_drift(prob, pf)
    b_ms, b_by = segment_bound_ms(B, pivoting, M, N + M)
    out = {"phase": "solve_bounded_segment", "shape": [B, M, N + M],
           "config": {"packed": cfg.packed_select}, **plan,
           "one_iter_from_start": {"lanes_equal": int(same1.sum()),
                                   "bound_flips": flips1,
                                   "max_abs_err_bfs": err1},
           "segment16": {"lanes_in_lockstep": int(same16.sum()),
                         "allowed_split": SPLIT_LANES,
                         "max_abs_err_bfs": err16, "scale_bfs": scale16,
                         "tol": "1e-4 of scale"},
           "one_iter_mid_solve": {"pivoting_lanes": pivoting,
                                  "flipping_lanes": flipping, "ms": ms_k,
                                  "plain_ms": ms_p, "reps": 20,
                                  "bound_ms": b_ms, "bound_by": b_by},
           "full_run": {"status_counts": status_counts(kf.status),
                        "max_rel_obj_diff": rel, "tol_rel": 1e-5,
                        "max_iters_kernel": int(kf.iters.max()),
                        "max_iters_plain": int(pf.iters.max()),
                        "ms": full["kernel"][1], "plain_ms": full["plain"][1],
                        "unrefactored_drift": {"kernel": drift_k,
                                               "plain": drift_p}}}
    out["other_shapes"] = [_hold_bounded(b, m, n_g, packed)
                           for b, m, n_g in SEGMENT_SHAPES
                           for packed in (True, False)]
    out["other_shapes"].append(_hold_bounded(B, M, N, False))
    emit(out)
    return {"max_abs_err": max(err1, err16), "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": b_ms, "bound_by": b_by,
            **_plan_summary([(B, M, N + M, "packed", plan)]
                            + [(*r["shape"], r["mode"], r)
                               for r in out["other_shapes"]])}


def phase_bounded_path():
    """Phase 8: solve_batch_bounded at B = 1024, m = n = 256."""
    cfg = tuned_config(M, pricing="dantzig", polish_pivots=8,
                       refactor_every=2048)
    prob, basis, vs, _ = _bounded_start()
    c, A, b, lb, ub = prob

    def solve():
        return lt.solve_batch_bounded(c, A, b, lb, ub, basis, vs,
                                      BOUNDED_MAXITERS, cfg)

    t0 = time.time()
    solve()  # warm-up
    torch.cuda.synchronize()
    warm = time.time() - t0

    bk.launches = ddk.launches = luk.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res = solve()
    torch.cuda.synchronize()
    walls = [time.time() - t0]
    launches = bk.launches
    DD_PATHS["bounded_m256"] = ddk.launches
    LU_PATHS["bounded_m256"] = luk.launches
    for _ in range(BOUNDED_REPEATS - 1):
        t0 = time.time()
        solve()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall_med = float(np.median(walls))

    bounds = torch.stack([lb, ub], dim=2)
    gap = highs_gap(res.cost, c, 4, A_eq=A, b_eq=b, bounds=bounds)
    # feasibility of the returned vertex against the lane's scale
    # max(1, max|b|).  At the bench leg's refactor_every = 2048 a lane runs
    # its ~3000 iterations in two segments, the engine's f32 basic values
    # drift, and the ratio test on drifted values may end on a basis whose
    # exact vertex sits slightly outside a bound (phase 7 reads the same
    # drift from the kernel's plain version: ~1e-3 of scale, so the limit
    # of 1e-4 is a tenth of the drift; a seat of the entering value planted
    # 1e-3 off in the kernel reads 3.0 here).  One more solve with
    # refactor_every = 256 shows the cause: with the drift bounded the
    # vertex is held to 5e-6 of scale.
    x = res.x.double()
    scale = b.abs().max(dim=1).values.double().clamp_min(1.0)
    viol_abs, viol_rel = _bound_violation(prob, res.x)
    tight = lt.solve_batch_bounded(c, A, b, lb, ub, basis, vs,
                                   BOUNDED_MAXITERS,
                                   cfg.replace(refactor_every=256))
    tight_abs, tight_rel = _bound_violation(prob, tight.x)
    tight_opt = int((tight.status == st.OPTIMAL).sum())
    tight_cost = ((tight.cost - res.cost).abs()
                  / res.cost.abs().clamp_min(1.0)).max().item()
    resid = (torch.einsum("bmn,bn->bm", A.double(), x) - b.double()).abs()
    resid_rel = (resid.max(dim=1).values / scale).max().item()
    out = {"phase": "bounded_m256", "lanes": B, "m": M, "n": N, "seed": SEED,
           "config": {"pricing": cfg.pricing, "packed": cfg.packed_select,
                      "refactor_every": cfg.refactor_every,
                      "polish_pivots": cfg.polish_pivots,
                      "maxiters": BOUNDED_MAXITERS},
           "lane_status": status_counts(res.status),
           "wall_s": wall_med, "walls_s": walls, "warmup_wall_s": warm,
           "lps_per_sec": B / wall_med, "launches": launches,
           "dd_launches": DD_PATHS["bounded_m256"],
           "lu_launches": LU_PATHS["bounded_m256"],
           "iters_total": int(res.iters.sum()),
           "iters_max": int(res.iters.max()),
           "highs_lanes": 4, "max_rel_gap_vs_highs": gap,
           "max_bound_violation": viol_abs,
           "max_rel_bound_violation": viol_rel, "tol_rel_bound": 1e-4,
           "refactor_every_256": {"optimal": tight_opt,
                                  "max_bound_violation": tight_abs,
                                  "max_rel_bound_violation": tight_rel,
                                  "tol_rel_bound": 5e-6,
                                  "max_rel_cost_diff": tight_cost},
           "max_rel_residual": resid_rel, "tol_residual": 1e-4}
    emit(out)
    if res.x.shape != (B, N + M) or not torch.isfinite(res.cost).all():
        fail("bounded path: result has the wrong shape or non-finite costs")
    n_opt = int((res.status == st.OPTIMAL).sum())
    if n_opt != B:
        fail(f"bounded path: {n_opt}/{B} lanes OPTIMAL")
    if not gap <= 1e-5:
        fail(f"bounded path: HiGHS gap {gap:.3e} > 1e-5")
    if not viol_rel <= 1e-4:
        fail(f"bounded path: x leaves its bounds by {viol_rel:.3e} of scale "
             "(> 1e-4)")
    if tight_opt != B or not tight_rel <= 5e-6:
        fail(f"bounded path, refactor_every=256: {tight_opt}/{B} OPTIMAL, x "
             f"leaves its bounds by {tight_rel:.3e} of scale (> 5e-6)")
    if not tight_cost <= 1e-5:
        fail(f"bounded path: the refactor_every=256 run's costs differ by "
             f"{tight_cost:.3e} relative (> 1e-5)")
    if not resid_rel <= 1e-4:
        fail(f"bounded path: |Ax - b| = {resid_rel:.3e} of scale (> 1e-4)")
    if launches <= 0:
        fail("bounded path: kernel solve_bounded_segment was never launched")
    if DD_PATHS["bounded_m256"] <= 0:
        fail("bounded path: kernel dd_residual was never launched")
    if LU_PATHS["bounded_m256"] <= 0:
        fail("bounded path: kernel batched_lu was never launched")
    return launches


def _near_tied(values, chosen_a, chosen_b, tol=1e-4):
    """bool[B]: the entries of ``values[B, k]`` at the two chosen indices
    are within ``tol`` of the row's scale (either choice is the minimum up
    to summation-order noise)."""
    va = torch.gather(values, 1, chosen_a.long()[:, None])[:, 0]
    vb = torch.gather(values, 1, chosen_b.long()[:, None])[:, 0]
    finite = torch.where(torch.isfinite(values), values.abs(), 0.0)
    scale = finite.max(dim=1).values.clamp_min(1.0)
    return (va - vb).abs() <= tol * scale


def phase_step_kernels():
    """Phase 9: kernels 5 and 6 at the Phase-I shape of m = n = 256, and
    the step that runs them."""
    import linprog_tpu_torch.engine_batched as le
    from linprog_tpu_torch import engine
    from linprog_tpu_torch.generators import device_standard_form_batch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    cc, G, hh = device_inequality_lps(gen, B, M, N, DEVICE)
    _, As, b = device_standard_form_batch(cc, G, hh)
    ns = N + M  # structural and slack columns
    n1 = ns + M
    A1 = torch.cat([As, torch.eye(M, device=DEVICE).expand(B, M, M)],
                   dim=2).contiguous()
    c1 = torch.cat([torch.zeros((B, ns), device=DEVICE),
                    torch.ones((B, M), device=DEVICE)], dim=1).contiguous()
    allowed = torch.ones(n1, dtype=torch.bool, device=DEVICE)
    cfg = lt.SolverConfig(pricing="dantzig")
    state = engine.slack_crash_state(A1, b, ns)
    state = state._replace(inv_B=state.inv_B.contiguous(),
                           bfs=state.bfs.contiguous())

    def plain_step(s):
        """The step on the plain versions of both kernels, on a copy."""
        s = s._replace(inv_B=s.inv_B.clone(), bfs=s.bfs.clone())
        saved = le.price_entering, le.ratio_eta_pivot
        le.price_entering = stk.price_entering_plain
        le.ratio_eta_pivot = stk.ratio_eta_pivot_plain
        try:
            return le.batched_primal_step(c1, A1, b, allowed, s, cfg, 1 << 20)
        finally:
            le.price_entering, le.ratio_eta_pivot = saved

    # 64 steps on the kernels, each held against the plain versions' step
    # from the same state.  A lane may differ only at a near tie (the two
    # choices within 1e-4 of scale in the plain arithmetic).
    stk.launches["price_entering"] = stk.launches["ratio_eta_pivot"] = 0
    differing = 0
    worst_inv = worst_bfs = worst_bfs_abs = 0.0
    steps = 64
    for k in range(steps):
        want = plain_step(state)
        cB = torch.gather(c1, 1, state.basis.long())
        pen = le.batched_in_basis_penalty(state.basis, n1, allowed)
        y = torch.einsum("bm,bmk->bk", cB, state.inv_B)
        r = c1 - torch.einsum("bm,bmn->bn", y, A1) + pen
        old_basis = state.basis
        old_inv, old_bfs = state.inv_B.clone(), state.bfs.clone()
        state = le.batched_primal_step(c1, A1, b, allowed, state, cfg,
                                       1 << 20)
        torch.cuda.synchronize()
        if not torch.equal(state.iters, want.iters):
            fail(f"step_kernels: iteration counts differ at step {k}")
        same = ((state.basis == want.basis).all(dim=1)
                & (state.status == want.status))
        if not same.all():
            # the entering column and leaving row of either version
            moved_k = state.basis != old_basis
            moved_p = want.basis != old_basis
            piv_k, piv_p = moved_k.any(dim=1), moved_p.any(dim=1)
            row_k = moved_k.to(torch.int8).argmax(dim=1)
            row_p = moved_p.to(torch.int8).argmax(dim=1)
            ent_k = torch.gather(state.basis, 1, row_k[:, None])[:, 0]
            ent_p = torch.gather(want.basis, 1, row_p[:, None])[:, 0]
            d = torch.einsum("bmk,bk->bm", old_inv,
                             le._gather_cols(A1, ent_p))
            pos = d > cfg.pivot_tol
            theta = torch.where(pos, old_bfs / torch.where(pos, d, 1.0),
                                float("inf"))
            both_piv = piv_k & piv_p
            tie = both_piv & (ent_k != ent_p) & _near_tied(r, ent_k, ent_p)
            tie |= (both_piv & (ent_k == ent_p)
                    & _near_tied(theta, row_k, row_p))
            # one version found no eligible column: the best reduced cost
            # sits at the tolerance
            tie |= (piv_k != piv_p) & (r.min(dim=1).values.abs() <= 1e-4)
            bad = ~same & ~tie
            if bad.any():
                fail(f"step_kernels: step {k} differs from the plain "
                     f"versions on {int(bad.sum())} lanes that are not near "
                     "ties")
            differing += int((~same).sum())
        scale = want.inv_B.abs().amax().item()
        worst_inv = max(worst_inv, ((state.inv_B - want.inv_B).abs()
                                    [same].max().item()) / max(scale, 1.0))
        err_bfs = (state.bfs - want.bfs).abs()[same].max().item()
        worst_bfs_abs = max(worst_bfs_abs, err_bfs)
        worst_bfs = max(worst_bfs,
                        err_bfs / max(want.bfs.abs().amax().item(), 1.0))
        del want, old_bfs, old_inv, r
    launches = dict(stk.launches)
    if differing > 4 * steps:
        fail(f"step_kernels: {differing} lane-steps at near ties over "
             f"{steps} steps (> {4 * steps})")
    if not worst_inv <= 1e-4:
        fail(f"step_kernels: inv_B differs by {worst_inv:.3e} of scale after "
             "one step (> 1e-4)")
    if not worst_bfs <= 1e-4:
        fail(f"step_kernels: bfs differs by {worst_bfs:.3e} of scale after "
             "one step (> 1e-4)")

    # each kernel against its plain version at the mid-solve state, and
    # their times (copies of the factor outside the timed region)
    cB = torch.gather(c1, 1, state.basis.long()).contiguous()
    pen = le.batched_in_basis_penalty(state.basis, n1, allowed)
    price_kw = dict(dantzig=True, opt_tol=cfg.opt_tol)
    ek, gk = stk.price_entering(cB, state.inv_B, A1, c1, pen, **price_kw)
    ep, gp = stk.price_entering_plain(cB, state.inv_B, A1, c1, pen,
                                      **price_kw)
    y = torch.einsum("bm,bmk->bk", cB, state.inv_B)
    r = c1 - torch.einsum("bm,bmn->bn", y, A1) + pen
    ok_enter = (ek == ep) | _near_tied(r, ek.clamp_max(n1 - 1),
                                       ep.clamp_max(n1 - 1))
    if not (ok_enter.all() and torch.equal(gk, gp)):
        fail("step_kernels: price_entering differs from its plain version "
             f"on {int((~ok_enter).sum())} lanes off near ties, or in a flag")
    r_k = torch.gather(r, 1, ek.clamp_max(n1 - 1).long()[:, None])[:, 0]
    r_p = torch.gather(r, 1, ep.clamp_max(n1 - 1).long()[:, None])[:, 0]
    err_price = (r_k - r_p).abs().max().item()
    ms_price = cuda_ms(lambda: stk.price_entering(
        cB, state.inv_B, A1, c1, pen, **price_kw), 20)
    ms_price_p = cuda_ms(lambda: stk.price_entering_plain(
        cB, state.inv_B, A1, c1, pen, **price_kw), 20)

    acol = le._gather_cols(A1, ep.clamp_max(n1 - 1)).contiguous()
    go = (gp > 0).to(torch.int32)[:, None].contiguous()
    ik, bk_ = state.inv_B.clone(), state.bfs.clone()
    ip, bp = state.inv_B.clone(), state.bfs.clone()
    _, _, lk, uk = stk.ratio_eta_pivot(ik, bk_, acol, go,
                                       pivot_tol=cfg.pivot_tol)
    _, _, lp_, up = stk.ratio_eta_pivot_plain(ip, bp, acol, go,
                                              pivot_tol=cfg.pivot_tol)
    torch.cuda.synchronize()
    same_l = lk == lp_
    if not torch.equal(uk, up) or int((~same_l).sum()) > 4:
        fail("step_kernels: ratio_eta_pivot differs from its plain version "
             f"on {int((~same_l).sum())} lanes (> 4), or in a flag")
    err_ratio = ((ik - ip).abs()[same_l].max().item()
                 / max(ip.abs().max().item(), 1.0))
    if not err_ratio <= 1e-4:
        fail(f"step_kernels: ratio_eta_pivot's factor differs by "
             f"{err_ratio:.3e} of scale (> 1e-4)")
    err_ratio_bfs_abs = (bk_ - bp).abs()[same_l].max().item()
    err_ratio_bfs = err_ratio_bfs_abs / max(bp.abs().max().item(), 1.0)
    if not err_ratio_bfs <= 1e-4:
        fail(f"step_kernels: ratio_eta_pivot's bfs differs by "
             f"{err_ratio_bfs:.3e} of scale (> 1e-4)")
    pivoting = int(((go[:, 0] > 0) & (uk == 0)).sum())
    del ik, bk_, ip, bp
    copies = iter([(state.inv_B.clone(), state.bfs.clone())
                   for _ in range(20)])
    ms_ratio = cuda_ms(lambda: stk.ratio_eta_pivot(
        *next(copies), acol, go, pivot_tol=cfg.pivot_tol), 20)
    copies = iter([(state.inv_B.clone(), state.bfs.clone())
                   for _ in range(20)])
    ms_ratio_p = cuda_ms(lambda: stk.ratio_eta_pivot_plain(
        *next(copies), acol, go, pivot_tol=cfg.pivot_tol), 20)
    del copies

    pb_ms, pb_by = bound_ms(4 * B * (M * M + M * n1 + M + 2 * n1 + 2),
                            B * 2 * (M * M + M * n1))
    rb_ms, rb_by = bound_ms(
        4 * (B * (M * M + 3 * M + 3) + pivoting * (M * M + M)),
        B * 2 * M * M + pivoting * 2 * M * M)
    out = {"phase": "step_kernels", "shape": [B, M, n1],
           "steps": {"count": steps, "lane_steps_at_near_ties": differing,
                     "max_rel_err_inv_B": worst_inv,
                     "max_rel_err_bfs": worst_bfs,
                     "max_abs_err_bfs": worst_bfs_abs, "tol": "1e-4 of scale",
                     "launches": launches,
                     "lane_status": status_counts(state.status)},
           "price_entering": {"lanes_equal": int((ek == ep).sum()),
                              "max_abs_err_r_enter": err_price,
                              "ms": ms_price, "plain_ms": ms_price_p,
                              "bound_ms": pb_ms, "bound_by": pb_by,
                              "reps": 20},
           "ratio_eta_pivot": {"lanes_equal": int(same_l.sum()),
                               "pivoting_lanes": pivoting,
                               "max_rel_err_inv_B": err_ratio,
                               "max_rel_err_bfs": err_ratio_bfs,
                               "max_abs_err_bfs": err_ratio_bfs_abs,
                               "ms": ms_ratio, "plain_ms": ms_ratio_p,
                               "bound_ms": rb_ms, "bound_by": rb_by,
                               "reps": 20}}
    emit(out)
    for name, cnt in launches.items():
        if cnt != steps:
            fail(f"step_kernels: {name} launched {cnt} times over {steps} "
                 "steps")
    return out


def _reset_counts():
    sk.launches = sk.launches_dual = ck.launches = 0
    sk.launches_streaming = sk.launches_streaming_dual = 0
    sk.launches_unit = 0
    ssk.launches = ssk.launches_dual = bk.launches = 0
    ddk.launches = luk.launches = 0


def _read_counts():
    """The wrappers' launch counts; kernels 1 and 3 also by mode, kernel 1
    by branch."""
    return {"solve_segment": sk.launches,
            "solve_segment_dual": sk.launches_dual,
            "solve_segment_primal": sk.launches - sk.launches_dual,
            "solve_segment_streaming_dual": sk.launches_streaming_dual,
            "solve_segment_streaming_primal": (sk.launches_streaming
                                               - sk.launches_streaming_dual),
            "solve_segment_unit": sk.launches_unit,
            "panel_cholinv": ck.launches,
            "solve_segment_stream": ssk.launches,
            "solve_segment_stream_dual": ssk.launches_dual,
            "solve_segment_stream_primal": ssk.launches - ssk.launches_dual,
            "solve_bounded_segment": bk.launches,
            "dd_residual": ddk.launches, "batched_lu": luk.launches}


def _walled(fn):
    """``fn()`` between two synchronisations: (result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def _n_optimal(results):
    return sum(int((r.status == st.OPTIMAL).sum()) for r in results)


def _chunks(seed, chunks, lanes, m):
    out = []
    for k in range(chunks):
        gen = torch.Generator(device=DEVICE).manual_seed(seed + k)
        out.append(device_inequality_lps(gen, lanes, m, m, DEVICE))
    return out


def phase_recovery():
    """Phase 10: pooled IPM straggler recovery."""
    from linprog_tpu_torch.ipm import _recovery_pick

    # (a) the guard run: a starved IPM, every lane a straggler
    lanes, m = RECOVERY_GUARD
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    c, G, h = device_inequality_lps(gen, lanes, m, m, DEVICE)
    raw = lt.ipm_solve_batch_canonical(c, G, h, lt.IPMConfig(maxiters=4))
    n_raw = _n_optimal([raw])
    _reset_counts()
    (rec,), wall = _walled(
        lambda: lt.recover_stragglers_pooled([(c, G, h)], [raw]))
    launches = _read_counts()
    cert = lt.certify_vertex_batch(c, G, h, rec.basis)
    summ = lt.certificate_summary(cert)
    gap = highs_gap(rec.cost, c, 4, A_ub=G, b_ub=h)
    guard = {"lanes": lanes, "m": m, "n": m, "ipm_maxiters": 4,
             "raw_optimal": n_raw, "lane_status": status_counts(rec.status),
             "certified": summ["certified"], "wall_s": wall,
             "pivots": int((rec.iters - raw.iters).sum()),
             "launches": launches, "highs_lanes": 4, "max_rel_gap_vs_highs": gap}

    # (b) the number: 4 chunks of 128 at m = n = 512
    chunks, lanes_b, mb = IPM_CHUNKS
    batches = _chunks(SEED + 20, chunks, lanes_b, mb)
    icfg = lt.IPMConfig(eps_rel=1e-3, maxiters=40)

    def raw_all():
        return [lt.ipm_solve_batch_canonical(*b, icfg) for b in batches]

    def recovered_all():
        raws = raw_all()
        return raws, lt.recover_stragglers_pooled(batches, raws)

    raw_all()  # warm-up
    raws, raw_wall = _walled(raw_all)
    recovered_all()  # warm-up
    _reset_counts()
    (raws2, recs), rec_wall = _walled(recovered_all)
    launches_b = _read_counts()
    total = chunks * lanes_b
    stragglers, pick = _recovery_pick(
        [r.status.cpu().numpy() for r in raws2], total)
    worse = sum(int(((rc.status != st.OPTIMAL) & (rc.status != rw.status)).sum()
                    + ((rw.status == st.OPTIMAL)
                       & (rc.status != st.OPTIMAL)).sum())
                for rc, rw in zip(recs, raws2))
    steps = torch.cat([r.iters for r in raws2])
    number = {"chunks": chunks, "lanes": total, "m": mb, "n": mb,
              "eps_rel": icfg.eps_rel, "ipm_maxiters": icfg.maxiters,
              "raw_wall_s": raw_wall, "raw_optimal": _n_optimal(raws),
              "raw_lps_per_sec": total / raw_wall,
              "recovered_wall_s": rec_wall,
              "recovered_optimal": _n_optimal(recs),
              "recovered_lps_per_sec": total / rec_wall,
              "stragglers": len(stragglers), "bucket": len(pick),
              "pivots": int(sum((rc.iters - rw.iters).sum()
                                for rc, rw in zip(recs, raws2))),
              "lanes_worse": worse,
              "newton_steps_median": int(steps.median()),
              "newton_steps_max": int(steps.max()),
              "launches": launches_b}
    emit({"phase": "recovery", "guard_run": guard, "ipm_m512": number})

    if int((rec.status == st.OPTIMAL).sum()) != lanes:
        fail(f"recovery: {guard['lane_status']} after the starved IPM")
    if summ["certified"] < int(0.99 * lanes):
        fail(f"recovery: {summ['certified']}/{lanes} certified (< 99 %)")
    if not gap <= 1e-5:
        fail(f"recovery: HiGHS gap {gap:.3e} > 1e-5")
    if (launches["solve_segment_dual"] <= 0
            or launches["solve_segment_primal"] <= 0):
        fail(f"recovery: kernel solve_segment launched {launches}")
    if number["recovered_optimal"] < _n_optimal(raws2):
        fail(f"recovery m=512: {number['recovered_optimal']} OPTIMAL after, "
             f"{_n_optimal(raws2)} before")
    if worse:
        fail(f"recovery m=512: {worse} lanes ended with a worse status")
    if launches_b["panel_cholinv"] <= 0:
        fail("recovery m=512: kernel panel_cholinv was never launched")
    if stragglers and launches_b["solve_segment"] <= 0:
        fail("recovery m=512: kernel solve_segment was never launched")
    return {"recovery_m256": launches, "recovery_m512": launches_b}


def phase_warm():
    """Phase 11: warm re-solves, simplex and IPM."""
    from scipy.optimize import linprog

    from linprog_tpu_torch.batch import (
        batch_summary,
        reoptimize_batch_new_rhs,
    )

    # (a) warm_rhs_m256
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    c, G, h = device_inequality_lps(gen, B, M, N, DEVICE)
    cs, As, bs = device_standard_form_batch(c, G, h)
    noise = 1.0 + 0.05 * torch.randn(bs.shape, generator=gen, device=DEVICE)
    bs_new = bs * noise
    cfg = tuned_config(M)
    maxiters = 2000
    base, base_wall = _walled(
        lambda: lt.solve_batch_two_phase(cs, As, bs, maxiters, maxiters, cfg))
    s_base = batch_summary(base)
    if s_base["optimal"] != B or not (base.basis < cs.shape[1]).all():
        fail(f"warm rhs: base solve {s_base} or an artificial in a basis")

    def warm_rhs():
        return reoptimize_batch_new_rhs(cs, As, bs_new, base.basis, maxiters,
                                        cfg)

    warm_rhs()  # warm-up
    _reset_counts()
    warm, wall = _walled(warm_rhs)
    launches = _read_counts()
    s_warm = batch_summary(warm)
    n_inf = int((warm.status == st.DUAL_UNBOUNDED).sum())
    fresh, fresh_wall = _walled(
        lambda: lt.solve_batch_two_phase(cs, As, bs_new, maxiters, maxiters,
                                         cfg))
    both = (warm.status == st.OPTIMAL) & (fresh.status == st.OPTIMAL)
    vs_fresh = ((warm.cost - fresh.cost).abs()
                / fresh.cost.abs().clamp_min(1.0))[both].max().item()
    # HiGHS on 4 lanes: the first lanes, and a DUAL_UNBOUNDED one if any
    check = list(range(4))
    inf_lanes = torch.nonzero(warm.status == st.DUAL_UNBOUNDED).flatten()
    if inf_lanes.numel():
        check[-1] = int(inf_lanes[0])
    gaps = []
    for i in check:
        ref = linprog(cs[i].double().cpu().numpy(),
                      A_eq=As[i].double().cpu().numpy(),
                      b_eq=bs_new[i].double().cpu().numpy(), method="highs")
        code = int(warm.status[i])
        if code == st.DUAL_UNBOUNDED:
            if ref.status != 2:
                fail(f"warm rhs: lane {i} DUAL_UNBOUNDED, HiGHS says "
                     f"{ref.message}")
        elif ref.status != 0:
            fail(f"warm rhs: HiGHS did not solve lane {i} ({ref.message})")
        else:
            gaps.append(abs(float(warm.cost[i]) - ref.fun)
                        / max(1.0, abs(ref.fun)))
    gap = float(max(gaps)) if gaps else None
    rhs = {"lanes": B, "m": M, "n": N + M, "perturbation": 0.05,
           "lane_status": status_counts(warm.status),
           "wall_s": wall, "lps_per_sec": B / wall,
           "base_wall_s": base_wall, "fresh_wall_s": fresh_wall,
           "mean_warm_pivots": s_warm["total_pivots"] / B,
           "max_warm_pivots": s_warm["max_pivots"],
           "mean_fresh_pivots": s_base["total_pivots"] / B,
           "max_rel_diff_vs_fresh": vs_fresh,
           "launches": launches, "highs_lanes": check, "max_rel_gap_vs_highs": gap}

    # (b) warm_ipm_m512
    (chunks, lanes_b, mb), perturb = IPM_CHUNKS, 0.02
    batches = _chunks(SEED + 50, chunks, lanes_b, mb)
    icfg = lt.IPMConfig(eps_rel=1e-3, maxiters=40)
    states = [lt.ipm_solve_batch_canonical(*b, icfg, return_state=True)[1]
              for b in batches]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 51)
    new_hs = [b[2] * (1.0 + perturb * torch.randn(b[2].shape, generator=gen,
                                                  device=DEVICE))
              for b in batches]

    def warm_all():
        return [lt.reoptimize_ipm_batch_canonical(b[0], b[1], hn, s, icfg)
                for b, hn, s in zip(batches, new_hs, states)]

    def cold_all():
        return [lt.ipm_solve_batch_canonical(b[0], b[1], hn, icfg)
                for b, hn in zip(batches, new_hs)]

    warm_all()
    cold_all()
    _reset_counts()
    warm_i, warm_wall = _walled(warm_all)
    launches_w = _read_counts()
    _reset_counts()
    cold_i, cold_wall = _walled(cold_all)
    launches_c = _read_counts()
    w_cost = torch.cat([r.cost for r in warm_i])
    c_cost = torch.cat([r.cost for r in cold_i])
    w_stat = torch.cat([r.status for r in warm_i])
    c_stat = torch.cat([r.status for r in cold_i])
    both = (w_stat == st.OPTIMAL) & (c_stat == st.OPTIMAL)
    diff = ((w_cost - c_cost).abs() / c_cost.abs().clamp_min(1.0))[both]
    w_it = torch.cat([r.iters for r in warm_i])
    c_it = torch.cat([r.iters for r in cold_i])
    total = chunks * lanes_b
    # HiGHS on the lane where warm and cold differ most, and on three more
    worst = int(torch.where(both, (w_cost - c_cost).abs()
                            / c_cost.abs().clamp_min(1.0), -1.0).argmax())
    ipm_check = sorted({worst, *torch.nonzero(both).flatten()[:3].tolist()})
    warm_gaps, cold_gaps = [], []
    for i in ipm_check:
        k, j = divmod(i, lanes_b)
        ref = linprog(batches[k][0][j].double().cpu().numpy(),
                      A_ub=batches[k][1][j].double().cpu().numpy(),
                      b_ub=new_hs[k][j].double().cpu().numpy(),
                      method="highs")
        if ref.status != 0:
            fail(f"warm ipm: HiGHS did not solve lane {i} ({ref.message})")
        scale = max(1.0, abs(ref.fun))
        warm_gaps.append(abs(float(w_cost[i]) - ref.fun) / scale)
        cold_gaps.append(abs(float(c_cost[i]) - ref.fun) / scale)
    ipm = {"chunks": chunks, "lanes": total, "m": mb, "n": mb,
           "perturbation": perturb, "eps_rel": icfg.eps_rel,
           "warm_wall_s": warm_wall, "warm_optimal": _n_optimal(warm_i),
           "warm_lps_per_sec": total / warm_wall,
           "cold_wall_s": cold_wall, "cold_optimal": _n_optimal(cold_i),
           "cold_lps_per_sec": total / cold_wall,
           "warm_newton_steps_max": int(w_it.max()),
           "cold_newton_steps_max": int(c_it.max()),
           "warm_newton_steps_median": int(w_it.median()),
           "cold_newton_steps_median": int(c_it.median()),
           "lanes_optimal_in_both": int(both.sum()),
           "max_rel_cost_diff": diff.max().item() if diff.numel() else None,
           "median_rel_cost_diff": (diff.median().item() if diff.numel()
                                    else None),
           "lanes_differing_by_more_than_1e-3": int((diff > 1e-3).sum()),
           "highs_lanes": ipm_check,
           "warm_max_rel_gap_vs_highs": max(warm_gaps),
           "cold_max_rel_gap_vs_highs": max(cold_gaps),
           "warm_launches": launches_w, "cold_launches": launches_c}
    emit({"phase": "warm", "warm_rhs_m256": rhs, "warm_ipm_m512": ipm})

    done = ((warm.status == st.OPTIMAL)
            | (warm.status == st.DUAL_UNBOUNDED))
    if not done.all():
        fail(f"warm rhs: {rhs['lane_status']}")
    if gap is not None and not gap <= 1e-5:
        fail(f"warm rhs: HiGHS gap {gap:.3e} > 1e-5")
    if not rhs["mean_warm_pivots"] < rhs["mean_fresh_pivots"]:
        fail(f"warm rhs: {rhs['mean_warm_pivots']:.1f} warm pivots a lane, "
             f"{rhs['mean_fresh_pivots']:.1f} fresh")
    if (launches["solve_segment_dual"] <= 0
            or launches["solve_segment_primal"] <= 0):
        fail(f"warm rhs: kernel solve_segment launched {launches}")
    # two answers of the eps_rel = 1e-3 class: each within 5e-3 of the
    # optimum (the bar the raw interior family is held to), so of each other
    if not both.any() or not diff.max().item() <= 5e-3:
        fail(f"warm ipm: costs differ by {ipm['max_rel_cost_diff']} on lanes "
             "OPTIMAL in both (> 5e-3)")
    if not max(warm_gaps + cold_gaps) <= 5e-3:
        fail(f"warm ipm: HiGHS gaps warm {max(warm_gaps):.3e}, cold "
             f"{max(cold_gaps):.3e} (> 5e-3)")
    if launches_w["panel_cholinv"] <= 0:
        fail("warm ipm: kernel panel_cholinv was never launched")
    return {"warm_rhs_m256": launches, "warm_ipm_m512": launches_w}


def phase_router():
    """Phase 12: the front door at three regimes, and the certificates of
    an unbounded and an infeasible lane."""
    from linprog_tpu_torch.batch import unbounded_rays_from_result
    from linprog_tpu_torch.router import auto_summary

    runs, driven, all_launches = [], {}, {}
    for expect, lanes, m, accuracy in ROUTER_REGIMES + [ROUTER_PDHG]:
        # vertex families: HiGHS gap 1e-5; the interior family: 5e-3
        gap_tol = 1e-5 if accuracy <= 1e-5 else 5e-3
        first_order = expect == "pdhg"
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 60 + m)
        c, G, h = device_inequality_lps(gen, lanes, m, m, DEVICE)
        prefers = [None]
        if lt.choose_family(m, accuracy) != expect:
            prefers.append(expect)  # the table routes elsewhere: drive both
        for prefer in prefers:
            def run():
                return lt.solve_batch_auto(c, G, h, accuracy=accuracy,
                                           prefer=prefer)

            run()  # warm-up
            _reset_counts()
            (res, info), wall = _walled(run)
            launches = _read_counts()
            repeats = ROUTER_PDHG_REPEATS if first_order else ROUTER_REPEATS
            walls = [wall] + [_walled(run)[1] for _ in range(repeats - 1)]
            wall = float(np.median(walls))
            summ = auto_summary(res, info)
            t_h = time.time()
            if first_order:
                # HiGHS takes over ten minutes a lane at m = 4096: the
                # oracle is the exact pipeline's dd-certified vertices
                check = exact_check(res.x, res.cost, c, G, h)
                gaps = [g for g in check["gaps"] if g is not None]
                gap = max(gaps) if gaps else float("inf")
            else:
                gap, check = highs_gap(res.cost, c, 4, A_ub=G, b_ub=h), None
            oracle_s = time.time() - t_h
            runs.append({"expected": expect, "prefer": prefer, **summ,
                         "wall_s": wall, "walls_s": walls,
                         "lps_per_sec": lanes / wall,
                         "lane_status": status_counts(res.status),
                         "iters_median": int(res.iters.median()),
                         "iters_max": int(res.iters.max()),
                         "launches": launches,
                         "oracle": ("certified exact vertices" if first_order
                                    else "HiGHS on 4 lanes"),
                         "oracle_s": oracle_s, "max_rel_gap_vs_oracle": gap,
                         **({"exact_check": check} if check else {})})
            driven[info["family"]] = runs[-1]
            all_launches[f"router_{info['family']}_m{m}"] = launches
            if res.x.shape != (lanes, m):
                fail(f"router {info['family']}: x has shape {res.x.shape}")
            if info["family"] != (prefer or lt.choose_family(m, accuracy)):
                fail(f"router: took {info['family']} at m={m}")
            if accuracy <= 1e-5 or first_order:
                if summ["optimal"] != lanes:
                    fail(f"router {info['family']} m={m}: "
                         f"{runs[-1]['lane_status']}")
            if first_order:
                # eps 1e-4 bounds the scaled KKT residuals, not the
                # objective: one lane of |optimum| 18 among lanes of
                # 700-2300 is 3.3e-3 off in f32 and 3.0e-3 in float64
                # (tools/diag_pdhg_m4096.py); lane 0 within 1e-3, every
                # certified lane within 1e-2, x feasible to 2 eps
                g0 = check["gaps"][0]
                if g0 is None or not g0 <= 1e-3:
                    fail(f"router pdhg m={m}: lane 0 gap {g0} > 1e-3")
                gap_tol = 1e-2
                worst = max(check["primal_infeasibility"])
                if not worst <= 2 * accuracy:
                    fail(f"router pdhg m={m}: primal infeasibility "
                         f"{worst:.3e} > {2 * accuracy}")
            if not gap <= gap_tol:
                fail(f"router {info['family']} m={m}: gap {gap:.3e} to "
                     f"{runs[-1]['oracle']} > {gap_tol}")

    # lane 0: min -x1 - x2, x1 - x2 = 1, x3 = 1 (unbounded along (1, 1, 0));
    # lane 1: -x1 - x2 = 1 (infeasible); lane 2: min x1 + 2 x2, x1 + x2 = 1
    A = torch.tensor([[[1.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
                      [[-1.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
                      [[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]], device=DEVICE)
    b = torch.ones((3, 2), device=DEVICE)
    cc = torch.tensor([[-1.0, -1.0, 0.0], [0.0, 0.0, 0.0], [1.0, 2.0, 0.0]],
                      device=DEVICE)
    cfg = lt.SolverConfig(pricing="dantzig")
    res = lt.solve_batch_two_phase(cc, A, b, 100, 100, cfg)
    rays = unbounded_rays_from_result(cc, A, res, cfg)
    d, y = rays[0], res.y[1]
    certs = {"lane_status": [st.status_name(int(k)) for k in res.status],
             "ray": d.tolist(), "max_abs_Ad": (A[0] @ d).abs().max().item(),
             "c_dot_d": float(cc[0] @ d), "farkas_y": y.tolist(),
             "max_yA": (y @ A[1]).max().item(), "y_dot_b": float(y @ b[1])}
    emit({"phase": "router", "runs": runs, "certificates": certs})

    for family in ("simplex", "ipm", "ipm+crossover", "pdhg"):
        if family not in driven:
            fail(f"router: family {family} was not driven")
    if driven["ipm"]["launches"]["panel_cholinv"] <= 0:
        fail("router ipm: kernel panel_cholinv was never launched")
    if driven["simplex"]["launches"]["solve_segment"] <= 0:
        fail("router simplex: kernel solve_segment was never launched")
    if driven["ipm"]["optimal"] < driven["ipm"]["lanes"] - 1:
        fail(f"router ipm: {driven['ipm']['lane_status']}")
    if res.status.tolist() != [st.PRIMAL_UNBOUNDED, st.PRIMAL_INFEASIBLE,
                               st.OPTIMAL]:
        fail(f"router certificates: statuses {certs['lane_status']}")
    if not (certs["max_abs_Ad"] <= 1e-5 and (d >= 0).all()
            and certs["c_dot_d"] < 0 and not rays[1:].any()):
        fail(f"router certificates: not an improving ray: {certs}")
    if not (certs["max_yA"] <= 1e-5 and certs["y_dot_b"] > 1e-5):
        fail(f"router certificates: not a Farkas vector: {certs}")
    return all_launches


def phase_calibrate():
    """Phase 13: calibrate() on the card at two sizes."""
    from linprog_tpu_torch import calibration

    pdhg_sizes, pdhg_lanes = CALIBRATE_PDHG
    _reset_counts()
    out, wall = _walled(lambda: calibration.calibrate(
        sizes=CALIBRATE_SIZES, lanes=64, device=DEVICE,
        pdhg_sizes=pdhg_sizes, pdhg_lanes=pdhg_lanes))
    launches = _read_counts()
    (kind, table), = out.items()
    emit({"phase": "calibrate", "kind": kind, "table": table,
          "pdhg_seconds": table["_provenance"]["pdhg_seconds"],
          "wall_s": wall, "launches": launches,
          "in_use": calibration.get_table()})
    schema = {"exact_simplex_max_m", "moderate_simplex_max_m", "pdhg_min_m",
              "exact_eps", "xover_pallas_max_m", "seg_by_m"}
    if kind != torch.cuda.get_device_name(0):
        fail(f"calibrate: table keyed by {kind!r}")
    if not schema <= set(table):
        fail(f"calibrate: keys missing: {sorted(schema - set(table))}")
    if set(table["_measured"]) != schema:
        fail(f"calibrate: measured {table['_measured']}")
    if set(table["_provenance"]["pdhg_seconds"]) != {str(m) for m in
                                                     pdhg_sizes}:
        fail(f"calibrate: PDHG leg {table['_provenance']['pdhg_seconds']}")
    if [r[0] for r in table["seg_by_m"][:2]] != list(CALIBRATE_SIZES):
        fail(f"calibrate: seg_by_m {table['seg_by_m']}")
    for name in ("solve_segment", "panel_cholinv"):
        if launches[name] <= 0:
            fail(f"calibrate: kernel {name} was never launched")
    return {"calibrate": launches}


def idle_share(fn):
    """Run ``fn()`` once under ``torch.profiler`` and read the device's
    timeline: the busy time (the union of the kernels' and copies'
    intervals), the window from the first device event's start to the
    last one's end, and the idle share of that window; the host wall of
    the profiled run beside them (the profiler's own cost included).
    ``None`` where the profiler recorded no device event."""
    from torch.profiler import ProfilerActivity, profile

    t_all = time.time()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = spans[-1][1] - spans[0][0]
    return {"device_busy_ms": busy / 1e3, "device_window_ms": window / 1e3,
            "idle_share": 1.0 - busy / window if window > 0 else None,
            "device_events": len(spans), "host_wall_ms": wall * 1e3,
            "profile_s": time.time() - t_all}


def _graphed_idle(eager, wall, iters_max):
    """The graphed run's idle share, estimated: the kernels are the eager
    run's (the same bits), so the device's busy time an iteration is the
    eager profile's, over the window's iterations (its set-up and checks
    included); the lanes run in lockstep to ``iters_max``."""
    prof = eager["profile_window"]
    if "device_busy_ms" not in prof:
        return None
    busy = prof["device_busy_ms"] / prof["maxiters"] * iters_max / 1e3
    return 1.0 - busy / wall


def _eager_pdhg(run, graphed):
    """The same solve with each step launched from the host (no captured
    graph): the median wall of two runs, the idle share of a profiled
    window, and whether it gives the graphed run's bits."""
    from linprog_tpu_torch import pdhg

    graphed_chunks = pdhg._graphed
    pdhg._graphed = lambda chunk, state: chunk
    try:
        out, w1 = _walled(run)
        w2 = _walled(run)[1]
        prof = idle_share(lambda: run(PROFILE_ITERS))
    finally:
        pdhg._graphed = graphed_chunks
    return {"wall_s": float(np.median([w1, w2])), "walls_s": [w1, w2],
            "profile_window": {"maxiters": PROFILE_ITERS, **(prof or {})},
            "same_bits_as_graphed": all(same_bits(a, b)
                                        for a, b in zip(out, graphed))}


def _pdhg_gemv_bound_ms(lanes, m, n):
    """One dense PDHG step's least time: ``K'y`` and ``K(2x+ - x)`` each
    read K once (the vectors are noise beside it)."""
    return bound_ms(2 * 4 * lanes * m * n, 2 * 2 * lanes * m * n)[0]


def phase_pdhg_m256():
    """Phase 17: pdhg_solve_batch_canonical at B = 1024, m = n = 256, eps
    1e-4, fixed-cadence restarts (the reference's pdhg_m256 leg), then
    pdhg_crossover_batch_canonical on the same batch."""
    from linprog_tpu_torch.pdhg import PDHGConfig, pdhg_solve_batch_canonical

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, PB, PM, PM, DEVICE)
    cfg = PDHGConfig(eps_rel=PDHG_EPS, adaptive=False)

    def run(maxiters=PDHG_MAXITERS):
        return pdhg_solve_batch_canonical(c, G, h, maxiters=maxiters,
                                          cfg=cfg)

    first, warm = _walled(run)
    walls = [_walled(run)[1] for _ in range(PDHG_REPEATS)]
    wall = float(np.median(walls))
    x, cost, status, iters = first
    eager = _eager_pdhg(run, first)
    gap = highs_gap(cost, c, 16, A_ub=G, b_ub=h)
    it_max = int(iters.max())
    step_bound = _pdhg_gemv_bound_ms(PB, PM, PM)

    _reset_counts()
    (xres, crossed), xwall = _walled(
        lambda: lt.pdhg_crossover_batch_canonical(c, G, h))
    launches = _read_counts()
    cert = lt.certify_vertex_batch(c, G, h, xres.basis)
    certified = int((cert["certified"] & crossed).sum())
    xgap = highs_gap(xres.cost, c, 4, A_ub=G, b_ub=h)
    out = {"phase": "pdhg_m256", "lanes": PB, "m": PM, "n": PM,
           "seed": SEED, "eps_rel": PDHG_EPS, "adaptive": False,
           "maxiters": PDHG_MAXITERS, "lane_status": status_counts(status),
           "wall_s": wall, "walls_s": walls, "warmup_wall_s": warm,
           "lps_per_sec": PB / wall,
           "iters_median": int(iters.median()), "iters_max": it_max,
           # lockstep: every lane steps until the slowest stops
           "wall_ms_per_step": 1e3 * wall / it_max,
           "gemv_bound_ms_per_step": step_bound,
           "idle_share_est": _graphed_idle(eager, wall, it_max),
           "eager_steps": eager,
           "highs_lanes": 16, "max_rel_gap_vs_highs": gap,
           "crossover": {"crossed": int(crossed.sum()),
                         "certified_of_crossed": certified,
                         "wall_s": xwall,
                         "lane_status": status_counts(xres.status),
                         "highs_lanes": 4, "max_rel_gap_vs_highs": xgap,
                         "launches": launches}}
    emit(out)
    if int((status == st.OPTIMAL).sum()) != PB:
        fail(f"pdhg m=256: {out['lane_status']}")
    if not gap <= 1e-3:
        fail(f"pdhg m=256: HiGHS gap {gap:.3e} > 1e-3")
    if int(crossed.sum()) < 1 or certified < int(0.99 * int(crossed.sum())):
        fail(f"pdhg crossover: {certified} certified of "
             f"{int(crossed.sum())} crossed")
    ok = crossed[:4].cpu()
    if bool(ok.all()) and not xgap <= 1e-5:
        fail(f"pdhg crossover: HiGHS gap {xgap:.3e} > 1e-5")
    if (launches["solve_segment_dual"] <= 0
            or launches["solve_segment_primal"] <= 0):
        fail(f"pdhg crossover: kernel solve_segment launched {launches}")
    return {"pdhg_crossover_m256": launches}


def _highs_sparse_lane(c, rows, cols, vals, h, m, n):
    """HiGHS (interior point, then its crossover) on one sparse lane:
    ``(status, objective)``; run in a worker process."""
    from scipy import sparse
    from scipy.optimize import linprog

    G = sparse.csr_matrix((vals, (rows, cols)), shape=(m, n))
    r = linprog(c, A_ub=G, b_ub=h, bounds=(0, None), method="highs-ipm")
    return r.status, r.fun


def _same_result(a, b):
    """Two results equal bit for bit, field by field (None fields too)."""
    return all((x is None and y is None) or same_bits(x, y)
               for x, y in zip(a, b))


def phase_sparse_m2048():
    """Phase 18: the shared-pattern sparse families at B = 128,
    m = n = 2048, 1 % density (the reference's sparse_ipm_m2048 leg): the
    raw sparse IPM, its straggler recovery, the sparse PDHG on the same
    instances, the sparse front door at two accuracies; HiGHS on two lanes
    (in two worker processes while the card runs), the peak device memory,
    and the same bits from a repeat of each solve."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from linprog_tpu_torch.generators import (
        device_sparse_inequality_lps,
        random_sparse_pattern,
    )

    t0 = time.time()
    rows, cols = random_sparse_pattern(SM, SM, SDENS, seed=0)
    pat = lt.SparsePattern(rows, cols, SM, SM, device=DEVICE)
    pattern_s = time.time() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, vals, h = device_sparse_inequality_lps(gen, SB, rows, cols, SM, SM,
                                              DEVICE)
    icfg = lt.IPMConfig(eps_rel=1e-3, maxiters=40, frac=0.995)

    # HiGHS takes tens of seconds a lane here: two worker processes solve
    # the first two lanes while the card runs the phase
    lanes_h = [tuple(t[i].double().cpu().numpy() for t in (c, vals, h))
               for i in range(2)]
    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing
                               .get_context("spawn"))
    try:
        jobs = [pool.submit(_highs_sparse_lane, ci, rows, cols, vi, hi, SM,
                            SM) for ci, vi, hi in lanes_h]
        return _sparse_m2048(c, rows, cols, vals, h, pat, icfg, pattern_s,
                             jobs)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _sparse_m2048(c, rows, cols, vals, h, pat, icfg, pattern_s, jobs):
    """Phase 18's solves, report and guards; ``jobs`` are HiGHS's two
    lanes, running meanwhile."""
    from linprog_tpu_torch.pdhg import PDHGConfig, pdhg_solve_batch_sparse

    shape = (SM, SM)
    t_h = time.time()

    def ipm():
        return lt.ipm_solve_batch_sparse_canonical(c, rows, cols, vals, h,
                                                   shape, icfg, pattern=pat)

    _, warm = _walled(ipm)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    raw, raw_wall = _walled(ipm)
    raw_launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    raw2 = ipm()
    # the first PROFILE_STEPS Newton steps (a whole solve is ~20k events)
    ipm_prof = idle_share(lambda: lt.ipm_solve_batch_sparse_canonical(
        c, rows, cols, vals, h, shape,
        lt.IPMConfig(eps_rel=1e-3, maxiters=PROFILE_STEPS, frac=0.995),
        pattern=pat))

    _reset_counts()
    rec, rec_wall = _walled(lambda: lt.recover_stragglers_sparse(
        c, rows, cols, vals, h, shape, raw))
    rec_launches = _read_counts()
    rec2 = lt.recover_stragglers_sparse(c, rows, cols, vals, h, shape, raw2)
    n_raw = int((raw.status == st.OPTIMAL).sum())
    n_rec = int((rec.status == st.OPTIMAL).sum())
    stragglers = SB - n_raw
    worse = int((((raw.status == st.OPTIMAL) & (rec.status != st.OPTIMAL))
                 | ((rec.status != st.OPTIMAL)
                    & (rec.status != raw.status))).sum())

    lb = torch.zeros((SB, SM), device=DEVICE)
    ub = torch.full((SB, SM), float("inf"), device=DEVICE)
    pcfg = PDHGConfig(eps_rel=1e-4, adaptive=True, stall_reset_beta=0.95)

    def pdhg(maxiters=PDHG_MAXITERS):
        return pdhg_solve_batch_sparse(c, rows, cols, vals, h, 0, lb, ub,
                                       shape, maxiters=maxiters, cfg=pcfg)

    pst, pdhg_warm = _walled(pdhg)
    pst2, pdhg_wall = _walled(pdhg)
    pdhg_eager = _eager_pdhg(pdhg, pst2)
    pcost = (c * pst2.x).sum(dim=1)

    autos = {}
    for acc in (1e-3, 1e-2):
        _reset_counts()
        (ares, ainfo), awall = _walled(lambda: lt.solve_batch_auto_sparse(
            c, rows, cols, vals, h, shape, accuracy=acc, pattern=pat))
        autos[str(acc)] = {"family": ainfo["family"], "wall_s": awall,
                           "lane_status": status_counts(ares.status),
                           "launches": _read_counts()}

    # HiGHS on two lanes: vertices within 1e-5, the IPM's eps 1e-3
    # answers within 5e-3, PDHG's eps 1e-4 answers within 1e-3
    highs = []
    for i, job in enumerate(jobs):
        status, fun = job.result(timeout=900)
        if status != 0:
            fail(f"sparse m=2048: HiGHS did not solve lane {i}")
        highs.append(fun)
    highs_wait_s = time.time() - t_h

    def rel(a, i):
        return abs(float(a[i]) - highs[i]) / max(1.0, abs(highs[i]))

    gaps = {"raw_ipm": [rel(raw.cost, i) for i in range(2)],
            "recovered": [rel(rec.cost, i) for i in range(2)],
            "pdhg": [rel(pcost, i) for i in range(2)]}
    repeat = {"raw_ipm": _same_result(raw, raw2),
              "recovered": _same_result(rec, rec2),
              "pdhg": all(same_bits(a, b) for a, b in zip(pst, pst2))}
    out = {"phase": "sparse_ipm_m2048", "lanes": SB, "m": SM, "n": SM,
           "density": SDENS, "nnz": int(rows.shape[0]),
           "k_row": pat.k_row, "k_col": pat.k_col,
           "pairs": int(pat.pair_ids.size),
           "distinct_targets": int(pat.pair_targets.size),
           "pattern_host_s": pattern_s,
           "ipm": {"eps_rel": icfg.eps_rel, "maxiters": icfg.maxiters,
                   "wall_s": raw_wall, "warmup_wall_s": warm,
                   "lps_per_sec": SB / raw_wall, "optimal": n_raw,
                   "lane_status": status_counts(raw.status),
                   "newton_steps_median": int(raw.iters.median()),
                   "newton_steps_max": int(raw.iters.max()),
                   "launches": raw_launches, "peak_mem_gb": peak_gb,
                   "profile": {"newton_steps": PROFILE_STEPS,
                               **(ipm_prof or {})}},
           "recovery": {"wall_s": rec_wall,
                        "raw_plus_recovery_lps_per_sec":
                            SB / (raw_wall + rec_wall),
                        "stragglers": stragglers,
                        "optimal": n_rec, "lanes_worse": worse,
                        "lane_status": status_counts(rec.status),
                        "launches": rec_launches},
           "pdhg": {"eps_rel": pcfg.eps_rel, "adaptive": True,
                    "wall_s": pdhg_wall, "warmup_wall_s": pdhg_warm,
                    "lps_per_sec": SB / pdhg_wall,
                    "lane_status": status_counts(pst2.status),
                    "iters_median": int(pst2.iters.median()),
                    "iters_max": int(pst2.iters.max()),
                    "wall_ms_per_step": 1e3 * pdhg_wall
                    / max(1, int(pst2.iters.max())),
                    "idle_share_est": _graphed_idle(
                        pdhg_eager, pdhg_wall, int(pst2.iters.max())),
                    "eager_steps": pdhg_eager},
           "auto": autos, "highs_lanes": 2,
           "highs_wait_s": highs_wait_s,
           "rel_gaps_vs_highs": gaps,
           "same_bits_on_repeat": repeat}
    emit(out)
    if n_rec < n_raw or worse:
        fail(f"sparse m=2048: recovery {n_rec} OPTIMAL from {n_raw}, "
             f"{worse} lanes worse")
    if raw_launches["panel_cholinv"] <= 0:
        fail("sparse m=2048: kernel panel_cholinv was never launched")
    if stragglers and rec_launches["solve_segment_stream"] <= 0:
        fail("sparse m=2048: kernel solve_segment_stream was never launched")
    if not all(repeat.values()):
        fail(f"sparse m=2048: a repeat gave other bits: {repeat}")
    if autos["0.001"]["family"] != "sparse-ipm":
        fail(f"sparse m=2048: accuracy 1e-3 took {autos['0.001']['family']}")
    if autos["0.01"]["family"] != "sparse-pdhg":
        fail(f"sparse m=2048: accuracy 1e-2 took {autos['0.01']['family']}")
    for i in range(2):
        bar = (1e-5 if int(rec.basis[i, 0]) >= 0 else 5e-3)
        if not gaps["recovered"][i] <= bar:
            fail(f"sparse m=2048: lane {i} recovered gap "
                 f"{gaps['recovered'][i]:.3e} > {bar}")
        if (int(pst2.status[i]) == st.OPTIMAL
                and not gaps["pdhg"][i] <= 1e-3):
            fail(f"sparse m=2048: lane {i} PDHG gap {gaps['pdhg'][i]:.3e}")
    return {"sparse_ipm_m2048": raw_launches,
            "sparse_recovery_m2048": rec_launches}


def _hold_stream_lockstep(A, c, apen, state0, cfg, dual):
    """Kernel 3 against its plain version in one mode at the m = 4096
    path's shape, as the crossover launches it (primal packed with the
    blocked-factor direction sum, dual unblocked and unpacked): one
    iteration (basis and
    status equal on every lane without a near tie), then 16 pivots in
    lockstep (basis, status, iterations, c_B and penalties on every lane;
    bfs within 1e-4 of scale), the same bits after 16 pivots under every
    other planned cluster size, and the in-segment time a batch-iteration
    over 64 pivots ((t64 - t1) / 63, median of 3 from fresh states) beside
    the one-iteration bound."""
    b, m, n = A.shape
    mode = "dual" if dual else "primal"
    kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              dual=dual, feas_tol=cfg.feas_tol, stall_limit=cfg.stall_limit,
              packed=cfg.packed_select and not dual, a_resident=False,
              n_blk=256, factor_blocked=not dual)
    label = f"solve_segment_stream {[b, m, n]} {mode}"

    def fresh():
        return sk.SegmentState(*(t.clone() for t in state0))

    def both(seg_len):
        k = ssk.solve_segment_stream(A, c, apen, 1 << 20, fresh(),
                                     seg_len=seg_len, **kw)
        p = ssk.solve_segment_stream_plain(A, c, apen, 1 << 20, fresh(),
                                           seg_len=seg_len, **kw)
        torch.cuda.synchronize()
        return k, p

    k1, p1 = both(1)
    plan = ssk.last_plan
    keep = ~_tie_lanes(A, c, state0, dual, cfg)
    same1 = _lockstep_lanes(k1, p1, ("basis", "status", "iters"))
    if (keep & ~same1).any():
        fail(f"{label}: one-iteration basis/status differ on "
             f"{int((keep & ~same1).sum())} non-tied lanes")
    err1 = (k1.bfs[same1] - p1.bfs[same1]).abs().max().item()
    pivoted = int((k1.basis != state0.basis).any(dim=1).sum())
    del k1, p1

    k16, p16 = both(16)
    same = _lockstep_lanes(k16, p16, ("basis", "status", "iters", "cB", "pen"))
    if not same.all():
        fail(f"{label}: 16 pivots left lockstep on {int((~same).sum())} of "
             f"{b} lanes")
    scale = max(p16.bfs.abs().max().item(), 1.0)
    err16 = (k16.bfs - p16.bfs).abs().max().item()
    if not err16 <= 1e-4 * scale:
        fail(f"{label}: bfs differs by {err16:.3e} after 16 pivots "
             f"(> 1e-4 of {scale:.3e})")
    del p16
    launch_kw = {k: v for k, v in kw.items()
                 if k not in ("a_resident", "n_blk", "factor_blocked")}
    others = [p for p in ssk.stream_plans(b, m, n, dual=dual)
              if p.cluster != plan.cluster and p.aligned == plan.aligned]
    for other in others:
        s = fresh()
        ssk.launch_with_plan(other, A, c, apen, 1 << 20, s, seg_len=16,
                             **launch_kw)
        torch.cuda.synchronize()
        for name, x, y in zip(s._fields, s, k16):
            if not same_bits(x, y):
                fail(f"{label}: {name} after 16 pivots differs between "
                     f"{other.cluster} and {plan.cluster} blocks a lane")
        del s
    del k16

    def timed(fn, pivots):
        states = iter([fresh() for _ in range(3)])
        return cuda_ms(lambda: fn(A, c, apen, 1 << 20, next(states),
                                  seg_len=pivots, **kw), 3)

    ms1 = timed(ssk.solve_segment_stream, 1)
    ms64 = timed(ssk.solve_segment_stream, SEGMENT_PIVOTS)
    plain1 = timed(ssk.solve_segment_stream_plain, 1)
    b_ms, b_by = segment_bound_ms(b, pivoted, m, n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms_iter = (ms64 - ms1) / (SEGMENT_PIVOTS - 1)
    return {"shape": [b, m, n], "mode": mode, "factor_blocked": not dual,
            "packed": kw["packed"],
            "plan": plan._asdict(),
            "resident_clusters": _build.library()
            .lp_solve_segment_stream_max_clusters(
                plan.cluster, int(plan.aligned), plan.smem_bytes),
            "ctas": b * plan.cluster, "sms": sms,
            "same_bits_at_clusters": [p.cluster for p in others],
            "one_iter": {"excluded_tie_lanes": int((~keep).sum()),
                         "pivoted_lanes": pivoted, "max_abs_err_bfs": err1,
                         "ms": ms1, "plain_ms": plain1, "reps": 3},
            "segment16": {"lanes_in_lockstep": int(same.sum()),
                          "max_abs_err_bfs": err16, "bfs_scale": scale,
                          "tol": "1e-4 of scale"},
            "segment": {"pivots": SEGMENT_PIVOTS, "ms": ms64,
                        "ms_per_iter": ms_iter},
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share_in_segment": b_ms / ms_iter}


def phase_stream_m4096():
    """Phase 14: kernel 3 at B = 4, (4096, 8192), primal (blocked) and
    dual (unblocked), against its plain version."""
    cfg, _ = lt.exact_cleanup_config(XLM)
    out = {"phase": "stream_m4096",
           "config": {"pricing": cfg.pricing, "stall_limit": cfg.stall_limit},
           "runs": []}
    for dual in (False, True):
        A, c, apen, _, state0 = _segment_instance(dual, XLB, XLM, XLM,
                                                  SEED + 14)
        out["runs"].append(_hold_stream_lockstep(A, c, apen, state0, cfg,
                                                 dual))
        del A, c, apen, state0
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase_exact_m4096():
    """Phase 15: solve_batch_exact at B = 4, m = n = 4096 (the reference's
    exact_m4096 leg: one warm-up run, one timed run)."""
    import linprog_tpu_torch.batch as lb
    import linprog_tpu_torch.crossover as lx
    import linprog_tpu_torch.engine_batched as le
    import linprog_tpu_torch.ipm as li
    import linprog_tpu_torch.refine as lr
    from linprog_tpu_torch import router

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, XLB, XLM, XLM, DEVICE)
    _, warm = _walled(lambda: lt.solve_batch_exact(c, G, h))

    # every exact-pipeline call's crossed mask (the first pass, the retry)
    masks, pipeline = [], lx.ipm_crossover_batch_canonical

    def keep_mask(*args, **kw):
        res, crossed = pipeline(*args, **kw)
        masks.append(crossed.clone())
        return res, crossed

    def stream_label(A, *args, **kw):
        return (f"B={A.shape[0]} {'dual' if kw['dual'] else 'primal'}"
                f"{' blocked' if kw['factor_blocked'] else ''} "
                f"cluster={ssk.last_plan.cluster}")

    lx.ipm_crossover_batch_canonical = keep_mask
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _stage_spans([
                ("pipeline", lx, "ipm_crossover_batch_canonical", None),
                ("ipm", li, "ipm_canonical_state", None),
                ("normal_factor", li, "_normal_factor", None),
                ("phase", lx, "_run_chunked", lambda *a, **k: a[7]),
                ("crossover_inverse", lx, "inv_or_nan", None),
                ("refactorize", le, "refresh_running_lanes", None),
                ("terminal_solve_dd", lx, "solve_dd", None),
                ("polish", lr, "polish_batch", None),
                ("fallback_two_phase", lb, "solve_batch_two_phase", None),
                ("stream_kernel", le, "solve_segment_stream", stream_label),
        ]) as spans:
            (res, info), wall = _walled(lambda: lt.solve_batch_exact(c, G, h))
    finally:
        lx.ipm_crossover_batch_canonical = pipeline
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    stages, by_label, pipeline_s = {}, {}, []
    for name, label, t_a, t_b in spans:
        sec = t_a.elapsed_time(t_b) / 1e3
        key = f"{label}_phase" if name == "phase" else name
        entry = stages.setdefault(key, {"calls": 0, "seconds": 0.0})
        entry["calls"] += 1
        entry["seconds"] += sec
        if name == "pipeline":
            pipeline_s.append(sec)
        if name == "stream_kernel":
            entry = by_label.setdefault(label, {"launches": 0, "seconds": 0.0})
            entry["launches"] += 1
            entry["seconds"] += sec

    # the lanes reported crossed: the first pass's, then the retry's (its
    # bucket is the uncrossed lanes with cyclic fill, as the router builds it)
    crossed = masks[0].clone()
    if len(masks) > 1:
        bad = torch.nonzero(~masks[0], as_tuple=True)[0]
        idx = router._bucket(bad, XLB)
        crossed[idx[masks[1]]] = True

    (cert, cert_wall) = _walled(lambda: lt.certify_vertex_batch(c, G, h,
                                                                res.basis))
    summ = lt.certificate_summary(cert)
    out = {
        "phase": "exact_m4096", "lanes": XLB, "m": XLM, "n": XLM,
        "seed": SEED, "lane_status": status_counts(res.status),
        "crossed": info["crossed"], "retry_crossed": info["retry_crossed"],
        "uncrossed": info.get("uncrossed", 0), "fallback": info["fallback"],
        "crossed_lanes": torch.nonzero(crossed).flatten().tolist(),
        "certified": summ["certified"], "certificate": summ,
        "cert_wall_s": cert_wall, "wall_s": wall, "warmup_wall_s": warm,
        "lps_per_sec": XLB / wall, "iters": res.iters.tolist(),
        "launches": launches, "stages_s": stages,
        "pipeline_calls_s": pipeline_s,
        "panels_per_normal_factor": (
            launches["panel_cholinv"]
            / max(1, stages.get("normal_factor", {}).get("calls", 0))),
        "stream_kernel_by_launch": by_label, "peak_mem_gb": peak_gb,
    }
    emit(out)
    if res.x.shape != (XLB, XLM):
        fail(f"m = 4096 path: result has shape {tuple(res.x.shape)}")
    if int(crossed.sum()) != info["crossed"]:
        fail(f"m = 4096 path: {int(crossed.sum())} crossed masks against "
             f"{info['crossed']} reported")
    if not bool(cert["certified"][crossed].all()):
        fail("m = 4096 path: a lane reported crossed is not certified")
    if not torch.isfinite(res.cost[crossed]).all():
        fail("m = 4096 path: a crossed lane has a non-finite cost")
    if bool((res.status == st.NUMERICAL_ERROR).any()):
        fail(f"m = 4096 path: NUMERICAL_ERROR lanes "
             f"{status_counts(res.status)}")
    if info["fallback"] or "fallback_two_phase" in stages:
        fail("m = 4096 path: the two-phase fallback ran")
    if launches["solve_segment_stream_dual"] <= 0:
        fail("m = 4096 path: kernel 3 never ran in dual mode")
    for name in ("solve_segment_stream", "panel_cholinv"):
        if launches[name] <= 0:
            fail(f"m = 4096 path: kernel {name} was never launched")
    return launches


def phase_bounded_block():
    """Phase 16: kernel 4's streaming branch (which replaced the block per
    lane past the largest cluster) at [16, 1280, 2560] against its plain
    version, then solve_batch_bounded there with phase 8's settings and
    guards."""
    cfg = tuned_config(BBM)
    prob, _, _, state0 = _bounded_start(SEED + 16, BBB, BBM, BBM)
    c, A, b, lb, ub = prob
    kw = dict(opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              packed=cfg.packed_select)
    # one iteration from the all-slack start: zero duals and an identity
    # factor, so every sum has one nonzero term: the same bits on every lane
    def fresh():
        return bk.BoundedSegmentState(*(t.clone() for t in state0))

    k1 = bk.solve_bounded_segment(A, c, lb, ub, 1 << 20, fresh(), seg_len=1,
                                  **kw)
    p1 = bk.solve_bounded_segment_plain(A, c, lb, ub, 1 << 20, fresh(),
                                        seg_len=1, **kw)
    torch.cuda.synchronize()
    if not isinstance(bk.last_plan, StreamingPlan):
        fail("bounded block: [16, 1280, 2560] took the "
             f"{_branch(bk.last_plan)} branch")
    for name, x, y in zip(k1._fields, k1, p1):
        if not same_bits(x, y):
            fail(f"bounded block: one iteration's {name} differs from plain")
    err1 = (k1.bfs - p1.bfs).abs().max().item()
    del k1, p1, state0
    hold = [_hold_bounded(BBB, BBM, BBM, packed, block=True)
            for packed in (True, False)]

    pcfg = tuned_config(BBM, pricing="dantzig", polish_pivots=8,
                        refactor_every=2048)
    prob, basis, vs, _ = _bounded_start(SEED, BBB, BBM, BBM)
    c, A, b, lb, ub = prob

    def solve():
        return lt.solve_batch_bounded(c, A, b, lb, ub, basis, vs,
                                      BLOCK_BOUNDED_MAXITERS, pcfg)

    # one run, no warm-up (tens of thousands of iterations a lane: kernel
    # 4 and the batched LU ran at other shapes in phases 7 and 8)
    _reset_counts()
    res, wall = _walled(solve)
    launches = _read_counts()
    bounds = torch.stack([lb, ub], dim=2)
    gap = highs_gap(res.cost, c, 2, A_eq=A, b_eq=b, bounds=bounds)
    viol_abs, viol_rel = _bound_violation(prob, res.x)
    x = res.x.double()
    scale = b.abs().max(dim=1).values.double().clamp_min(1.0)
    resid = (torch.einsum("bmn,bn->bm", A.double(), x) - b.double()).abs()
    resid_rel = (resid.max(dim=1).values / scale).max().item()
    seg_bound, seg_by = segment_bound_ms(BBB, BBB, BBM, 2 * BBM)
    out = {"phase": "bounded_block", "shape": [BBB, BBM, 2 * BBM],
           "one_iter_from_start": {"bit_for_bit": True,
                                   "max_abs_err_bfs": err1},
           "streaming": {"plan": hold[0]["plan"],
                         "resident_clusters": hold[0]["resident_clusters"],
                         "segment_ms_per_iter": {
                             r["mode"]: r["segment"]["ms_per_iter"]
                             for r in hold},
                         "bound_ms": seg_bound, "bound_by": seg_by,
                         "replaced_block_ms_per_iter": REPLACED_BLOCK_MS},
           "kernel": hold,
           "path": {"lanes": BBB, "m": BBM, "n": BBM, "seed": SEED,
                    "config": {"pricing": pcfg.pricing,
                               "packed": pcfg.packed_select,
                               "refactor_every": pcfg.refactor_every,
                               "polish_pivots": pcfg.polish_pivots,
                               "maxiters": BLOCK_BOUNDED_MAXITERS},
                    "lane_status": status_counts(res.status),
                    "wall_s": wall, "lps_per_sec": BBB / wall,
                    "launches": launches,
                    "iters_max": int(res.iters.max()),
                    "iters_mean": float(res.iters.float().mean()),
                    "highs_lanes": 2, "max_rel_gap_vs_highs": gap,
                    "max_bound_violation": viol_abs,
                    "max_rel_bound_violation": viol_rel,
                    "tol_rel_bound": 1e-4,
                    "max_rel_residual": resid_rel, "tol_residual": 1e-4}}
    emit(out)
    n_opt = int((res.status == st.OPTIMAL).sum())
    if n_opt != BBB or not torch.isfinite(res.cost).all():
        fail(f"bounded block path: {n_opt}/{BBB} lanes OPTIMAL")
    if not gap <= 1e-5:
        fail(f"bounded block path: HiGHS gap {gap:.3e} > 1e-5")
    if not viol_rel <= 1e-4:
        fail(f"bounded block path: x leaves its bounds by {viol_rel:.3e} of "
             "scale (> 1e-4)")
    if not resid_rel <= 1e-4:
        fail(f"bounded block path: |Ax - b| = {resid_rel:.3e} of scale "
             "(> 1e-4)")
    if launches["solve_bounded_segment"] <= 0:
        fail("bounded block path: kernel solve_bounded_segment was never "
             "launched")
    return out


# ---------------------------------------------------------------------------
# Phase 19: the general-form surface
# ---------------------------------------------------------------------------

# the SAS diet LP (examples/diet.py) and its published optimum
DIET = dict(
    c=np.array([2.0, 3.5, 8.0, 1.5, 11.0, 1.0]),
    G=np.array([[-0.90, -12, -10.6, -9.7, -13, -18],  # calories >= 30
                [4.0, 8.0, 7.0, 1.3, 8.0, 9.2],  # protein <= 10
                [-15.0, -11.7, -0.4, -22.6, -0.0, -17.0],  # carbs >= 10
                [-1.0, -5.0, -9.0, -0.1, -7.0, -1.0]]),  # fat >= 8
    h=np.array([-30.0, 10.0, -10.0, -8.0]),
    lb=np.array([0.0, 0.0, 0.0, 0.0, 0.5, 0.0]),
    ub=np.array([np.inf, 1.0, np.inf, np.inf, np.inf, np.inf]))
DIET_COST = 12.081337630748749
DIET_X = np.array([0.0, 0.05359876, 0.44949877, 1.86516786, 0.5, 0.0])
# Papadimitriou & Steiglitz pg. 57 and its published Bland path
BLAND = dict(c=np.array([1.0, 1, 1, 0, 0, 0, 0, 0]),
             A=np.array([[1.0, 0, 0, 3, 2, 1, 0, 0],
                         [0.0, 1, 0, 5, 1, 1, 1, 0],
                         [0.0, 0, 1, 2, 5, 1, 0, 1]]),
             b=np.array([1.0, 3, 4]))
BLAND_PATH = [[0, 1, 2], [3, 1, 2], [4, 1, 2], [4, 6, 2], [4, 6, 7]]
# the primal-dual textbook problems: Bazaraa ex. 6.8, Luenberger & Ye pg.
# 96, and a negative-cost instance (the bounding row's dual start)
PD_PROBLEMS = [
    (np.array([3.0, 4, 6, 7, 5, 0, 0]),
     np.array([[2.0, -1, 1, 6, -5, -1, 0], [1.0, 1, 2, 1, 2, 0, -1]]),
     np.array([6.0, 3])),
    (np.array([2.0, 1, 4]), np.array([[1.0, 1, 2], [2.0, 1, 3]]),
     np.array([3.0, 5])),
    (np.array([-2.0, 1, -1, 0, 0]),
     np.array([[1.0, 1, 1, 1, 0], [-1.0, 2, 0, 0, 1]]), np.array([6.0, 4])),
]
# 19b: lanes cycle through the families of structured.py (lane k: family
# k % 11, seed k), scaled so the padded common shape reaches m = 240
GF_FAMILIES = [
    ("transportation", (10, 30)), ("assignment", (16,)),
    ("production_planning", (96,)), ("blending", (120, 64)),
    ("min_cost_flow_grid", (8, 10)), ("chebyshev_center", (200, 24)),
    ("set_covering", (160, 80)), ("staff_scheduling", (200, 7)),
    ("multicommodity_flow_grid", (6, 8)),
    ("knapsack_relaxation", (160, 40)), ("sas_diet", ()),
]
GB, GREPEATS, GITERS = 1024, 5, 3000  # 19b: lanes, timed runs, pivot cap
TB, TNS, TND = 1024, 32, 32  # 19b: transportation_lps lanes, supplies, demands
PDB = 256  # 19c: primal-dual lanes
IPM_M, IPM_EQ = 512, 64  # 19d: inequality rows (m = n), equality rows


def _suite_config():
    """The reference suite's setting (tests/test_structured_suite.py):
    dantzig, a refactorization every 64 pivots."""
    return lt.SolverConfig(pricing="dantzig", refactor_every=64)


def _highs_general(p):
    """HiGHS's optimum of a general-form instance dict (``c, A, b, G, h,
    lb, ub``; None entries allowed); ``(status, objective)``."""
    from scipy.optimize import linprog

    n = p["c"].shape[0]
    lb = np.zeros(n) if p.get("lb") is None else p["lb"]
    ub = np.full(n, np.inf) if p.get("ub") is None else p["ub"]
    r = linprog(p["c"], A_eq=p.get("A"), b_eq=p.get("b"), A_ub=p.get("G"),
                b_ub=p.get("h"), method="highs",
                bounds=list(zip([None if np.isneginf(v) else v for v in lb],
                                [None if np.isposinf(v) else v for v in ub])))
    return r.status, r.fun


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def _general_single():
    """19a: single instances on the card (the per-lane engines at a batch
    of one)."""
    from linprog_tpu_torch.structured import default_suite

    t0 = time.time()
    diet = lt.SimplexSolver(**DIET, device=DEVICE).solve()
    diet_s = time.time() - t0
    diet_err = abs(diet.cost - DIET_COST) / DIET_COST
    diet_x = float(np.abs(diet.x - DIET_X).max())

    t0 = time.time()
    s = lt.PrimalRevisedSimplexSolver(**BLAND, basis=BLAND_PATH[0],
                                      device=DEVICE)
    path = [s.basis.tolist()]
    for _ in BLAND_PATH[1:]:
        path.append(s.solve(maxiters=1).basis.tolist())
    bland_s = time.time() - t0

    suite, gaps, secs, iters = default_suite(), [], [], []
    for p in suite:
        t1 = time.time()
        res = lt.SimplexSolver(p["c"], A=p["A"], b=p["b"], G=p["G"],
                               h=p["h"], lb=p["lb"], ub=p["ub"],
                               config=_suite_config(),
                               device=DEVICE).solve(3000, 3000)
        secs.append(time.time() - t1)
        iters.append(res.iters)
        code, fun = _highs_general(p)
        if code != 0:
            fail(f"general form: HiGHS did not solve {p['name']}")
        gaps.append(_rel(res.cost, fun) if res.optimum else float("inf"))
    out = {"diet": {"cost": diet.cost, "rel_err": diet_err,
                    "max_abs_err_x": diet_x, "iters": diet.iters,
                    "wall_s": diet_s},
           "bland_path": {"bases": path, "wall_s": bland_s},
           "suite": {"instances": len(suite), "max_rel_gap_vs_highs":
                     max(gaps), "wall_s": sum(secs), "iters": iters,
                     "gaps": dict(zip([p["name"] for p in suite], gaps))}}
    emit({"phase": "general_form_single", **out})
    if not diet.optimum or not diet_err <= 1e-6 or not diet_x <= 1e-4:
        fail(f"general form: diet cost {diet.cost!r} (rel {diet_err:.2e}), "
             f"x off by {diet_x:.2e}")
    if path != BLAND_PATH:
        fail(f"general form: Bland path {path} != {BLAND_PATH}")
    if not max(gaps) <= 1e-5:
        fail(f"general form: suite gap {max(gaps):.3e} > 1e-5")


def _general_problems(lanes):
    """19b's batch: each instance brought to standard form by
    SimplexSolver's constructor (free variables, lower-bound shifts) with
    its bounds as rows (forms.bounds_to_rows, as
    benchmarks/structured_pricing.py does); the solvers map x back."""
    from linprog_tpu_torch import structured

    problems, solvers, originals = [], [], []
    for k in range(lanes):
        name, args = GF_FAMILIES[k % len(GF_FAMILIES)]
        build = getattr(structured, name)
        p = build(*args, seed=k) if args else build()
        s = lt.SimplexSolver(p["c"], A=p["A"], b=p["b"], G=p["G"], h=p["h"],
                             lb=p["lb"], ub=p["ub"], device=DEVICE)
        c1, A1, b1 = lt.forms.bounds_to_rows(s.c, s.A, s.b, s.lb, s.ub)
        problems.append({"c": c1, "A": A1, "b": b1})
        solvers.append(s)
        originals.append(p)
    return problems, solvers, originals


def _general_costs(results, solvers, originals):
    """Each lane's objective in its original variables."""
    return [float(p["c"] @ s._reconstruct_x(r.x[: s.n_aug]))
            for r, s, p in zip(results, solvers, originals)]


def _residual(p, x):
    """``max|Ax - b| / (1 + max|b|)`` of a standard-form lane, and how far
    x falls below 0 (the larger)."""
    r = np.abs(p["A"] @ x - p["b"]).max() / (1.0 + np.abs(p["b"]).max())
    return float(max(r, -x.min()))


def _general_batch():
    """19b: solve_batch_general at B = 1024 (dantzig and devex, the
    default config once), with presolve and two planted lanes, then
    transportation_lps through solve_batch_two_phase."""
    import linprog_tpu_torch.batch as lb
    import linprog_tpu_torch.engine_batched as le
    from linprog_tpu_torch.batch import solve_batch_general
    from linprog_tpu_torch.generators import transportation_lps

    t0 = time.time()
    problems, solvers, originals = _general_problems(GB)
    m_pad = max(p["A"].shape[0] for p in problems)
    n_pad = max(p["A"].shape[1] for p in problems) + m_pad
    build_s = time.time() - t0
    oracle = [_highs_general(p) for p in originals[:16]]
    if any(code != 0 for code, _ in oracle):
        fail("general batch: HiGHS did not solve a lane")

    runs, paths, costs_by, statuses, firsts = {}, {}, {}, {}, {}
    for label, cfg in (("general_batch", _suite_config()),
                       ("general_batch_devex",
                        _suite_config().replace(pricing="devex"))):
        def run():
            return solve_batch_general(problems, GITERS, GITERS, cfg,
                                       device=DEVICE)

        _, warm = _walled(run)
        _reset_counts()
        # CUDA-event spans of the device stages inside the first timed run
        with _stage_spans([
                ("two_phase", lb, "solve_batch_two_phase", None),
                ("segment_kernel", le, "solve_segment", None),
                ("refactorize", le, "refresh_running_lanes", None),
        ]) as spans:
            first, wall0 = _walled(run)
        paths[label] = _read_counts()
        stage_s = {}
        for name, _, t_a, t_b in spans:
            stage_s[name] = stage_s.get(name, 0.0) + t_a.elapsed_time(
                t_b) / 1e3
        plan = sk.last_plan._asdict() if sk.last_plan else None
        walls = [wall0] + [_walled(run)[1] for _ in range(GREPEATS - 1)]
        wall = float(np.median(walls))
        status = np.array([r.status for r in first])
        iters = np.array([r.iters for r in first])
        costs = _general_costs(first, solvers, originals)
        gap = max(_rel(costs[i], oracle[i][1]) for i in range(16))
        runs[label] = {"wall_s": wall, "walls_s": walls,
                       "warmup_wall_s": warm, "lps_per_sec": GB / wall,
                       "lane_status": {st.status_name(k): int(v) for k, v in
                                       zip(*np.unique(status,
                                                      return_counts=True))},
                       "total_pivots": int(iters.sum()),
                       "max_pivots": int(iters.max()),
                       "highs_lanes": 16, "max_rel_gap_vs_highs": gap,
                       "plan": plan, "launches": paths[label],
                       "stage_s_first_run": stage_s,
                       "first_run_wall_s": wall0}
        costs_by[label] = costs
        statuses[label] = status
        firsts[label] = first

    # a lane that is not OPTIMAL must be one HiGHS finds infeasible too,
    # reported PRIMAL_INFEASIBLE (T = 96 periods of production_planning
    # can outrun the capacity)
    verdicts = {}

    def check_lanes(status, results):
        lanes = [int(k) for k in np.flatnonzero(status != st.OPTIMAL)]
        for k in lanes:
            if k not in verdicts:
                verdicts[k] = _highs_general(originals[k])[0]
        resid = max((_residual(problems[k], results[k].x) for k in range(GB)
                     if status[k] == st.OPTIMAL), default=0.0)
        return {"not_optimal": [[k, GF_FAMILIES[k % len(GF_FAMILIES)][0],
                                 st.status_name(status[k]), verdicts[k]]
                                for k in lanes],
                "max_rel_residual_of_optimal": resid}

    # the package's default config (bland, no refactorization) once, as
    # a reading: no guard
    dflt, dwall = _walled(lambda: solve_batch_general(
        problems, GITERS, GITERS, lt.DEFAULT_CONFIG, device=DEVICE))
    dstatus = np.array([r.status for r in dflt])
    dcosts = _general_costs(dflt, solvers, originals)
    default = {"wall_s": dwall, "lane_status": {
        st.status_name(k): int(v) for k, v in
        zip(*np.unique(dstatus, return_counts=True))},
        "max_pivots": int(max(r.iters for r in dflt)),
        "max_rel_gap_vs_highs_16": max(
            _rel(dcosts[i], oracle[i][1]) for i in range(16))}

    # presolve on the same batch, with a lane it finds infeasible and one
    # it fixes completely
    planted = [{"c": np.ones(2), "A": np.array([[1.0, 0.0], [1.0, 0.0]]),
                "b": np.array([1.0, 2.0])},
               {"c": np.array([1.0, 2.0]),
                "A": np.array([[2.0, 0.0], [0.0, 1.0]]),
                "b": np.array([4.0, 3.0])}]
    pres, pwall = _walled(lambda: solve_batch_general(
        problems + planted, GITERS, GITERS, _suite_config(), presolve=True,
        device=DEVICE))
    pcosts = _general_costs(pres[:GB], solvers, originals)
    pstatus = np.array([r.status for r in pres[:GB]])
    both_opt = (pstatus == st.OPTIMAL) & (statuses["general_batch"]
                                          == st.OPTIMAL)
    pshift = max(_rel(pcosts[k], costs_by["general_batch"][k])
                 for k in np.flatnonzero(both_opt))
    presolve = {"wall_s": pwall, "max_rel_cost_shift": pshift,
                "lane_status": {st.status_name(k): int(v) for k, v in
                                zip(*np.unique(pstatus,
                                               return_counts=True))},
                "planted": [st.status_name(r.status) for r in pres[GB:]],
                "fixed_lane_iters": pres[GB + 1].iters,
                **check_lanes(pstatus, pres)}
    for label in runs:
        runs[label].update(check_lanes(statuses[label], firsts[label]))

    # transportation_lps: m = 64, n = 1024, one redundant row a lane
    c, A, b = (torch.as_tensor(a, device=DEVICE)
               for a in transportation_lps(TB, TNS, TND, seed=SEED))

    def transport():
        return lt.solve_batch_two_phase(c, A, b, GITERS, GITERS,
                                        _suite_config())

    _, twarm = _walled(transport)
    _reset_counts()
    tres, twall = _walled(transport)
    tlaunch = _read_counts()
    tgap = highs_gap(tres.cost, c, 4, A_eq=A, b_eq=b)
    transport_out = {"lanes": TB, "m": TNS + TND, "n": TNS * TND,
                     "wall_s": twall, "warmup_wall_s": twarm,
                     "lane_status": status_counts(tres.status),
                     "max_pivots": int(tres.iters.max()),
                     "highs_lanes": 4, "max_rel_gap_vs_highs": tgap,
                     "launches": tlaunch}

    emit({"phase": "general_form_batch", "lanes": GB, "m_pad": m_pad,
          "n_pad": n_pad, "families": [f for f, _ in GF_FAMILIES],
          "build_s": build_s, **runs, "default_config": default,
          "presolve": presolve, "transportation": transport_out})
    for label, rep in [*runs.items(), ("presolve", presolve)]:
        wrong = [lane for lane in rep["not_optimal"]
                 if lane[2] != "PRIMAL_INFEASIBLE" or lane[3] != 2]
        # devex on kernel 1 can pivot a degenerate 0/1 lane onto an
        # exactly singular basis, which the refactorization reports as
        # NUMERICAL_ERROR (ROADMAP Queue 3; the per-step loop's devex does
        # it too): a status, never a wrong answer, on at most 1 % of lanes
        broken = [lane for lane in wrong if label.endswith("devex")
                  and lane[2] == "NUMERICAL_ERROR"]
        if len(broken) > GB // 100 or len(wrong) > len(broken):
            fail(f"{label}: lanes not OPTIMAL that HiGHS does not find "
                 f"infeasible: {wrong}")
        if not rep["max_rel_residual_of_optimal"] <= 1e-4:
            fail(f"{label}: an OPTIMAL lane leaves Ax = b by "
                 f"{rep['max_rel_residual_of_optimal']:.3e} of scale")
    for label, rep in runs.items():
        if not rep["max_rel_gap_vs_highs"] <= 1e-5:
            fail(f"{label}: HiGHS gap {rep['max_rel_gap_vs_highs']:.3e}")
        if paths[label]["solve_segment"] + paths[label][
                "solve_segment_stream"] <= 0:
            fail(f"{label}: no segment kernel was launched")
    if presolve["not_optimal"] != runs["general_batch"]["not_optimal"]:
        fail("general batch presolve: other lanes than without presolve "
             "are not OPTIMAL")
    if (pres[GB].status != st.PRIMAL_INFEASIBLE or not pres[GB + 1].optimum
            or pres[GB + 1].iters != 0
            or not np.allclose(pres[GB + 1].x, [2.0, 3.0])):
        fail(f"general batch presolve: planted lanes {presolve['planted']}")
    if not pshift <= 1e-5:
        fail(f"general batch presolve: costs moved by {pshift:.3e}")
    if int((tres.status == st.OPTIMAL).sum()) != TB:
        fail(f"transportation: {transport_out['lane_status']}")
    if not tgap <= 1e-5:
        fail(f"transportation: HiGHS gap {tgap:.3e} > 1e-5")
    return paths


def _pd_batch():
    """19c: solve_primal_dual_batch on PDB lanes of the textbook problems
    (padded, tiled, costs scaled by a seeded 1 + 0.01 N(0, 1))."""
    from linprog_tpu_torch.primal_dual import solve_primal_dual_batch

    m_pad = max(A.shape[0] for _, A, _ in PD_PROBLEMS)
    n_pad = max(A.shape[1] for _, A, _ in PD_PROBLEMS) + m_pad
    padded = [lt.forms.pad_problem(*lt.forms.preprocess_problem(c, A, b),
                                   m_pad, n_pad)[:3]
              for c, A, b in PD_PROBLEMS]
    k = len(PD_PROBLEMS)
    c, A, b = (np.stack([padded[i % k][j] for i in range(PDB)])
               for j in range(3))
    rng = np.random.default_rng(SEED + 19)
    c = (c * (1.0 + 0.01 * rng.standard_normal(c.shape))).astype(np.float32)
    ct, At, bt = (torch.as_tensor(a, device=DEVICE) for a in (c, A, b))

    def run():
        return solve_primal_dual_batch(ct, At, bt, 100, 100)

    _, warm = _walled(run)
    walls = []
    for _ in range(3):
        out, w = _walled(run)
        walls.append(w)
    x, cost, counter, status, _ = out
    gap = highs_gap(cost, ct, 4, A_eq=At, b_eq=bt)
    rep = {"lanes": PDB, "m": m_pad, "n": n_pad,
           "wall_s": float(np.median(walls)), "walls_s": walls,
           "warmup_wall_s": warm, "lane_status": status_counts(status),
           "outer_iters_max": int(counter.max()),
           "highs_lanes": 4, "max_rel_gap_vs_highs": gap}
    emit({"phase": "general_form_primal_dual", **rep})
    if int((status == st.OPTIMAL).sum()) != PDB:
        fail(f"primal-dual batch: {rep['lane_status']}")
    if not gap <= 1e-5:
        fail(f"primal-dual batch: HiGHS gap {gap:.3e} > 1e-5")


def _ipm_instance():
    """19d's instance: G, h of random_inequality_lps(1, 512, 512), IPM_EQ
    equality rows through its feasible point x0 and finite upper bounds
    above x0 on a quarter of the variables."""
    from linprog_tpu_torch.generators import random_inequality_lps

    seed = SEED + 19
    c, G, h = random_inequality_lps(1, IPM_M, IPM_M, seed=seed)
    rng = np.random.default_rng(seed)  # the generator's own draws, again
    rng.standard_normal(size=(1, IPM_M, IPM_M), dtype=np.float32)
    x0 = rng.random(size=(1, IPM_M), dtype=np.float32)[0]
    r2 = np.random.default_rng(seed + 1)
    A = r2.standard_normal((IPM_EQ, IPM_M)).astype(np.float32)
    ub = np.full(IPM_M, np.inf, np.float32)
    idx = r2.permutation(IPM_M)[: IPM_M // 4]
    ub[idx] = x0[idx] + r2.uniform(0.5, 1.5, idx.size).astype(np.float32)
    h2 = h[0] * (1.0 + 0.02 * r2.standard_normal(IPM_M)).astype(np.float32)
    return dict(c=c[0], A=A, b=A @ x0, G=G[0], h=h[0], ub=ub), h2


def _ipm_solver(job):
    """19d: IPMSolver on the card (kernel 2 in every Newton step), then a
    warm resolve of perturbed h against a cold solve; ``job`` is HiGHS on
    the instance, running in a worker process meanwhile."""
    p, h2 = _ipm_instance()
    _, warm_up = _walled(lambda: lt.IPMSolver(**p, device=DEVICE).solve())
    solver = lt.IPMSolver(**p, device=DEVICE)
    _reset_counts()
    res, wall = _walled(solver.solve)
    launches = _read_counts()
    warm, warm_s = _walled(lambda: solver.resolve(h=h2))
    cold, cold_s = _walled(
        lambda: lt.IPMSolver(**dict(p, h=h2), device=DEVICE).solve())
    code, fun = job.result()
    gap = _rel(res.cost, fun)
    wc = _rel(warm.cost, cold.cost)
    rows = IPM_EQ + IPM_M + int(np.isfinite(p["ub"]).sum())
    rep = {"m_std": rows, "n_std": IPM_M + rows - IPM_EQ,
           "status": st.status_name(res.status), "newton_steps": res.iters,
           "wall_s": wall, "warmup_wall_s": warm_up, "cost": res.cost,
           "highs": fun, "rel_gap_vs_highs": gap,
           "duals": int(res.y.shape[0]), "launches": launches,
           "resolve": {"warm_status": st.status_name(warm.status),
                       "warm_steps": warm.iters, "warm_s": warm_s,
                       "cold_status": st.status_name(cold.status),
                       "cold_steps": cold.iters, "cold_s": cold_s,
                       "rel_cost_diff": wc}}
    emit({"phase": "general_form_ipm_solver", **rep})
    if code != 0:
        fail("IPMSolver: HiGHS did not solve the instance")
    if not res.optimum or not gap <= 1e-3:
        fail(f"IPMSolver: {rep['status']}, HiGHS gap {gap:.3e} (> 1e-3?)")
    if res.y.shape[0] != rows:
        fail(f"IPMSolver: {res.y.shape[0]} duals for {rows} rows")
    if launches["panel_cholinv"] <= 0:
        fail("IPMSolver: kernel panel_cholinv was never launched")
    # the warm start saves no step on this instance (9 against 9 on an
    # NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6): it must not cost
    # one
    if not (warm.optimum and cold.optimum and warm.iters <= cold.iters
            and wc <= 5e-3):
        fail(f"IPMSolver resolve: {rep['resolve']}")
    return launches


def _interval_errors(got, want, cs, h):
    """Per field of two RangingResults over the same lanes: the relative
    errors ``|got - want| / max(1, |want|)`` where both are finite, and the
    endpoints finite in one only, split by whether the finite one lies
    beyond 1e4 of the data's scale (an unbounded direction read from
    rounding noise) or nearer."""
    out = {}
    for name, g, w in zip(want._fields, got, want):
        g = g.double().cpu()
        value = (cs if name.startswith("cost") else h).double().cpu()
        fin = torch.isfinite(w)
        differ = torch.isfinite(g) != fin
        finite = torch.where(fin, w, g)
        far = (finite - value).abs() > 1e4 * value.abs().clamp_min(1.0)
        both = fin & torch.isfinite(g)
        err = ((g - w).abs() / w.abs().clamp_min(1.0))[both]
        out[name] = {"errors": err, "far": int((differ & far).sum()),
                     "near": int((differ & ~far).sum())}
    return out


def _ranging_m256():
    """19e: ranging_batch at phase 4's exact bases (B = 1024, m = n = 256;
    the exact pipeline runs again if phase 4 did not), in f32 and in
    float64 on the card, each against a float64 host ranging of the same
    bases on 4 lanes."""
    from linprog_tpu_torch.engine import make_state

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, B, M, N, DEVICE)
    basis = MAIN_PATH.get("basis")
    if basis is None:
        basis = lt.solve_batch_exact(c, G, h)[0].basis
    eye = torch.eye(M, device=DEVICE).expand(B, M, M)
    A = torch.cat([G, eye], dim=2)
    cs = torch.cat([c, torch.zeros((B, M), device=DEVICE)], dim=1)
    ok = ((basis >= 0) & (basis < N + M)).all(dim=1)
    basis = torch.where(ok[:, None], basis, torch.arange(
        N, N + M, dtype=basis.dtype, device=DEVICE))
    lanes = [i for i in range(B) if bool(ok[i])][:4]
    idx = torch.tensor(lanes, device=DEVICE)
    A64, h64, c64 = (t[idx].double().cpu() for t in (A, h, cs))
    ref = lt.ranging_batch(c64, A64, h64,
                           make_state(A64, h64, basis[idx].cpu()))
    rep = {"lanes": B, "m": M, "n": N + M,
           "lanes_with_a_basis": int(ok.sum()),
           "from_phase4": "basis" in MAIN_PATH, "checked_lanes": lanes}
    for label, dt in (("f32", torch.float32), ("float64", torch.float64)):
        Ad, hd, cd = A.to(dt), h.to(dt), cs.to(dt)

        def run():
            return lt.ranging_batch(cd, Ad, hd, make_state(Ad, hd, basis))

        out = run()
        ms = cuda_ms(run, 5)
        stats = _interval_errors([t[idx] for t in out], ref, c64, h64)
        errs = torch.cat([v["errors"] for v in stats.values()])
        rep[label] = {
            "ms": ms, "max_rel_err_vs_host_float64": float(errs.max()),
            "quantiles_50_90_99": torch.quantile(errs, torch.tensor(
                [0.5, 0.9, 0.99], dtype=errs.dtype)).tolist(),
            "share_within_1e-3": float((errs <= 1e-3).double().mean()),
            "endpoints": int(errs.numel()),
            "finite_in_one_only_far_out": sum(v["far"]
                                              for v in stats.values()),
            "finite_in_one_only_near": sum(v["near"]
                                           for v in stats.values())}
    emit({"phase": "general_form_ranging", **rep})
    if int(ok.sum()) != B:
        fail(f"ranging: {B - int(ok.sum())} lanes without a basis")
    # the card's ranging in float64 must be the host's; f32 is a reading:
    # at m = 256 its basis inverse carries cond(B) times f32's rounding,
    # which a ratio over a small tableau entry amplifies (PERF.md section 6)
    f64 = rep["float64"]
    if (f64["finite_in_one_only_far_out"] or f64["finite_in_one_only_near"]
            or not f64["max_rel_err_vs_host_float64"] <= 1e-9):
        fail(f"ranging: the card's float64 ranging is not the host's: {f64}")


def phase_general_form():
    """Phase 19: the general-form surface (19a single instances, 19b
    solve_batch_general and transportation_lps, 19c the primal-dual batch,
    19d IPMSolver, 19e ranging_batch); each leg prints its own report."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.time()
    p, _ = _ipm_instance()
    # HiGHS takes seconds on 19d's instance: a worker process solves it
    # while the card runs the legs before
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing
                               .get_context("spawn"))
    try:
        job = pool.submit(_highs_general, {k: np.asarray(v, np.float64)
                                           for k, v in p.items()})
        legs, secs = {}, {}
        for name, leg in (("single", _general_single),
                          ("batch", _general_batch),
                          ("primal_dual", _pd_batch),
                          ("ipm_solver", lambda: _ipm_solver(job)),
                          ("ranging", _ranging_m256)):
            t1 = time.time()
            legs[name] = leg()
            secs[name] = time.time() - t1
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    emit({"phase": "general_form", "seconds": time.time() - t0,
          "leg_seconds": secs})
    return {**legs["batch"], "ipm_solver": legs["ipm_solver"]}


# ---------------------------------------------------------------------------
# Phase 20: the parallel entry points and the last modules
# ---------------------------------------------------------------------------

PAR_MAXITERS = 4000  # 20a, 20b: the two-phase caps of phase 3d's run
DP_PROCS = 2  # 20b: processes sharing the one card over gloo
TP_M, TP_N = 1024, 2048  # 20c: one standard-form LP, slack basis
TP_MAXITERS = 20_000
RESUME_PDHG = (64, 256)  # 20d: PDHG lanes, m = n
SPAWN_TIMEOUT_S = 300


def _par_batch():
    """20a/20b's batch: the standard form of ``device_inequality_lps`` at
    B = 1024, m = n = 256, seed 0, made on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, B, M, N, DEVICE)
    return (c, G, h), device_standard_form_batch(c, G, h)


def _dp_worker(argv):
    """One rank of 20b (``chip_smoke.py --dp-worker RANK WORLD INIT OUT``):
    the sharded two-phase solve of ``_par_batch`` on this process's share
    of the card, over gloo; rank 0 saves the gathered result to OUT, every
    rank its wall and launches to OUT.<rank>.json."""
    from linprog_tpu_torch.parallel import (
        distributed,
        make_batch_mesh,
        sharded_two_phase_solve,
    )

    rank, world, init, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    distributed.initialize(init, world, rank, device="cuda", backend="gloo")
    try:
        _, (cs, As, bs) = _par_batch()
        mesh = make_batch_mesh()
        cfg = tuned_config(M)

        def solve():
            return sharded_two_phase_solve(mesh, cs, As, bs, PAR_MAXITERS,
                                           PAR_MAXITERS, cfg)

        _, first = _walled(solve)
        _reset_counts()
        res, wall = _walled(solve)
        launches = _read_counts()
        if rank == 0:
            torch.save({k: v.cpu() for k, v in res._asdict().items()}, out)
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump({"wall_s": wall, "first_call_s": first,
                       "launches": launches}, f)
    finally:
        distributed.shutdown()


def _spawn_dp_ranks(tmp):
    """Run 20b's ranks; (the gathered result, their reports, the
    command's wall)."""
    import os

    from linprog_tpu_torch.parallel.dryrun import rank_tails, spawn_ranks

    init = "file://" + os.path.join(tmp, "rendezvous")
    out = os.path.join(tmp, "dp.pt")
    t0 = time.time()
    ranks = spawn_ranks(
        [[sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
          str(DP_PROCS), init, out] for r in range(DP_PROCS)],
        SPAWN_TIMEOUT_S)
    if any(code for code, _ in ranks):
        fail(f"20b: a rank failed:\n{rank_tails(ranks)}")
    reports = []
    for r in range(DP_PROCS):
        with open(f"{out}.{r}.json") as f:
            reports.append(json.load(f))
    return torch.load(out), reports, time.time() - t0


def _random_standard_lp(rng, m, n):
    """The generator of ``tests/test_tensor_parallel.py``: ``[G | I]`` with
    the slack basis feasible."""
    G = rng.normal(size=(m, n - m))
    b = np.abs(G @ rng.uniform(0.5, 1.5, size=n - m)) + rng.uniform(
        0.5, 1.5, size=m)
    y0 = rng.uniform(0.0, 1.0, size=m)
    s = rng.uniform(0.1, 1.0, size=n - m)
    c = np.concatenate([s - G.T @ y0, np.zeros(m)])
    A = np.concatenate([G, np.eye(m)], axis=1)
    return c, A, b, np.arange(n - m, n)


def _phase_dp(mesh, batches):
    """20a: the sharded two-phase and IPM solves on one rank against the
    unsharded ones, bit for bit; walls in turns (unsharded, sharded,
    sharded, unsharded)."""
    from linprog_tpu_torch.parallel import (
        sharded_ipm_batch_canonical,
        sharded_two_phase_solve,
    )

    (c, G, h), (cs, As, bs) = batches
    cfg = tuned_config(M)
    runs = {
        "two_phase": (
            lambda: lt.solve_batch_two_phase(cs, As, bs, PAR_MAXITERS,
                                             PAR_MAXITERS, cfg),
            lambda: sharded_two_phase_solve(mesh, cs, As, bs, PAR_MAXITERS,
                                            PAR_MAXITERS, cfg)),
        "ipm": (lambda: lt.ipm_solve_batch_canonical(c, G, h),
                lambda: sharded_ipm_batch_canonical(mesh, c, G, h)),
    }
    out, paths, results = {}, {}, {}
    for name, (plain, sharded) in runs.items():
        ref, w0 = _walled(plain)
        _, first = _walled(sharded)  # the first collective's set-up
        _reset_counts()
        res, w1 = _walled(sharded)
        paths[f"parallel_dp_{name}"] = _read_counts()
        _, w2 = _walled(sharded)
        _, w3 = _walled(plain)
        differ = [k for k, x, y in zip(res._fields, res, ref)
                  if (x is None) != (y is None)
                  or (x is not None and not same_bits(x, y))]
        out[name] = {"status": status_counts(res.status),
                     "unsharded_s": [w0, w3], "sharded_s": [w1, w2],
                     "sharded_first_call_s": first,
                     "fields_not_bit_equal": differ,
                     "launches": paths[f"parallel_dp_{name}"]}
        results[name] = (res, ref)
        if differ:
            fail(f"20a {name}: sharded differs from unsharded in {differ}")
    if not (paths["parallel_dp_two_phase"]["solve_segment"]
            and paths["parallel_dp_ipm"]["panel_cholinv"]):
        fail(f"20a: a kernel was not launched: {paths}")
    if out["two_phase"]["status"] != {"OPTIMAL": B}:
        fail(f"20a two-phase: {out['two_phase']['status']}")
    return out, paths, results["two_phase"][1]


def _phase_dp_procs(ref):
    """20b: two processes on the one card over gloo, 512 lanes each,
    against 20a's unsharded result."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        got, reports, wall = _spawn_dp_ranks(tmp)
    status = got["status"].to(DEVICE)
    cost = got["cost"].to(DEVICE)
    rel = ((cost.double() - ref.cost.double()).abs()
           / ref.cost.double().abs().clamp_min(1.0))
    same = ((got["x"].to(DEVICE).view(torch.int32)
             == ref.x.view(torch.int32)).all(dim=1)
            & (got["basis"].to(DEVICE) == ref.basis).all(dim=1)
            & (cost.view(torch.int32) == ref.cost.view(torch.int32)))
    out = {"procs": DP_PROCS, "backend": "gloo", "command_s": wall,
           "rank_walls_s": [r["wall_s"] for r in reports],
           "rank_first_call_s": [r["first_call_s"] for r in reports],
           "rank_launches": [r["launches"]["solve_segment"]
                             for r in reports],
           "status": status_counts(status),
           "statuses_equal": bool(torch.equal(status, ref.status)),
           "max_rel_cost_diff": float(rel.max()),
           "lanes_bit_identical": int(same.sum())}
    if not out["statuses_equal"] or out["max_rel_cost_diff"] > 1e-5:
        fail(f"20b: {out}")
    if not all(out["rank_launches"]):
        fail(f"20b: a rank did not launch kernel 1: {out['rank_launches']}")
    return out


def _phase_tp():
    """20c, timed: tp_solve on one rank (NCCL) of 20c's LP; returns its
    inputs, final state and wall."""
    from linprog_tpu_torch.parallel import make_model_mesh, tp_solve

    c, A, b, basis = (torch.as_tensor(a, device=DEVICE) for a in _tp_lp())
    cfg = lt.SolverConfig(pricing="dantzig")
    mesh = make_model_mesh()
    state, wall = _walled(lambda: tp_solve(c, A, b, basis, TP_MAXITERS, mesh,
                                           cfg))
    return (c, A, b, basis, cfg), state, wall


def _check_tp(tp, job):
    """20c, checked: the same status and basis as ``engine.run`` at B = 1
    with the same config, and the basis's vertex against HiGHS (``job``,
    a worker process)."""
    from linprog_tpu_torch.engine import make_state, run

    (c, A, b, basis, cfg), state, wall = tp
    allowed = torch.ones(TP_N, dtype=torch.bool, device=DEVICE)
    ref, ref_wall = _walled(lambda: run(
        c[None], A[None], b[None], make_state(A[None], b[None], basis[None]),
        allowed, TP_MAXITERS, cfg))
    pivots = int(state.iters)
    # the cost of the returned basis, its vertex solved in float64 on the
    # host, and the cost the state's own bfs gives
    Bm = A.double().cpu()[:, state.basis.long().cpu()]
    xB = torch.linalg.solve(Bm, b.double().cpu())
    vertex_cost = float(c.double().cpu()[state.basis.long().cpu()] @ xB)
    bfs_cost = float((c[state.basis.long()] * state.bfs).sum())
    highs_status, highs_cost = job.result()
    out = {"m": TP_M, "n": TP_N, "ranks": 1, "backend": "nccl",
           "status": st.status_name(int(state.status)), "pivots": pivots,
           "wall_s": wall, "ms_per_pivot": 1e3 * wall / max(pivots, 1),
           "engine_run_s": ref_wall, "engine_pivots": int(ref.iters[0]),
           "same_status": int(state.status) == int(ref.status[0]),
           "same_basis": bool(torch.equal(state.basis, ref.basis[0])),
           "highs_status": int(highs_status),
           "vertex_gap": _rel(vertex_cost, highs_cost),
           "bfs_gap": _rel(bfs_cost, highs_cost)}
    if not (out["same_status"] and out["same_basis"]
            and int(state.status) == st.OPTIMAL and highs_status == 0
            and out["vertex_gap"] <= 1e-5):
        fail(f"20c: {out}")
    return out


def _tp_lp():
    """20c's LP with ``c`` scaled to ``max |c| = 1``, so that the per-lane
    engine's tolerance (``opt_tol * max(1, max |c|)``) is tp_solve's
    absolute ``opt_tol``."""
    c, A, b, basis = _random_standard_lp(np.random.default_rng(SEED + 20),
                                         TP_M, TP_N)
    c = (c / np.abs(c).max()).astype(np.float32)
    return c, A.astype(np.float32), b.astype(np.float32), basis


def _highs_tp():
    c, A, b, _ = _tp_lp()
    return _highs_general({"c": c.astype(np.float64),
                           "A": A.astype(np.float64),
                           "b": b.astype(np.float64)})


def _phase_resume(tmp):
    """20d (i): a SimplexState (kernel 1, Phase I of the two-phase batch)
    and a PDHGState checkpointed mid-solve on the card, loaded, resumed:
    the same bits as the uninterrupted runs."""
    import os

    from linprog_tpu_torch import checkpoint, engine
    from linprog_tpu_torch.engine_batched import run_batched
    from linprog_tpu_torch.pdhg import PDHGConfig, PDHGState, _pdhg_core

    _, (cs, As, bs) = _par_batch()
    n = cs.shape[1]
    A1 = torch.cat([As, torch.eye(M, device=DEVICE).expand(B, M, M)], dim=2)
    c1 = torch.cat([torch.zeros(n, device=DEVICE),
                    torch.ones(M, device=DEVICE)]).expand(B, n + M)
    c1 = c1.contiguous()
    allowed = torch.ones(n + M, dtype=torch.bool, device=DEVICE)
    # cut at the end of the first segment, where many lanes still run
    cfg = tuned_config(M, refactor_every=128)
    cut = cfg.refactor_every

    def phase1(state, maxiters):
        return run_batched(c1, A1, bs, state, allowed, maxiters, cfg)

    def fresh():
        return engine.slack_crash_state(A1, bs, n)

    _reset_counts()
    full = phase1(fresh(), PAR_MAXITERS)
    mid = phase1(fresh(), cut)
    running_at_cut = int((mid.status == st.RUNNING).sum())
    path = os.path.join(tmp, "simplex.npz")
    checkpoint.save_state(path, mid)
    resumed = phase1(checkpoint.load_state(path, DEVICE), PAR_MAXITERS)
    launches = _read_counts()
    simplex_same = all(same_bits(x, y) for x, y in zip(full, resumed))

    lanes, m = RESUME_PDHG
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    c, G, h = device_inequality_lps(gen, lanes, m, m, DEVICE)
    lb = torch.zeros((lanes, m), device=DEVICE)
    ub = torch.full((lanes, m), float("inf"), device=DEVICE)
    pcfg = PDHGConfig(eps_rel=PDHG_EPS)
    init, run = _pdhg_core(c, G, h, 0, lb, ub, pcfg)

    def clone(s):
        return PDHGState(*(t.clone() for t in s))

    pfull = clone(run(init(), PDHG_MAXITERS))
    pmid = clone(run(init(), 2 * pcfg.check_every))
    ppath = os.path.join(tmp, "pdhg.pt")
    checkpoint.save_state_torch(ppath, pmid)
    presumed = clone(run(checkpoint.load_state_torch(ppath, DEVICE),
                             PDHG_MAXITERS))
    pdhg_same = all(same_bits(x, y) for x, y in zip(pfull, presumed))
    out = {"simplex": {"lanes": B, "m": M, "cut_at": cut,
                       "max_iters": int(full.iters.max()),
                       "running_at_cut": running_at_cut,
                       "same_bits": simplex_same,
                       "status": status_counts(full.status),
                       "launches": launches["solve_segment"]},
           "pdhg": {"lanes": lanes, "m": m, "cut_at": 2 * pcfg.check_every,
                    "max_iters": int(pfull.iters.max()),
                    "same_bits": pdhg_same,
                    "status": status_counts(pfull.status)}}
    if not (simplex_same and pdhg_same and launches["solve_segment"]
            and running_at_cut):
        fail(f"20d resume: {out}")
    return out, launches


def _phase_observe(tmp, two_phase, batches):
    """20d (ii): solve_report on 20a's result; a trace of a small solve
    (the raw IPM on 64 lanes) that holds its label."""
    import glob
    import os

    from linprog_tpu_torch import observability as obs

    (c, G, h), (cs, As, bs) = batches
    report = obs.solve_report(two_phase, cs, As, bs)
    # the lanes whose x leaves x >= 0 by more than 1e-6: how far, and
    # their costs against HiGHS
    neg = torch.clamp_min(-two_phase.x.min(dim=1).values, 0.0)
    worst = [int(i) for i in torch.argsort(neg, descending=True)[:4]
             if float(neg[i]) > 1e-6]
    below = {"lanes": int((neg > 1e-6).sum()),
             "worst": [{"lane": i, "violation": float(neg[i]),
                        "status": st.status_name(int(two_phase.status[i])),
                        "highs_gap": highs_gap(two_phase.cost[i:i + 1],
                                               cs[i:i + 1], 1,
                                               A_eq=As[i:i + 1],
                                               b_eq=bs[i:i + 1])}
                       for i in worst]}
    logdir = os.path.join(tmp, "trace")
    with obs.trace(logdir, label="chip_smoke_phase20"):
        lt.ipm_solve_batch_canonical(c[:64], G[:64], h[:64])
    files = glob.glob(os.path.join(logdir, "chip_smoke_phase20.*.json"))
    events = json.load(open(files[0]))["traceEvents"] if files else []
    out = {"solve_report": report, "x_below_zero": below,
           "trace_files": len(files),
           "trace_has_label": any(e.get("name") == "chip_smoke_phase20"
                                  for e in events),
           "trace_kernel_events": sum(e.get("cat") == "kernel"
                                      for e in events),
           "trace_s": obs.trace.last_elapsed_s}
    if report["status_counts"] != {"OPTIMAL": B} or not out["trace_has_label"]:
        fail(f"20d observability: {out}")
    if report["quality"]["max_primal_residual"] > 1e-3:
        fail(f"20d solve_report: {report['quality']}")
    return out


def _phase_mps(tmp):
    """20d (iii): an LP with bounds written to MPS, read back, solved by
    SimplexSolver on the card, against HiGHS on the same arrays."""
    import os

    from linprog_tpu_torch.io import mps_to_solver_inputs, read_mps, write_mps

    from linprog_tpu_torch.generators import random_inequality_lps

    c, G, h = (a[0].astype(np.float64)
               for a in random_inequality_lps(1, 24, 32, seed=SEED + 22))
    lb = np.zeros(32)
    ub = np.full(32, np.inf)
    ub[::4] = 1.5
    lb[1::8] = 0.25
    path = os.path.join(tmp, "lp.mps")
    write_mps(path, c, G=G, h=h, lb=lb, ub=ub, name="PHASE20")
    p = dict(zip(("c", "A", "b", "G", "h", "lb", "ub"),
                 mps_to_solver_inputs(read_mps(path))))
    res, wall = _walled(lambda: lt.SimplexSolver(**p, device=DEVICE).solve())
    status, fun = _highs_general(p)
    out = {"m": 24, "n": 32, "optimal": bool(res.optimum), "wall_s": wall,
           "iters": int(res.iters), "cost": float(res.cost),
           "highs_gap": _rel(float(res.cost), fun)}
    if status != 0 or not res.optimum or out["highs_gap"] > 1e-6:
        fail(f"20d MPS: {out}")
    return out


def phase_parallel():
    """Phase 20: the parallel entry points (20a DP on one rank over NCCL,
    20b DP across two processes on the one card over gloo, 20c TP on one
    rank), then checkpoints, observability, MPS I/O and the dry run
    (20d)."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from linprog_tpu_torch.parallel import distributed, dryrun, make_batch_mesh

    def timed_dryrun():
        t1 = time.time()
        return dryrun.dryrun(1, DEVICE, timeout_s=SPAWN_TIMEOUT_S), \
            time.time() - t1

    t0 = time.time()
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing
                               .get_context("spawn"))
    threads = ThreadPoolExecutor(max_workers=1)
    distributed.initialize()
    try:
        job = pool.submit(_highs_tp)
        batches = _par_batch()
        mesh = make_batch_mesh()
        dp, paths, two_phase = _phase_dp(mesh, batches)
        emit({"phase": "parallel_dp", "lanes": B, "m": M, "n": N, **dp,
              "summary": distributed.process_summary()})
        emit({"phase": "parallel_dp_procs", **_phase_dp_procs(two_phase)})
        tp = _phase_tp()
        emit({"phase": "parallel_tp", **_check_tp(tp, job)})
        with tempfile.TemporaryDirectory() as tmp:
            observe = _phase_observe(tmp, two_phase, batches)
            mps = _phase_mps(tmp)
            # the dry run's process works beside the resume legs alone,
            # which time nothing; every wall above is taken without it
            dry = threads.submit(timed_dryrun)
            resume, paths["parallel_resume"] = _phase_resume(tmp)
        legs, dry_s = dry.result()
    finally:
        distributed.shutdown()
        pool.shutdown(wait=True, cancel_futures=True)
        threads.shutdown(wait=True)
    emit({"phase": "parallel_rest", "resume": resume, **observe, "mps": mps,
          "dryrun": legs, "dryrun_s": dry_s, "seconds": time.time() - t0})
    return paths


# ---- phase 21: the reference's last modes ---------------------------------

MODE_PIVOTS = 16  # pivots of a mode's lockstep run against its plain version
# kernel 3's sectional pricing: lanes, m, structural n, section width; and
# the lanes of the full solves (a bucket of 8: 8 CTAs a lane)
PSB, PSM, PSN, PS_NBLK, PS_SOLVE_LANES = 64, 2048, 2048, 256, 8
PS_MAXITERS = 200_000
MODE_IPM_LANES = 1024  # 21e: the IPM's lanes at m = n = 256
SLACK_LANES = 256  # 21f: the slack-guess crossover's lanes at m = n = 256
CUMSUM_LANES = 16  # 21g: the sparse IPM's lanes at m = n = 2048, 1 %


def _iter_ms(run, fresh, pivots=SEGMENT_PIVOTS, reps=3):
    """The in-segment time an iteration of ``run(state, pivots)``:
    (t_pivots - t_1) / (pivots - 1), each the median of ``reps`` CUDA-event
    timings from fresh states (the launch's loading left out)."""
    def timed(k):
        states = iter([fresh() for _ in range(reps)])
        return cuda_ms(lambda: run(next(states), k), reps)

    t1 = timed(1)
    return (timed(pivots) - t1) / (pivots - 1)


def _lockstep16(label, k, p):
    """Kernel and plain version after MODE_PIVOTS pivots from one state:
    basis, status, iterations, c_B and penalties equal on every lane, bfs
    within 1e-4 of scale."""
    same = _lockstep_lanes(k, p, ("basis", "status", "iters", "cB", "pen"))
    split = int((~same).sum())
    if split:
        fail(f"{label}: {MODE_PIVOTS} pivots left lockstep on {split} lanes")
    scale = max(p.bfs[same].abs().max().item(), 1.0)
    err = (k.bfs[same] - p.bfs[same]).abs().max().item()
    if not err <= 1e-4 * scale:
        fail(f"{label}: bfs differs by {err:.3e} after {MODE_PIVOTS} pivots "
             f"(> 1e-4 of {scale:.3e})")
    return {"lanes_in_lockstep": int(same.sum()), "max_abs_err_bfs": err,
            "bfs_scale": scale}


def _simplex_start(A, h, state0):
    """The SimplexState of a segment instance's slack start."""
    from linprog_tpu_torch.engine import SimplexState

    return SimplexState(basis=state0.basis.clone(),
                        inv_B=state0.invBT.transpose(1, 2).contiguous(),
                        bfs=h.clone(), iters=state0.iters.clone(),
                        status=state0.status.clone())


def _exact_cost(A, c, b, basis):
    """float64 objective at each lane's basis from an exact solve."""
    xB = solve_or_nan(basis_matrix(A, basis).double(), b.double())
    return (torch.gather(c, 1, basis.long()).double() * xB).sum(dim=1)


def _phase_split_ablate():
    """21a, 21b: kernel 1's split pricing and its ablation modes at
    [1024, 256, 512], primal dantzig with the tuned settings."""
    from linprog_tpu_torch.engine_batched import run_batched

    cfg = tuned_config(M)
    A, c, apen, h, state0 = _segment_instance(False, B, M, N, SEED + 21)
    kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              feas_tol=cfg.feas_tol, stall_limit=cfg.stall_limit,
              packed=cfg.packed_select)
    n = A.shape[2]

    def fresh():
        return sk.SegmentState(*(t.clone() for t in state0))

    def kernel(s, pivots, **mode):
        return sk.solve_segment(A, c, apen, 1 << 20, s, seg_len=pivots,
                                **kw, **mode)

    def plain(s, pivots, **mode):
        return sk.solve_segment_plain(A, c, apen, 1 << 20, s, seg_len=pivots,
                                      **kw, **mode)

    k16, p16 = kernel(fresh(), MODE_PIVOTS, split=True), plain(
        fresh(), MODE_PIVOTS, split=True)
    torch.cuda.synchronize()
    split16 = _lockstep16("solve_segment split", k16, p16)
    split16["plan"] = sk.last_plan._asdict()
    pivoted = int((k16.basis != state0.basis).any(dim=1).sum())
    del k16, p16

    # a full run on the segment driver, split against unsplit (the split
    # mode's launches on a path: this run's)
    full = {}
    before = sk.launches_split
    for name, mode_cfg in (("unsplit", cfg),
                           ("split", cfg.replace(split_pricing=True))):
        start = _simplex_start(A, h, state0)
        t0 = time.time()
        res = run_batched(
            c, A, h, start, torch.ones(n, dtype=torch.bool, device=DEVICE),
            20 * M, mode_cfg)
        torch.cuda.synchronize()
        full[name] = (res, time.time() - t0)
    path_launches = sk.launches_split - before
    (ru, wu), (rs, ws) = full["unsplit"], full["split"]
    if not torch.equal(ru.status, rs.status):
        fail(f"split full run: statuses differ on "
             f"{int((ru.status != rs.status).sum())} lanes")
    cu, cs_ = _exact_cost(A, c, h, ru.basis), _exact_cost(A, c, h, rs.basis)
    both = (ru.status == st.OPTIMAL) & (rs.status == st.OPTIMAL)
    rel = ((cs_ - cu).abs() / cu.abs().clamp_min(1.0))[both].max().item()
    if not rel <= 1e-4:
        fail(f"split full run: costs differ by {rel:.3e} relative (> 1e-4)")

    # in-segment times: unsplit, split, each ablation mode, in turns; and
    # the mean iterations a lane runs of the 64 (a mode that ends lanes
    # early, such as 1 or 6, times fewer iterations)
    ms, plain_ms, mean_iters = {}, {}, {}
    for name, mode in [("unsplit", {}), ("split", {"split": True})] + [
            (f"ablate{k}", {"ablate": k}) for k in range(1, 8)] + [
            ("unsplit_again", {})]:
        ms[name] = _iter_ms(lambda s, p: kernel(s, p, **mode), fresh)
        if name != "unsplit_again":
            plain_ms[name] = _iter_ms(lambda s, p: plain(s, p, **mode), fresh,
                                      pivots=MODE_PIVOTS, reps=1)
            ran = kernel(fresh(), SEGMENT_PIVOTS, **mode).iters
            mean_iters[name] = ran.double().mean().item()
    # ablate = 0 is the kernel as it was: the same bits as no switch at all
    a0 = kernel(fresh(), MODE_PIVOTS, ablate=0)
    d0 = kernel(fresh(), MODE_PIVOTS)
    torch.cuda.synchronize()
    if not all(same_bits(x, y) for x, y in zip(a0, d0)):
        fail("solve_segment ablate=0 differs from the kernel without it")
    del a0, d0
    b_ms, b_by = segment_bound_ms(B, pivoted, M, n)
    lb_ms, _ = launch_bound_ms(B, M, n, SEGMENT_PIVOTS)
    return {
        "shape": [B, M, n], "split_lockstep16": split16,
        "full_run": {"status": status_counts(rs.status),
                     "max_rel_cost_diff": rel, "tol_rel": 1e-4,
                     "split_s": ws, "unsplit_s": wu,
                     "split_launches": path_launches,
                     "pivots_split": int(rs.iters.sum()),
                     "pivots_unsplit": int(ru.iters.sum())},
        "ablate0_same_bits": True,
        "ms_per_iter": ms, "plain_ms_per_iter": plain_ms,
        "mean_iters_of_64": mean_iters,
        "bound_ms": b_ms, "bound_by": b_by,
        "launch_bound_ms_per_iter": lb_ms / SEGMENT_PIVOTS}


def _partial_bound_ms(lanes, pivoting, m, n, n_blk):
    """One batch-iteration of sectional pricing: a section of A (m n_blk)
    and the factor read once per lane, the factor written once per
    pivoting lane, the O(m + n) rows once."""
    n_bytes = 4 * (lanes * (m * n_blk + m * m + 2 * (5 * m + 3 * n))
                   + pivoting * m * m)
    n_flops = lanes * (2 * m * n_blk + 4 * m * m) + pivoting * 2 * m * m
    return bound_ms(n_bytes, n_flops)


def _phase_partial():
    """21c: kernel 3's sectional pricing at B = 64, (2048, 4096) primal,
    n_blk = 256 (S = 16)."""
    from linprog_tpu_torch.engine import SimplexState
    from linprog_tpu_torch.engine_batched import run_batched_stream

    cfg = tuned_config(PSM)
    A, c, apen, h, state0 = _segment_instance(False, PSB, PSM, PSN,
                                              SEED + 21)
    n = A.shape[2]
    kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              feas_tol=cfg.feas_tol, stall_limit=cfg.stall_limit,
              packed=cfg.packed_select, a_resident=False, n_blk=PS_NBLK)

    def fresh():
        return sk.SegmentState(*(t.clone() for t in state0))

    def run(fn, s, pivots, partial):
        return fn(A, c, apen, 1 << 20, s, seg_len=pivots, partial=partial,
                  **kw)

    k16 = run(ssk.solve_segment_stream, fresh(), MODE_PIVOTS, True)
    plan = ssk.last_plan
    p16 = run(ssk.solve_segment_stream_plain, fresh(), MODE_PIVOTS, True)
    torch.cuda.synchronize()
    lock = _lockstep16("solve_segment_stream partial", k16, p16)
    pivoted = int((k16.basis != state0.basis).any(dim=1).sum())
    # the other built cluster size gives the same bits
    others = []
    for other in ssk.stream_plans(PSB, PSM, n):
        if other.cluster == plan.cluster or other.aligned != plan.aligned:
            continue
        s = fresh()
        ssk.launch_with_plan(other, A, c, apen, 1 << 20, s,
                             seg_len=MODE_PIVOTS, partial=True,
                             **{k: v for k, v in kw.items()
                                if k != "a_resident"})
        torch.cuda.synchronize()
        if not all(same_bits(x, y) for x, y in zip(s, k16)):
            fail(f"partial pricing: {other.cluster} CTAs a lane differ from "
                 f"{plan.cluster} after {MODE_PIVOTS} pivots")
        others.append(other.cluster)
    del k16, p16

    ms = {name: _iter_ms(lambda s, p: run(ssk.solve_segment_stream, s, p,
                                          part), fresh)
          for name, part in (("full", False), ("partial", True),
                             ("full_again", False))}
    plain_ms = {name: _iter_ms(lambda s, p: run(
        ssk.solve_segment_stream_plain, s, p, part), fresh,
        pivots=MODE_PIVOTS, reps=1) for name, part in (("full", False),
                                                       ("partial", True))}
    b_ms, b_by = _partial_bound_ms(PSB, pivoted, PSM, n, PS_NBLK)
    fb_ms, fb_by = segment_bound_ms(PSB, pivoted, PSM, n)

    # the first lanes solved to the end on the segment driver, with full
    # and with sectional pricing
    L = PS_SOLVE_LANES
    sub = SimplexState(*(t[:L].clone() for t in _simplex_start(A, h,
                                                                state0)))
    solves = {}
    before = ssk.launches_partial
    for name, part in (("full", False), ("partial", True)):
        t0 = time.time()
        res = run_batched_stream(
            c[:L], A[:L], h[:L], sub, torch.ones(n, dtype=torch.bool,
                                                 device=DEVICE),
            PS_MAXITERS, cfg.replace(partial_pricing=part),
            variant="stream", n_blk=PS_NBLK)
        torch.cuda.synchronize()
        solves[name] = (res, time.time() - t0)
    path_launches = ssk.launches_partial - before
    (rf, wf), (rp, wp) = solves["full"], solves["partial"]
    for name, r in (("full", rf), ("partial", rp)):
        if not bool((r.status == st.OPTIMAL).all()):
            fail(f"{name} pricing solve: {status_counts(r.status)}, "
                 f"iterations {r.iters.tolist()}")
    cf, cp = _exact_cost(A[:L], c[:L], h[:L], rf.basis), _exact_cost(
        A[:L], c[:L], h[:L], rp.basis)
    rel = ((cp - cf).abs() / cf.abs().clamp_min(1.0)).max().item()
    if not rel <= 1e-4:
        fail(f"partial pricing solve: costs {rel:.3e} from full pricing")
    return {"shape": [PSB, PSM, n], "n_blk": PS_NBLK,
            "sections": n // PS_NBLK, "plan": plan._asdict(),
            "same_bits_at_clusters": others, "lockstep16": lock,
            "ms_per_iter": ms, "plain_ms_per_iter": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "full_pricing_bound_ms": fb_ms, "full_pricing_bound_by": fb_by,
            "solve": {"lanes": L, "status": status_counts(rp.status),
                      "pivots_partial": rp.iters.tolist(),
                      "pivots_full": rf.iters.tolist(),
                      "pivot_ratio": float(rp.iters.sum() / rf.iters.sum()),
                      "max_rel_cost_diff": rel, "tol_rel": 1e-4,
                      "partial_s": wp, "full_s": wf,
                      "partial_launches": path_launches}}


def _phase_ns():
    """21d: solve_batch_two_phase with refactor_method="ns" at B = 1024,
    m = n = 256: every lane OPTIMAL, HiGHS within 1e-5 on 16 lanes."""
    (_, _, _), (cs, As, bs) = _par_batch()
    out = {}
    for name, cfg in (("inv", tuned_config(M)),
                      ("ns", tuned_config(M, refactor_method="ns"))):
        res, wall = _walled(lambda: lt.solve_batch_two_phase(
            cs, As, bs, PAR_MAXITERS, PAR_MAXITERS, cfg))
        out[name] = {"status": status_counts(res.status), "wall_s": wall,
                     "pivots": int(res.iters.sum())}
        if name == "ns":
            if out[name]["status"] != {"OPTIMAL": B}:
                fail(f"21d ns two-phase: {out[name]['status']}")
            gap = highs_gap(res.cost, cs, 16, A_eq=As, b_eq=bs)
            out[name]["highs_gap_16"] = gap
            if not gap <= 1e-5:
                fail(f"21d ns two-phase: HiGHS gap {gap:.3e} (> 1e-5)")
    return out


def _phase_ipm_modes():
    """21e: the IPM at B = 1024, m = n = 256 (eps 1e-3) under the default,
    gondzio=2, minv, each in f32 and float64.  Guards: minv and gondzio=2
    in float64 each have at least the float64 default's OPTIMAL lanes.  In f32 Gondzio's correctors strand lanes at the
    KKT floor in the reference too (ROADMAP Queue 3), and minv collapses
    (the reference's 1 of 32): both reported only."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    c, G, h = device_inequality_lps(gen, MODE_IPM_LANES, M, N, DEVICE)
    out = {}
    for dtype in ("float32", "float64"):
        for name, kw in (("default", {}), ("gondzio2", {"gondzio": 2}),
                         ("minv", {"newton_solver": "minv"})):
            cfg = lt.IPMConfig(dtype=dtype, **kw)
            res, wall = _walled(lambda: lt.ipm_solve_batch_canonical(
                c, G, h, cfg))
            out[f"{name}_{dtype}"] = {
                "optimal": int((res.status == st.OPTIMAL).sum()),
                "status": status_counts(res.status), "wall_s": wall,
                "newton_steps_max": int(res.iters.max())}
    for name, base in (("minv_float64", "default_float64"),
                       ("gondzio2_float64", "default_float64")):
        if out[name]["optimal"] < out[base]["optimal"]:
            fail(f"21e {name}: {out[name]['optimal']} OPTIMAL lanes, fewer "
                 f"than {base}'s {out[base]['optimal']}")
    return out


def _phase_slack_guess():
    """21f: ipm_crossover_batch_canonical(guess="slack") at m = n = 256:
    the crossed lanes, every one certified."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    c, G, h = device_inequality_lps(gen, SLACK_LANES, M, N, DEVICE)
    (res, crossed), wall = _walled(lambda: lt.ipm_crossover_batch_canonical(
        c, G, h, cfg=tuned_config(M), guess="slack"))
    cert = lt.certify_vertex_batch(c, G, h, res.basis)["certified"]
    if not bool(cert[crossed].all()):
        fail(f"21f slack guess: {int((crossed & ~cert).sum())} crossed lanes "
             "not certified")
    return {"lanes": SLACK_LANES, "crossed": int(crossed.sum()),
            "certified_of_crossed": int(cert[crossed].sum()), "wall_s": wall}


def _phase_cumsum():
    """21g: the sparse IPM with assembly="cumsum" at m = n = 2048, 1 %,
    B = 16 against "segment" on the same lanes.  Guards: the compensated
    prefix-sum normal matrix within 1e-5 relative of a float64 segment sum
    on every lane, at a d spread over ~1e8 (where a plain f32 prefix
    cancels); the same status on every lane, except a lane that one mode
    ends OPTIMAL and the other freezes at the f32 KKT floor (ITER_LIMIT:
    the two normal matrices round apart, so the floor strands different
    lanes); at least segment's OPTIMAL lanes; costs within 2e-3 where both
    are OPTIMAL (the eps 1e-3 class).  Walls in turns."""
    from linprog_tpu_torch import ipm_sparse
    from linprog_tpu_torch.generators import (
        device_sparse_inequality_lps,
        random_sparse_pattern,
    )

    rows, cols = random_sparse_pattern(SM, SM, SDENS, seed=0)
    pat = lt.SparsePattern(rows, cols, SM, SM, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, vals, h = device_sparse_inequality_lps(gen, CUMSUM_LANES, rows, cols,
                                              SM, SM, DEVICE)
    d = torch.exp(torch.rand((CUMSUM_LANES, 2 * SM), generator=gen,
                             device=DEVICE) * 18.0 - 9.0)
    N_cum = ipm_sparse._SparseSlackOp(pat.cumsum_tables(DEVICE), vals, SM,
                                      SM).normal(d)
    N_64 = ipm_sparse._SparseSlackOp(pat.tables(DEVICE), vals.double(), SM,
                                     SM).normal(d.double())
    unit = ((N_cum.double() - N_64).abs().amax(dim=(1, 2))
            / N_64.abs().amax(dim=(1, 2))).max()
    del N_cum, N_64
    icfg = lt.IPMConfig(eps_rel=1e-3, maxiters=40, frac=0.995)
    out, res = {"normal_max_rel_err": float(unit)}, {}
    for name in ("segment", "cumsum", "cumsum_again", "segment_again"):
        mode = name.split("_")[0]
        r, wall = _walled(lambda: lt.ipm_solve_batch_sparse_canonical(
            c, rows, cols, vals, h, (SM, SM), icfg, pattern=pat,
            assembly=mode))
        out[name + "_s"] = wall
        res.setdefault(mode, r)
    seg, cum = res["segment"], res["cumsum"]
    both = (seg.status == st.OPTIMAL) & (cum.status == st.OPTIMAL)
    pair = torch.stack([seg.status, cum.status])
    floor = ((pair.amin(dim=0) == st.OPTIMAL)
             & (pair.amax(dim=0) == st.ITER_LIMIT))
    rel = ((cum.cost - seg.cost).abs() / seg.cost.abs().clamp_min(1.0))
    out.update({"lanes": CUMSUM_LANES, "m": SM, "density": SDENS,
                "status_segment": status_counts(seg.status),
                "status_cumsum": status_counts(cum.status),
                "same_status_lanes": int((seg.status == cum.status).sum()),
                "floor_swapped_lanes": int(floor.sum()),
                "max_rel_cost_diff_both_optimal": float(rel[both].max()),
                "pairs": int(pat.pair_ids.size)})
    if not unit <= 1e-5:
        fail(f"21g cumsum: normal matrix {float(unit):.3e} from float64 "
             "(> 1e-5)")
    if not bool(((seg.status == cum.status) | floor).all()):
        fail(f"21g cumsum: statuses differ from segment: {out}")
    if int((cum.status == st.OPTIMAL).sum()) < int(
            (seg.status == st.OPTIMAL).sum()):
        fail(f"21g cumsum: fewer OPTIMAL lanes than segment: {out}")
    if not float(rel[both].max()) <= 2e-3:
        fail(f"21g cumsum: costs differ from segment by > 2e-3: {out}")
    return out


def phase_exact_m1024():
    """Phase 22: the reference's ipm_xover_m1024 leg, solve_batch_exact at
    B = 32, m = n = 1024, past the cluster line: kernel 1's streaming
    branch in the crossover, its retry and the repair, both modes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import linprog_tpu_torch.batch as lb
    import linprog_tpu_torch.crossover as lx
    import linprog_tpu_torch.engine_batched as le
    import linprog_tpu_torch.ipm as li
    import linprog_tpu_torch.refine as lr

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, XMB, XMM, XMM, DEVICE)
    # HiGHS takes ~30 s a lane at this size: a worker process solves lane 0
    # while the card runs
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing
                               .get_context("spawn"))
    try:
        job = pool.submit(_highs_general, {
            "c": c[0].double().cpu().numpy(), "G": G[0].double().cpu().numpy(),
            "h": h[0].double().cpu().numpy()})
        t0 = time.time()
        lt.solve_batch_exact(c, G, h)  # warm-up
        torch.cuda.synchronize()
        warm = time.time() - t0

        def seg_label(A, *args, **kw):
            return (f"{_branch(sk.last_plan)} "
                    f"{'dual' if kw.get('dual') else 'primal'} B={A.shape[0]}")

        runs = []
        for _ in range(XM_REPEATS):
            _reset_counts()
            with _stage_spans([
                    ("ipm", li, "ipm_canonical_state", None),
                    ("crossover", lx, "crossover_batch_canonical", None),
                    ("polish", lr, "polish_batch", None),
                    ("fallback_two_phase", lb, "solve_batch_two_phase", None),
                    ("batched_lu", le, "refresh_running_lanes", None),
                    ("segment_kernel", le, "solve_segment", seg_label),
                    ("stream_kernel", le, "solve_segment_stream", None),
            ]) as spans:
                t_a = torch.cuda.Event(enable_timing=True)
                t_b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t_a.record()
                res, info = lt.solve_batch_exact(c, G, h)
                t_b.record()
                torch.cuda.synchronize()
            stage_s, seg_s = {}, {}
            for name, label, e_a, e_b in spans:
                sec = e_a.elapsed_time(e_b) / 1e3
                entry = stage_s.setdefault(name, {"calls": 0, "seconds": 0.0})
                entry["calls"] += 1
                entry["seconds"] += sec
                if label is not None:
                    entry = seg_s.setdefault(label, {"launches": 0,
                                                     "seconds": 0.0})
                    entry["launches"] += 1
                    entry["seconds"] += sec
            runs.append({"wall_s": t_a.elapsed_time(t_b) / 1e3,
                         "launches": _read_counts(), "stages_s": stage_s,
                         "segment_kernel_by_branch": seg_s,
                         "crossed": info["crossed"],
                         "retry_crossed": info["retry_crossed"],
                         "fallback": info["fallback"]})
        walls = [r["wall_s"] for r in runs]
        mid = runs[int(np.argsort(walls)[len(walls) // 2])]

        t1 = time.time()
        cert = lt.certify_vertex_batch(c, G, h, res.basis)
        summ = lt.certificate_summary(cert)
        torch.cuda.synchronize()
        cert_wall = time.time() - t1
        status, ref = job.result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if status != 0:
        fail(f"m = 1024 path: HiGHS did not solve lane 0 (status {status})")
    gap = abs(float(res.cost[0]) - ref) / max(1.0, abs(ref))
    launches = runs[0]["launches"]
    counts = status_counts(res.status)
    uncertified = torch.nonzero(~cert["certified"]).flatten().tolist()
    out = {"phase": "exact_m1024", "lanes": XMB, "m": XMM, "n": XMM,
           "seed": SEED, "lane_status": counts,
           "wall_s": float(np.median(walls)), "walls_s": walls,
           "warmup_wall_s": warm, "lps_per_sec": XMB / float(np.median(walls)),
           "crossed": mid["crossed"], "retry_crossed": mid["retry_crossed"],
           "fallback": mid["fallback"], "launches": launches,
           "median_run": {k: mid[k] for k in ("stages_s",
                                              "segment_kernel_by_branch")},
           "segment_kernel_s": [r["stages_s"].get("segment_kernel", {})
                                .get("seconds") for r in runs],
           "batched_lu_s": [r["stages_s"].get("batched_lu", {})
                            .get("seconds") for r in runs],
           "certified": summ["certified"], "uncertified_lanes": uncertified,
           "cert_wall_s": cert_wall, "highs_lanes": 1,
           "max_rel_gap_vs_highs": gap, "iters_total": int(res.iters.sum())}
    emit(out)
    if res.x.shape != (XMB, XMM) or not torch.isfinite(res.cost).all():
        fail("m = 1024 path: result has the wrong shape or non-finite costs")
    if counts.get("OPTIMAL", 0) != XMB:
        fail(f"m = 1024 path: {counts}")
    if summ["certified"] < XMB - 1:
        fail(f"m = 1024 path: {summ['certified']}/{XMB} certified "
             f"(< {XMB - 1})")
    if not gap <= 1e-5:
        fail(f"m = 1024 path: HiGHS gap {gap:.3e} > 1e-5")
    for mode in ("primal", "dual"):
        if launches[f"solve_segment_streaming_{mode}"] <= 0:
            fail(f"m = 1024 path: kernel 1's streaming branch was never "
                 f"launched in {mode} mode")
    return launches


def phase_last_modes():
    """Phase 21: the reference's last modes (split pricing and the ablation
    switch on kernel 1, sectional pricing on kernel 3, Newton-Schulz
    refactorization, the Gondzio and minv IPM, the slack basis guess, the
    cumsum sparse assembly).  Returns the launch counts of the phase's run
    and the modes' numbers for the kernels line."""
    t0 = time.time()
    _reset_counts()
    sk.launches_split = ssk.launches_partial = 0
    sk.launches_ablate = {k: 0 for k in sk.launches_ablate}
    k1 = _phase_split_ablate()
    emit({"phase": "last_modes_kernel1", **k1})
    k3 = _phase_partial()
    emit({"phase": "last_modes_kernel3", **k3})
    split_n = k1["full_run"]["split_launches"]
    partial_n = k3["solve"]["partial_launches"]
    for name, n_launch in (("split", split_n), ("partial", partial_n)):
        if not n_launch:
            fail(f"phase 21: the {name} mode was never launched on its path")
    if not all(sk.launches_ablate.values()):
        fail(f"phase 21: an ablation mode was never launched: "
             f"{sk.launches_ablate}")
    rest = {"ns_two_phase": _phase_ns(), "ipm_modes": _phase_ipm_modes(),
            "slack_guess": _phase_slack_guess(),
            "cumsum_assembly": _phase_cumsum()}
    counts = dict(_read_counts(), solve_segment_split=sk.launches_split,
                  solve_segment_ablate=dict(sk.launches_ablate),
                  solve_segment_stream_partial=ssk.launches_partial)
    emit({"phase": "last_modes_paths", **rest,
          "launches": counts, "seconds": time.time() - t0})
    split16 = k1["split_lockstep16"]
    kernel1_modes = [dict(mode="split", ms=k1["ms_per_iter"]["split"],
                          plain_ms=k1["plain_ms_per_iter"]["split"],
                          bound_ms=k1["launch_bound_ms_per_iter"],
                          bound_by="operations",
                          max_abs_err=split16["max_abs_err_bfs"],
                          launches=split_n)]
    kernel1_modes += [dict(mode=f"ablate{k}", ms=k1["ms_per_iter"][f"ablate{k}"],
                           plain_ms=k1["plain_ms_per_iter"][f"ablate{k}"],
                           bound_ms=k1["launch_bound_ms_per_iter"],
                           bound_by="operations", max_abs_err=None,
                           # profiling only: the timing runs' launches
                           launches=sk.launches_ablate[k],
                           mean_iters_of_64=k1["mean_iters_of_64"][
                               f"ablate{k}"])
                      for k in range(1, 8)]
    kernel3_modes = [dict(mode="partial", ms=k3["ms_per_iter"]["partial"],
                          plain_ms=k3["plain_ms_per_iter"]["partial"],
                          bound_ms=k3["bound_ms"], bound_by=k3["bound_by"],
                          max_abs_err=k3["lockstep16"]["max_abs_err_bfs"],
                          launches=partial_n)]
    return {"last_modes": counts}, kernel1_modes, kernel3_modes


def _dd_plain(bvec, y, M):
    """refine.py's eager chain (the plain version) on the same tensors."""
    s, e = lr._dd_chunk_products(y, M, 8)
    parts = [s, e] if bvec is None else [bvec[:, None, :], -s, -e]
    return lr._kahan_sum_chunks(torch.cat(parts, dim=1))


def _dd_row(label, got, want, kernel, plain, n_bytes, n_ops):
    """One case of phase 23: the same bits or a failure, and the times.
    ``n_ops`` are f32 operations, none an FMA: each costs the card what an
    FMA's two flops cost."""
    if not same_bits(got, want):
        fail(f"dd kernel: {label} differs from the plain chain")
    b_ms, b_by = bound_ms(n_bytes, 2 * n_ops)
    ms = cuda_ms(kernel, DD_REPS)
    return {"max_abs_err": 0.0, "ms": ms,
            "plain_ms": cuda_ms(plain, DD_PLAIN_REPS), "reps": DD_REPS,
            "plain_reps": DD_PLAIN_REPS, "bound_ms": b_ms, "bound_by": b_by,
            "roofline_pct": 100.0 * b_ms / ms}


def phase_dd_kernel():
    """Phase 23: the double-word kernel against refine.py's eager chain at
    the shapes the paths send it, bit for bit, with its times."""
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for b, m, n in DD_SHAPES:
        K = -(-m // 8)
        for transposed in (False, True):
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + m + n)
            y = torch.randn((b, m), generator=gen, device=DEVICE)
            M_ = (torch.randn((b, n, m), generator=gen,
                              device=DEVICE).transpose(1, 2)
                  if transposed else
                  torch.randn((b, m, n), generator=gen, device=DEVICE))
            # a rounding-sized residual, as refinement sends it
            bvec = torch.einsum("bm,bmn->bn", y, M_)
            for entry in ("residual", "product"):
                bv = bvec if entry == "residual" else None
                label = (f"{entry} [{b}, {m}, {n}]"
                         f"{' transposed view' if transposed else ''}")
                row = _dd_row(
                    label, ddk.chunk_products_sum(bv, y, M_),
                    _dd_plain(bv, y, M_),
                    lambda: ddk.chunk_products_sum(bv, y, M_),
                    lambda: _dd_plain(bv, y, M_),
                    4 * (b * m * n + b * m + (2 if bv is not None else 1)
                         * b * n),
                    21 * b * 8 * K * n + 7 * b * n * (2 * K + 1))
                rows.append({"shape": [b, m, n], "entry": entry,
                             "transposed_view": transposed, **row})
            del y, M_, bvec
    for b, K, n in DD_SUM_SHAPES:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + K + n)
        P = torch.randn((b, K, n), generator=gen, device=DEVICE)
        P = P * 10.0 ** torch.randint(-6, 7, P.shape, generator=gen,
                                      device=DEVICE)
        row = _dd_row(f"sum [{b}, {K}, {n}]", ddk.kahan_sum(P),
                      lr._kahan_sum_chunks(P), lambda: ddk.kahan_sum(P),
                      lambda: lr._kahan_sum_chunks(P),
                      4 * (b * K * n + b * n), 7 * b * n * K)
        rows.append({"shape": [b, K, n], "entry": "sum", **row})
        del P
    torch.cuda.synchronize()
    emit({"phase": "dd_kernel", "cases": rows, "same_bits": True,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "seconds": time.time() - t0})
    return rows


def _lu_errors(got, want):
    """max|got - want| / max|want| of each lane against float64."""
    d = (got.double() - want).abs().reshape(got.shape[0], -1).amax(dim=1)
    return d / want.abs().reshape(got.shape[0], -1).amax(dim=1)


def _lu_library(M, rhs=None):
    """torch.linalg's f32 inverse or solve, failed lanes NaN (what the
    helpers called before the kernel)."""
    if rhs is None:
        inv, info = torch.linalg.inv_ex(M)
        return torch.where((info != 0)[:, None, None], float("nan"), inv)
    x, info = torch.linalg.solve_ex(M, rhs[:, :, None])
    return torch.where((info != 0)[:, None], float("nan"), x[:, :, 0])


def phase_lu_kernel():
    """Phase 24: the batched LU kernel against torch.linalg and the plain
    version at the m = 256 paths' batch sizes, with its times."""
    t0 = time.time()
    rows = []
    for b, m in LU_SHAPES:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24 * b + m)
        Mx = torch.randn((b, m, m), generator=gen, device=DEVICE)
        rhs = torch.randn((b, m), generator=gen, device=DEVICE)
        for entry in ("inverse", "solve"):
            r = None if entry == "inverse" else rhs
            if r is None:
                kernel = lambda: luk.inverse(Mx)  # noqa: E731
                want = torch.linalg.inv(Mx.double())
                flops, n_bytes = 2 * b * m ** 3, 8 * b * m * m
            else:
                kernel = lambda: luk.solve(Mx, rhs)  # noqa: E731
                want = torch.linalg.solve(Mx.double(),
                                          rhs.double()[:, :, None])[..., 0]
                flops, n_bytes = 2 * b * m ** 3 / 3, 4 * b * (m * m + 2 * m)
            got = kernel()
            if not torch.isfinite(got).all():
                fail(f"lu kernel: {entry} [{b}, {m}, {m}] is not finite")
            err = _lu_errors(got, want)
            err_lib = _lu_errors(_lu_library(Mx, r), want)
            err_plain = _lu_errors(luk._plain(Mx, r), want)
            if err.max() > 2 * err_lib.max():
                fail(f"lu kernel: {entry} [{b}, {m}, {m}] error "
                     f"{float(err.max()):.3e} > twice torch.linalg's "
                     f"{float(err_lib.max()):.3e}")
            b_ms, b_by = bound_ms(n_bytes, flops)
            ms = cuda_ms(kernel, LU_REPS)
            rows.append({
                "shape": [b, m, m], "entry": entry, "plan": luk.plan(m),
                "max_abs_err": float((got.double() - luk._plain(Mx, r)
                                      .double()).abs().max()),
                "err_max": float(err.max()), "err_median":
                    float(err.median()),
                "library_err_max": float(err_lib.max()),
                "library_err_median": float(err_lib.median()),
                "plain_err_max": float(err_plain.max()),
                "ms": ms, "plain_ms": cuda_ms(lambda: luk._plain(Mx, r),
                                              LU_PLAIN_REPS),
                "library_ms": cuda_ms(lambda: _lu_library(Mx, r), LU_REPS),
                "reps": LU_REPS, "plain_reps": LU_PLAIN_REPS,
                "bound_ms": b_ms, "bound_by": b_by,
                "roofline_pct": 100.0 * b_ms / ms})
        del Mx, rhs
    torch.cuda.synchronize()
    emit({"phase": "lu_kernel", "cases": rows, "seconds": time.time() - t0})
    return rows


def main():
    phase_environment()
    phase_build()
    chol = phase_cholinv()
    seg = phase_segment()
    devex_two_phase = phase_segment_devex()
    launches = phase_main_path()
    stream = phase_stream()
    x_launches = phase_exact_m2048()
    bnd = phase_bounded_segment()
    bnd_launches = phase_bounded_path()
    steps = phase_step_kernels()
    paths = {}
    for phase in (phase_recovery, phase_warm, phase_router, phase_calibrate):
        paths.update(phase())
    stream4k = phase_stream_m4096()
    paths["exact_m4096"] = phase_exact_m4096()
    blk = phase_bounded_block()
    paths["bounded_block"] = blk["path"]["launches"]
    paths.update(phase_pdhg_m256())
    paths.update(phase_sparse_m2048())
    paths.update(phase_general_form())
    paths.update(phase_parallel())
    last_paths, kernel1_modes, kernel3_modes = phase_last_modes()
    paths.update(last_paths)
    paths["exact_m1024"] = phase_exact_m1024()
    dd_rows = phase_dd_kernel()
    lu_rows = phase_lu_kernel()

    def entry(name, source, replaces, n_launches, rep, new_shapes=None,
              modes=None):
        by_path = {path: counts[name] for path, counts in paths.items()
                   if counts.get(name)}
        if name == "dd_residual":
            by_path.update(DD_PATHS)
        if name == "batched_lu":
            by_path.update(LU_PATHS)
        if name == "solve_segment_stream":
            by_path["exact_m4096_dual"] = paths["exact_m4096"][
                "solve_segment_stream_dual"]
        if name == "solve_segment":
            by_path["exact_m1024_streaming"] = {
                mode: paths["exact_m1024"][f"solve_segment_streaming_{mode}"]
                for mode in ("primal", "dual")}
        out = {"name": name, "route": "cuda",
               "launches_by_path": by_path,
               "source": f"linprog_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": n_launches,
               "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
               "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
               "bound_by": rep["bound_by"], "library_ms": None,
               **{k: rep[k] for k in ("plans",) if k in rep}}
        if new_shapes:
            out["new_shapes"] = new_shapes
        if modes:
            out["modes"] = modes
        if name == "solve_segment":
            # the unit layout: its launches on the main path (phase 4) and
            # by path, and phase 3's leg of it
            by_path = {path: counts["solve_segment_unit"]
                       for path, counts in paths.items()
                       if counts.get("solve_segment_unit")}
            by_path["two_phase_devex"] = devex_two_phase["solve_segment_unit"]
            out["launches_unit"] = launches["solve_segment_unit"]
            out["launches_unit_by_path"] = by_path
            out["unit_layout"] = [
                {"shape": r["shape"], "mode": r["mode"], "n_d": r["n_d"],
                 "solve_segment_takes_it": r["solve_segment_takes_it"],
                 "cluster": r["plan"]["cluster"],
                 "resident_clusters": r["resident_clusters"],
                 "max_abs_err": r["segment16"]["max_abs_err_bfs"],
                 "ms": r["one_iter"]["ms"],
                 "plain_ms": r["one_iter"]["plain_ms"],
                 "segment_ms_per_iter": r["segment"]["ms_per_iter"],
                 "dense_cluster": r["dense"]["cluster"],
                 "dense_segment_ms_per_iter":
                     r["dense"]["segment_ms_per_iter"],
                 "bound_ms": r["one_iter"]["bound_ms"],
                 "bound_by": r["one_iter"]["bound_by"],
                 "launch_bound_ms_per_iter":
                     r["segment"]["launch_bound_ms_per_iter"],
                 "launch_bound_by": r["segment"]["launch_bound_by"]}
                for r in rep["unit_layout"]]
        return out

    # the later shapes: kernel 3 at the m = 4096 path's lanes, kernel 2 at
    # its panels, kernel 4 on its streaming branch
    chol4 = next(r for r in chol["other_shapes"] if r["shape"] == [4, 32, 32])
    x4k = paths["exact_m4096"]
    stream_new = [{"shape": r["shape"], "mode": r["mode"],
                   "factor_blocked": r["factor_blocked"],
                   "packed": r["packed"],
                   "cluster": r["plan"]["cluster"],
                   "smem_bytes": r["plan"]["smem_bytes"],
                   "ctas_of_sms": [r["ctas"], r["sms"]],
                   "max_abs_err": r["one_iter"]["max_abs_err_bfs"],
                   "ms": r["one_iter"]["ms"],
                   "plain_ms": r["one_iter"]["plain_ms"],
                   "segment_ms_per_iter": r["segment"]["ms_per_iter"],
                   "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                   "launches": x4k["solve_segment_stream_dual" if
                                   r["mode"] == "dual" else
                                   "solve_segment_stream_primal"]}
                  for r in stream4k["runs"]]
    chol_new = [{"shape": chol4["shape"], "max_abs_err": chol4["max_abs_err"],
                 "ms": chol4["ms"], "plain_ms": chol4["plain_ms"],
                 "bound_ms": chol4["bound_ms"],
                 "bound_by": chol4["bound_by"],
                 "launches": x4k["panel_cholinv"]}]
    bnd_new = [{"shape": r["shape"], "mode": r["mode"],
                "branch": r["branch"], "plan": r["plan"],
                "resident_clusters": r["resident_clusters"],
                "max_abs_err": r["segment16"]["max_abs_err_bfs"],
                "ms": r["one_iter_mid_solve"]["ms"],
                "plain_ms": r["one_iter_mid_solve"]["plain_ms"],
                "segment_ms_per_iter": r["segment"]["ms_per_iter"],
                "bound_ms": r["one_iter_mid_solve"]["bound_ms"],
                "bound_by": r["one_iter_mid_solve"]["bound_by"],
                "launches": paths["bounded_block"]["solve_bounded_segment"]}
               for r in blk["kernel"]]

    # kernel 1's streaming branch at [64, 1024, 2048] (phase 3), launched
    # on phase 22's path
    seg_new = [{"shape": r["shape"], "mode": r["mode"], "branch": "streaming",
                "source": "linprog_tpu_torch/csrc/solve_segment_large.cu",
                "plan": r["plan"], "resident_clusters": r["resident_clusters"],
                "max_abs_err": r["segment16"]["max_abs_err_bfs"],
                "ms": r["one_iter"]["ms"], "plain_ms": r["one_iter"]["plain_ms"],
                "segment_ms_per_iter": r["segment"]["ms_per_iter"],
                "bound_ms": r["one_iter"]["bound_ms"],
                "bound_by": r["one_iter"]["bound_by"],
                "launches": paths["exact_m1024"]["solve_segment_streaming_"
                                                 + r["mode"].split()[0]]}
               for r in seg["streaming_shapes"]]
    price = dict(steps["price_entering"],
                 max_abs_err=steps["price_entering"]["max_abs_err_r_enter"])
    ratio = dict(steps["ratio_eta_pivot"],
                 max_abs_err=max(steps["steps"]["max_abs_err_bfs"],
                                 steps["ratio_eta_pivot"]["max_abs_err_bfs"]))
    flush_native_stdout()
    emit({"kernels": [
        entry("solve_segment", "solve_segment.cu",
              "linprog_tpu/ops/solve_kernel.py:552",
              launches["solve_segment"], seg, seg_new, modes=kernel1_modes),
        entry("panel_cholinv", "panel_cholinv.cu",
              "linprog_tpu/ops/cholinv_kernel.py:80",
              launches["panel_cholinv"], chol, chol_new),
        entry("solve_segment_stream", "solve_segment_stream.cu",
              "linprog_tpu/ops/stream_kernel.py:609",
              x_launches["solve_segment_stream"], stream, stream_new,
              modes=kernel3_modes),
        entry("solve_bounded_segment", "solve_bounded_segment.cu",
              "linprog_tpu/ops/bounded_kernel.py:279", bnd_launches, bnd,
              bnd_new),
        entry("price_entering", "price_entering.cu",
              "linprog_tpu/ops/pallas_kernels.py:85",
              steps["steps"]["launches"]["price_entering"], price),
        entry("ratio_eta_pivot", "ratio_eta_pivot.cu",
              "linprog_tpu/ops/pallas_kernels.py:168",
              steps["steps"]["launches"]["ratio_eta_pivot"], ratio),
        entry("dd_residual", "dd_residual.cu", None,
              launches["dd_residual"], dd_rows[0], dd_rows[1:]),
        dict(entry("batched_lu", "batched_lu.cu", None,
                   launches["batched_lu"], lu_rows[0], lu_rows[1:]),
             library_ms=lu_rows[0]["library_ms"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        _dp_worker(sys.argv[2:])
    else:
        main()
