#!/usr/bin/env python3
"""Run the build and chosen phases of chip_smoke.py (a development aid).

Run from the repository root on a machine with a CUDA device:

    python3 tools/run_phases.py 2 5

runs phases 0 and 1 (environment, build) and then the named ones: 2 panel
kernel, 3 segment kernel, 3d its devex mode, 4 the m = 256 exact path, 5
streaming kernel, 6 the m = 2048 exact path, 7 bounded kernel, 8 bounded
path, 9 per-step kernels, 10 recovery, 11 warm re-solves, 12 router, 13
calibrate, 14 streaming kernel at m = 4096, 15 the m = 4096 exact path, 16
bounded kernel's block branch and its path at m = 1280, 17 PDHG and PDHG ->
crossover at m = 256, 18 the sparse families at m = 2048, 19 the
general-form surface (the solver classes, solve_batch_general, the
primal-dual batch, IPMSolver, ranging), 20 the parallel entry points (data
parallel on one rank and across two processes, tensor parallel), then
checkpoints, observability, MPS I/O and the dry run, 21 the reference's last
modes (split pricing and the ablation switch on kernel 1, sectional pricing
on kernel 3, Newton-Schulz refactorization, the Gondzio and minv IPM, the
slack basis guess, the cumsum sparse assembly), 22 the m = 1024 exact
path on kernel 1's streaming branch, 23 the double-word kernel against
refine.py's eager chain at the paths' shapes, 24 the batched LU kernel
against torch.linalg and its plain version.  Each phase prints
its report and exits nonzero where chip_smoke.py would; the ``kernels``
line and the last line of chip_smoke.py are not printed.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

PHASES = {"2": cs.phase_cholinv, "3": cs.phase_segment,
          "3d": cs.phase_segment_devex, "4": cs.phase_main_path,
          "5": cs.phase_stream, "6": cs.phase_exact_m2048,
          "7": cs.phase_bounded_segment, "8": cs.phase_bounded_path,
          "9": cs.phase_step_kernels, "10": cs.phase_recovery,
          "11": cs.phase_warm, "12": cs.phase_router,
          "13": cs.phase_calibrate, "14": cs.phase_stream_m4096,
          "15": cs.phase_exact_m4096, "16": cs.phase_bounded_block,
          "17": cs.phase_pdhg_m256, "18": cs.phase_sparse_m2048,
          "19": cs.phase_general_form, "20": cs.phase_parallel,
          "21": cs.phase_last_modes, "22": cs.phase_exact_m1024,
          "23": cs.phase_dd_kernel, "24": cs.phase_lu_kernel}


def main():
    names = sys.argv[1:]
    unknown = [n for n in names if n not in PHASES]
    if not names or unknown:
        sys.exit(f"usage: run_phases.py PHASE ... with PHASE in "
                 f"{sorted(PHASES)}; got {unknown or 'none'}")
    cs.phase_environment()
    cs.phase_build()
    for name in names:
        PHASES[name]()


if __name__ == "__main__":
    main()
