"""Run one cell of the benchmark once on the card and print its result.

    python3 lpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``lpbench/``
and the program, ``linprog_tpu_torch``.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device`` and, traced, ``breakdown``; ``compared`` comes last:
each number the comparison with the reference read, beside its limit.
The same numbers are the last lines of standard error.

Exit codes: 0 a result was printed; 2 no card, or fewer than the cell
asks for; 3 the program could not be found in this checkout; 4 a module
of the JAX package (or of its benchmark) was loaded in this process.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one process with few threads: the host's share of a call stays steady
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# Top-level module names that must not be loaded by a run, compared whole
# (the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "linprog_tpu", "chip_smoke", "bench",
             "benchmarks")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _env():
    """Keep every cache of the program inside the checkout, and the
    program's settings at their packaged values."""
    os.environ.pop("LINPROG_TPU_TORCH_CALIBRATION", None)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    # the checkout's root, not this folder, is where imports start
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE, ROOT)]

    import torch

    torch.set_num_threads(1)
    from lpbench import harness

    man = harness.manifest(ROOT)
    chips = harness.workload(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lpbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    try:
        import linprog_tpu_torch
    except ImportError as err:
        print(f"lpbench: the program is not in this checkout ({err})",
              file=sys.stderr)
        return 3
    where = os.path.dirname(os.path.abspath(linprog_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        print(f"lpbench: linprog_tpu_torch was loaded from {where}, not "
              f"from this checkout", file=sys.stderr)
        return 3

    from lpbench.roofline import power_limit

    print(f"lpbench: {args.workload} seed {args.seed} on {power_limit()}",
          file=sys.stderr)
    result = harness.run_cell(man, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"lpbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
