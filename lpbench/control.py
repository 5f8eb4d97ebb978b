"""Readings that the comparison's limits are set from, on the card.

    python3 lpbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--sample <lanes a call>]

For each seed, in one process: the cell's set-up (with ``--vary-data``
on LPs made from that seed) and a window of
``--seconds`` of the program, then the reference on the sampled answers
(float64) and the control, the same reference in TF32 put in the
program's place.  Prints one JSON line a seed with both sides' compared
numbers, then the lower readings (the largest the program gave) and the
upper ones (the smallest the control gave).  The benchmark's own runs
never run the control.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sample", type=int, default=None)
    ap.add_argument("--vary-data", action="store_true",
                    help="make each seed's LPs from the seed itself (the "
                         "configuration's data_seed otherwise)")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE, ROOT)]
    import torch

    from lpbench import harness
    from lpbench.reference.compare import NAMES

    if not torch.cuda.is_available():
        print("lpbench control: no CUDA card", file=sys.stderr)
        return 2
    man = harness.manifest(ROOT)
    over = {}
    if args.sample is not None:
        over["traffic"] = {"sample_lanes_per_call": args.sample}
    lows, highs = [], []
    for seed in args.seeds:
        if args.vary_data:
            over["config"] = {"data_seed": seed}
        t0 = time.time()
        r = harness.run_cell(man, args.workload, seed, args.seconds, False,
                             "cuda", t0, over, control=True)
        program = {k: v["value"] for k, v in r["compared"].items()}
        lows.append(program)
        highs.append(r["control"])
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "control_correct": r["control_correct"],
                          "calls": r["attempted"], "sampled": r["sampled"],
                          "program": program, "control": r["control"],
                          "seconds": time.time() - t0}), flush=True)
    print(json.dumps({
        "workload": args.workload, "seeds": args.seeds,
        "lower": {k: max(p[k] for p in lows) for k in NAMES},
        "upper": {k: min(p[k] for p in highs) for k in NAMES}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
