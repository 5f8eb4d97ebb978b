#!/usr/bin/env python3
"""Measure the card's calibration table and try its routing keys at scale.

Run from the repository root on a machine with a CUDA device:

    python3 tools/run_calibrate.py [--lanes 64] [--sizes 128 160 192 256 512]
                                   [--repeats 3] [--trials 11] [--out FILE]

It prints the card (nvidia-smi's name and power limit), builds the kernels,
and runs ``linprog_tpu_torch.calibration.calibrate`` ``--repeats`` times
with only the packaged ``"default"`` entry in force, so an entry already in
the data file does not colour the measurement.  Every table is printed as
one JSON line and the list is written to ``--out`` (default
``build/calibration_l<lanes>.json``, a git-ignored directory).

Then the three routing keys (``exact_simplex_max_m``,
``moderate_simplex_max_m``, ``exact_eps``) are tried one by one.  A key on
whose value the repeats disagree, or whose value is the default's, is left
alone.  Otherwise every regime (a size of ``--sizes`` at accuracy 1e-6,
1e-5 or 1e-3) that ``choose_family`` routes differently under the key is
solved with ``solve_batch_auto`` at the bench's batch (1024 lanes up to
m = 256, 128 past it) under the default table and under the key, turn and
turn about, ``--trials`` times each after a warm-up.  The key is kept when,
at every such regime, its answer holds the family's guard (a vertex family:
every lane OPTIMAL, within 1e-5 of HiGHS on 4 lanes; the interior family:
at most one lane short, within 5 times the accuracy asked) and its median
wall is not above the default's.

``seg_by_m`` and ``xover_pallas_max_m`` change the kernel settings of
every path rather than the routing; they are reported for each repeat and
never kept here.  The last line is one JSON object with the entry for
``linprog_tpu_torch/data/calibration.json`` (the kept keys, ``_measured``,
the first repeat's ``_provenance``) and what was found for each key.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from linprog_tpu_torch import calibration  # noqa: E402
from linprog_tpu_torch.router import choose_family  # noqa: E402

ROUTING_KEYS = ("exact_simplex_max_m", "moderate_simplex_max_m", "exact_eps")
ACCURACIES = (1e-6, 1e-5, 1e-3)


def _trial(m, accuracy, tables, trials):
    """``solve_batch_auto`` at size ``m`` under each of the two ``tables``
    in turn: per table the family, the median wall and the guard."""
    import torch

    import linprog_tpu_torch as lt
    from linprog_tpu_torch import status as st

    lanes = 1024 if m <= 256 else 128
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 90 + m)
    c, G, h = cs.device_inequality_lps(gen, lanes, m, m, cs.DEVICE)

    def run(table):
        calibration.set_table(table)
        return lt.solve_batch_auto(c, G, h, accuracy=accuracy)

    answers = [run(t) for t in tables]  # warm-up
    walls = [[], []]
    for _ in range(trials):
        for k, table in enumerate(tables):
            walls[k].append(cs._walled(lambda: run(table))[1])
    out = []
    for (res, info), w in zip(answers, walls):
        interior = info["family"] == "ipm"
        optimal = int((res.status == st.OPTIMAL).sum())
        gap = cs.highs_gap(res.cost, c, 4, A_ub=G, b_ub=h)
        tol = max(1e-5, 5 * accuracy) if interior else 1e-5
        out.append({"family": info["family"], "wall_s": float(np.median(w)),
                    "walls_s": w, "optimal": optimal,
                    "max_rel_gap_vs_highs": gap, "gap_tol": tol,
                    "guard": bool(optimal >= lanes - int(interior)
                                  and gap <= tol)})
    return {"m": m, "accuracy": accuracy, "lanes": lanes,
            "default": out[0], "key": out[1]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[128, 160, 192, 256, 512])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--trials", type=int, default=11)
    ap.add_argument("--out")
    args = ap.parse_args()

    cs.phase_environment()
    cs.phase_build()
    smi = cs.REPORTS["environment"]["nvidia_smi"]
    default = calibration.get_table("default")
    only_default = {"default": default}
    calibration.set_table(only_default)
    kind = calibration._device_kind()
    tables = []
    for _ in range(args.repeats):
        tables.append(calibration.calibrate(sizes=tuple(args.sizes),
                                            lanes=args.lanes)[kind])
        cs.emit({"calibration": tables[-1], "kind": kind, "nvidia_smi": smi})
    path = args.out or os.path.join("build",
                                    f"calibration_l{args.lanes}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"default": default, kind: tables}, f, indent=1)

    found = {key: {"values": [t[key] for t in tables], "kept": False,
                   "why": "changes kernel settings, not routing: reported"}
             for key in ("seg_by_m", "xover_pallas_max_m")}
    entry = {}
    for key in ROUTING_KEYS:
        values = [t[key] for t in tables]
        found[key] = rep = {"values": values, "default": default[key],
                            "kept": False}
        if len(set(values)) > 1:
            rep["why"] = "the repeats disagree"
            continue
        if values[0] == default[key]:
            rep["why"] = "equal to the default"
            continue
        under_key = {"default": default, kind: {key: values[0]}}
        moved = []
        for m in args.sizes:
            for accuracy in ACCURACIES:
                calibration.set_table(only_default)
                was = choose_family(m, accuracy)
                calibration.set_table(under_key)
                if choose_family(m, accuracy) != was:
                    moved.append((m, accuracy))
        rep["regimes"] = [_trial(m, accuracy, (only_default, under_key),
                                 args.trials) for m, accuracy in moved]
        calibration.set_table(only_default)
        if not moved:
            rep["why"] = "no regime of the grid routes differently under it"
            continue
        rep["kept"] = all(r["key"]["guard"]
                          and r["key"]["wall_s"] <= r["default"]["wall_s"]
                          for r in rep["regimes"])
        if rep["kept"]:
            entry[key] = values[0]
    entry["_measured"] = sorted(entry)
    entry["_provenance"] = tables[0]["_provenance"]
    cs.emit({"keys": found})
    cs.emit({"kind": kind, "entry": entry, "nvidia_smi": smi})


if __name__ == "__main__":
    main()
