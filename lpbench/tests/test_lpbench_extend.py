"""A configuration, a cell and a per-layer metric added as new files and
new manifest entries alone, with no file that is there edited."""

import json
import os
import shutil
import subprocess
import sys

from lpbench import harness


def test_new_files_and_entries_are_found(tmp_path):
    root = tmp_path
    shutil.copytree(harness.HERE, root / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    os.symlink(os.path.join(harness.ROOT, "linprog_tpu_torch"),
               root / "linprog_tpu_torch")
    before = {p: (root / "lpbench" / p).read_bytes()
              for p in os.listdir(root / "lpbench")
              if (root / "lpbench" / p).is_file()}

    lp = root / "lpbench"
    conf = json.loads((lp / "configs" / "ineq_m256.json").read_text())
    conf.update(name="ineq_m24", m=24, n=24, lanes=8, pool_batches=3)
    (lp / "configs" / "ineq_m24.json").write_text(json.dumps(conf))
    traffic = json.loads((lp / "traffic" / "simplex.json").read_text())
    traffic["sample_lanes_per_call"] = 3
    (lp / "traffic" / "simplex_small_sample.json").write_text(
        json.dumps(traffic))
    (lp / "workloads" / "ineq_m24.simplex_small_sample.json").write_text(
        (lp / "workloads" / "ineq_m256.simplex.json").read_text())
    (lp / "metrics" / "calls_seen.py").write_text(
        '"""Calls in the window."""\n\n\ndef read(run):\n'
        '    return float(run.calls)\n')

    man = harness.manifest()
    cell = "ineq_m24.simplex_small_sample"
    man["configs"].append({"name": "ineq_m24", "source": "test",
                           "file": "lpbench/configs/ineq_m24.json",
                           "reduced": ["m", "n"], "why": "test"})
    man["workloads"].append({"name": cell, "config": "ineq_m24",
                             "traffic": "simplex_small_sample", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "calls_seen", "unit": "calls",
                             "better": "higher",
                             "source": "program_counter",
                             "layer": "solver iterations",
                             "moves": "lps_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from lpbench import harness\n"
        "assert harness.HERE.startswith(%r)\n"
        "r = harness.run_cell(harness.manifest(), %r, 5, 0.5, True, 'cpu',"
        " time.time())\n"
        "print(json.dumps(r))\n" % (str(root), str(root), cell))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=root)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert r["metrics"]["calls_seen"]["value"] >= 1
    after = {p: (root / "lpbench" / p).read_bytes() for p in before}
    assert after == before
