"""One run of one cell: set-up, the measured window, the reference, the
metrics.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by name: ``lpbench/configs/<config>.json``,
``lpbench/traffic/<traffic>.json`` (its ``driver`` names
``lpbench/drivers/<driver>.py``), ``lpbench/workloads/<cell>.json`` (the
limits of the comparison) and ``lpbench/metrics/<metric>.py`` (a reader
per metric, end-to-end and per-layer alike).
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from . import spans as spans_mod
from .cell import no_answer, outcomes
from .reference import compare, simplex

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(HERE, "out")
# The traced run profiles a stretch of calls from the window's second on.
PROFILE_FROM_CALL = 1
# The reference's pivot limit per row of the LP.
REFERENCE_MAXITERS_PER_ROW = 40


def _load(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _load(root, "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(man: dict, name: str):
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names
                              else [])]
    return e2e, layer


def reader(name: str):
    return importlib.import_module(f"lpbench.metrics.{name}")


class Run:
    """What the readers see of one run."""

    def __init__(self, lanes, setup_s):
        self.lanes = lanes
        self.setup_s = setup_s
        self.walls: List[float] = []
        self.window_s = 0.0
        self.mem_window_bytes = 0
        self.infos: List[dict] = []
        self.pivots = 0.0
        self.rec: Optional[spans_mod.Recorder] = None
        self.profile = None

    @property
    def calls(self) -> int:
        return len(self.walls)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _sample_lanes(rng, lanes: int, k: int) -> np.ndarray:
    return rng.choice(lanes, size=min(k, lanes), replace=False)


def window(cell, run: Run, seconds: float, device, traffic: dict,
           seed: int, trace: bool):
    """The closed loop: call after call until ``seconds`` have passed.
    Returns the sampled answers (on the device) and the lanes that gave no
    answer (a device count)."""
    rng = np.random.default_rng(seed % (1 << 64))
    k = int(traffic["sample_lanes_per_call"])
    prof_first = PROFILE_FROM_CALL
    prof_calls = int(traffic.get("profile_calls", 3))
    samples, failed = [], torch.zeros((), dtype=torch.int64, device=device)
    pivots = torch.zeros((), dtype=torch.float64, device=device)
    profiled = None
    cuda = torch.device(device).type == "cuda"  # no device trace on a CPU
    gc.collect()
    gc.disable()  # no collector pauses inside the window
    try:
        t_open = time.perf_counter()
        i = 0
        while True:
            if trace and cuda and i == prof_first:
                from .devtrace import stretch
                profiled = stretch(OUT)
                got = profiled.__enter__()
                run.rec.profiling = True
            t_a = time.perf_counter()
            ans = cell.call(i)
            _sync(device)
            t_b = time.perf_counter()
            if profiled is not None and i == prof_first + prof_calls - 1:
                run.rec.profiling = False
                profiled.__exit__(None, None, None)
                profiled = None
                run.profile = got[0]
            run.walls.append(t_b - t_a)
            run.infos.append(ans.info)
            idx = torch.as_tensor(_sample_lanes(rng, cell.lanes, k),
                                  device=device)
            idx = torch.cat([idx, ans.iters.argmax().reshape(1).to(idx.dtype)])
            samples.append((cell.key(i), idx, ans.status[idx], ans.x[idx],
                            ans.cost[idx], ans.basis[idx]))
            failed += no_answer(ans.status)
            pivots += ans.iters.double().sum()
            i += 1
            if t_b - t_open >= seconds and profiled is None:
                break
    finally:
        gc.enable()
    run.window_s = t_b - t_open
    run.pivots = float(pivots)
    return samples, int(failed)


def _unique(samples):
    """The sampled answers, one per (key, lane), sorted by key then lane:
    host tensors ``keys, lanes, status, x, cost, basis``."""
    seen = {}
    for key, idx, status, x, cost, basis in samples:
        for j, lane in enumerate(idx.tolist()):
            seen.setdefault((key, lane), (status[j], x[j], cost[j],
                                          basis[j]))
    pairs = sorted(seen)
    vals = [seen[p] for p in pairs]
    keys = torch.tensor([p[0] for p in pairs])
    lanes = torch.tensor([p[1] for p in pairs])
    status, x, cost, basis = (torch.stack([v[f] for v in vals]).cpu()
                              for f in range(4))
    return keys, lanes, status, x, cost, basis


def reference_answers(prob, maxiters: int, tf32: bool, block: int = 512):
    """The reference's answers to ``prob`` in blocks of lanes."""
    parts = []
    S = prob.A.shape[0]
    for s in range(0, S, block):
        sl = slice(s, s + block)
        parts.append(simplex.solve(prob.c[sl], prob.A[sl], prob.b[sl],
                                   prob.lb[sl], prob.ub[sl],
                                   slack_start=prob.slack_start,
                                   maxiters=maxiters, tf32=tf32))
    out = []
    for p in parts:
        out.extend(p.outcome)
    x = torch.cat([p.x for p in parts])[:, :prob.x_cols]
    at_ub = None
    if prob.bounded:
        at_ub = (torch.cat([p.vstate for p in parts]) ==
                 simplex.AT_UB)[:, :prob.x_cols]
    return compare.Answers(outcome=out, x=x,
                           cost=torch.cat([p.cost for p in parts]),
                           basis=torch.cat([p.basis for p in parts]),
                           at_ub=at_ub)


def program_answers(prob, status, x, cost, basis):
    at_ub = None
    if prob.bounded:
        ub = prob.ub[:, :prob.x_cols].cpu()
        nonbasic = torch.ones_like(ub, dtype=torch.bool)
        nonbasic.scatter_(1, basis.long().clamp(0, ub.shape[1] - 1), False)
        at_ub = nonbasic & torch.isfinite(ub) & (x.double() == ub)
    return compare.Answers(outcome=outcomes(status), x=x, cost=cost,
                           basis=torch.sort(basis.long(), dim=1).values,
                           at_ub=at_ub)


def setup_cell(config_name, traffic_name, seed, device, overrides):
    config = _load(HERE, "configs", f"{config_name}.json")
    traffic = _load(HERE, "traffic", f"{traffic_name}.json")
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    driver = importlib.import_module(f"lpbench.drivers.{traffic['driver']}")
    return config, traffic, driver.setup(config, traffic, seed, device)


def run_cell(man: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             overrides: Optional[dict] = None, control: bool = False
             ) -> dict:
    """One run; returns the result line's object (with ``compared``
    last).  ``overrides`` updates the configuration's and the traffic's
    entries (``{"config": {...}, "traffic": {...}}``: the tests' small
    sizes, the control's larger sample).  ``control`` also puts the
    reference in TF32 in the program's place and adds its compared numbers
    under ``control``; the benchmark's runs never do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = workload(man, cell_name)
    limits = _load(HERE, "workloads", f"{cell_name}.json")["limits"]
    e2e, layer = metrics_of(man, cell_name)
    wanted = layer if trace else e2e
    readers = {m["name"]: reader(m["name"]) for m in wanted}
    cuda = torch.device(device).type == "cuda"

    config, traffic, cell = setup_cell(w["config"], w["traffic"], seed,
                                       device, overrides or {})
    _sync(device)
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mem_open = torch.cuda.memory_allocated()
    run = Run(cell.lanes, time.time() - t_start)

    targets, probes = {}, {}
    for r in readers.values():
        for name, where in getattr(r, "SPANS", {}).items():
            if targets.setdefault(name, list(where)) != list(where):
                raise ValueError(f"span {name!r} declared with two targets")
        probes.update(getattr(r, "PROBES", {}))
    if trace:
        run.rec = spans_mod.Recorder(cuda)
        with spans_mod.stage_spans(run.rec, targets, probes):
            samples, failed = window(cell, run, seconds, device, traffic,
                                     seed, True)
    else:
        samples, failed = window(cell, run, seconds, device, traffic, seed,
                                 False)
    _sync(device)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1}
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        run.mem_window_bytes = peak - mem_open
        device_info["memory_peak_bytes"] = int(max(setup_peak, peak))
    if trace and run.profile is not None:
        device_info["busy_s"] = run.profile.busy_s
        device_info["window_s"] = run.profile.window_s

    values = {}
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- the program's state goes; the reference runs --------------------
    keys, lanes, status, x, cost, basis = _unique(samples)
    del samples
    prob = cell.problems(keys.to(device), lanes.to(device))
    cell.release()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    maxiters = REFERENCE_MAXITERS_PER_ROW * prob.A.shape[1]
    ref = reference_answers(prob, maxiters, tf32=False)
    got = program_answers(prob, status, x, cost, basis)
    numbers = compare.compare(got, ref, prob)
    correct = compare.judge(numbers, limits)

    result = {
        "correct": correct,
        "attempted": run.calls * run.lanes,
        "failed": failed,
        "metrics": values,
        "device": device_info,
    }
    if trace and run.profile is not None:
        top = sorted(run.profile.kernel_s.items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in run.profile.idle_by_host[:10]],
        }
    if control:
        low = reference_answers(prob, maxiters, tf32=True)
        result["control"] = compare.compare(low, ref, prob)
        result["control_correct"] = compare.judge(result["control"], limits)
    med = float(np.median(run.walls))
    result["calls"] = {"n": run.calls, "median_s": med,
                       "max_s": max(run.walls),
                       "slow": [i for i, t in enumerate(run.walls)
                                if t > 1.5 * med][:20]}
    result["sampled"] = len(ref.outcome)
    result["seen"] = {k: numbers[k] for k in compare.SEEN}
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                          for k in compare.NAMES}
    return result


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in 0..100)."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
