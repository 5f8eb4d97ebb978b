#!/usr/bin/env python3
"""Checks of the program's span recorder (``observability.start``) on the
benchmark's cells, at their full size on a CUDA card.

Run from the repository root:

    python3 tools/trace_check.py bits [CELL ...]
    python3 tools/trace_check.py sitecost
    python3 tools/trace_check.py agree SECONDS SEED [SEED ...]
    python3 tools/trace_check.py overhead SECONDS SEED [SEED ...]
    python3 tools/trace_check.py alternate N_EXACT N_COLD N_SIMPLEX
    python3 tools/trace_check.py layout SECONDS SEED [SEED ...] [CELL ...]
    python3 tools/trace_check.py phase22

``bits``: one call of each batch of each cell's pool with recording off
and one with it on: ``x``, ``basis``, ``status``, ``iters``, ``cost``
compared bit for bit, and a digest of them a batch (to compare two trees'
answers on the same card); then the same calls each way under
``torch.cuda.set_sync_debug_mode("warn")``, every synchronising operation
listed by the program line it comes from (the innermost frame of the
program outside ``observability.py``), whether it goes through
``observability.host_read``, and its count with recording off and on.
``sitecost``: the host time of a span site, a decorated call and a
``host_read`` with recording off, against the bare operation.
``agree``: a traced run of each cell (the benchmark's own window) per
seed; the inside spans against the outside wrappers of ``lpbench/spans.py``
over the same calls, and the device idle a call against ``sync_wait_ms``.
``overhead``: two untraced runs of each cell per seed, recording off and
on (the order alternating from seed to seed); ``lps_per_s`` of each.
``alternate``: calls of each cell in pairs on one batch, recording off
and on in turn; the median paired difference of their walls, the spans a
call and the host time a call spent opening and closing them.
``layout``: a traced run of each cell (the three m = 256 cells, or those
named) per seed; its ``segment`` spans by kernel, mode, held columns
(``held_cols``), CTAs a lane (``cluster``) and ``branch``, and each call's
retry (``retry``'s ``lanes`` and ``crossed``) and fallback lanes, the
double-word kernel's launches on its ``polish`` and ``bounded_polish``
spans (``dd_launches``), the batched LU's kernel launches and library
calls on each root span (``lu``: ``[lu_launches, lu_library]`` a call),
the ``lu_library`` spans a call by ``op``, ``shape``, ``dtype`` and
``device`` (``lu_spans``: ``[op, shape, dtype, device, count]``),
and the time of each span name a call.
``phase22``: ``chip_smoke.py`` phase 22 with the recorder on; its kernel-1
time a run against the program's streaming-branch ``segment`` spans.
Every result is one JSON line.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import lpbench.run  # noqa: E402,F401  (one thread, as the benchmark runs)

import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import linecache  # noqa: E402
import statistics  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from collections import Counter  # noqa: E402

import torch  # noqa: E402

from lpbench import harness  # noqa: E402
from lpbench.roofline import power_limit  # noqa: E402
from linprog_tpu_torch import observability as obs  # noqa: E402

CELLS = ("ineq_m256.exact", "bounded_m256.cold", "ineq_m256.simplex")
PKG = os.path.join(ROOT, "linprog_tpu_torch")
DEVICE = "cuda"
OVERRIDES = {}  # the configuration's and traffic's entries, as the tests cut

# inside span (name, count filter) -> the outside metric over the same calls
PAIRS = (("ipm", None, "ipm_ms"), ("polish", None, "polish_ms"),
         ("batched_lu", None, "batched_lu_ms"),
         ("segment", 1, "k1_ms"), ("segment", 4, "k4_ms"),
         ("bounded_polish", None, "bounded_polish_ms"))


def out(obj):
    print(json.dumps(obj), flush=True)


def card():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"card": torch.cuda.get_device_name(0),
            "power_limit": power_limit()}


def make_cell(name, seed=1):
    man = harness.manifest(ROOT)
    w = harness.workload(man, name)
    _, _, cell = harness.setup_cell(w["config"], w["traffic"], seed, DEVICE,
                                    OVERRIDES)
    harness._sync(DEVICE)
    return cell


def calls(cell, recording):
    """One call of each batch of the cell's pool."""
    if recording:
        obs.start()
    try:
        answers = [cell.call(i) for i in range(len(cell.pool))]
        harness._sync(DEVICE)
    finally:
        obs.stop()
    return answers


def _site(stack):
    """The innermost program frame outside observability.py, and whether
    the read went through host_read."""
    routed = any(f.name == "host_read" and f.filename.endswith(
        "observability.py") for f in stack)
    for f in reversed(stack):
        if f.filename.startswith(PKG) and not f.filename.endswith(
                "observability.py"):
            rel = os.path.relpath(f.filename, ROOT)
            text = linecache.getline(f.filename, f.lineno).strip()
            return f"{rel}:{f.lineno} {text[:90]}", routed
    return "outside the program", routed


def syncs(cell, recording):
    seen = Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        site, routed = _site(stack)
        if site == "outside the program":
            site += ": " + " < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in reversed(stack[-6:]))
        seen[(site, routed)] += 1

    gc.collect()  # no collection of an earlier call's objects inside

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            calls(cell, recording)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return seen


FIELDS = ("x", "basis", "status", "iters", "cost")


def digest(answer):
    """A hash of one call's answer fields, byte for byte."""
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(getattr(answer, f).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cmd_bits(cells):
    info = card()
    for name in cells or CELLS:
        cell = make_cell(name)
        off, on = calls(cell, False), calls(cell, True)
        same = {f: all(bool(torch.equal(getattr(a, f), getattr(b, f)))
                       for a, b in zip(off, on))
                for f in FIELDS}
        s_off, s_on = syncs(cell, False), syncs(cell, True)
        sites = sorted(set(s_off) | set(s_on), key=lambda k: -s_off[k])
        out({"cell": name, **info, "batches": len(off),
             "fallback_lanes": [a.info.get("fallback") for a in off],
             "same_bits": same, "digests": [digest(a) for a in off],
             "syncs_off": sum(s_off.values()), "syncs_on": sum(s_on.values()),
             "sites": [[site, routed, s_off[(site, routed)],
                        s_on[(site, routed)]] for site, routed in sites]})
        del cell


def _per_op_us(fn, n=200_000):
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t) / n


def cmd_sitecost():
    info = card()
    obs.stop()
    flag = torch.zeros((), dtype=torch.bool)  # a host value: no device wait

    @obs.spanned("x")
    def decorated():
        return None

    def bare():
        return None

    def site():
        with obs.span("x"):
            pass

    ev = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream()

    def nvtx():
        torch.cuda.nvtx.range_push("x")
        torch.cuda.nvtx.range_pop()

    def record_function():
        with torch.profiler.record_function("x"):
            pass

    def annotate():
        with obs.annotate("x"):
            pass

    res = {"span_site_us": _per_op_us(site),
           "spanned_call_us": _per_op_us(decorated),
           "bare_call_us": _per_op_us(bare),
           "host_read_us": _per_op_us(lambda: obs.host_read(bool, flag)),
           "bare_read_us": _per_op_us(lambda: bool(flag))}
    res.update({
        "event_new_us": _per_op_us(
            lambda: torch.cuda.Event(enable_timing=True), 20_000),
        "event_new_record_us": _per_op_us(
            lambda: torch.cuda.Event(enable_timing=True).record(), 20_000),
        "event_record_us": _per_op_us(ev.record, 20_000),
        "event_record_on_stream_us": _per_op_us(
            lambda: ev.record(stream), 20_000),
        "current_stream_us": _per_op_us(torch.cuda.current_stream, 20_000),
        "profiler_enabled_us": _per_op_us(
            torch._C._autograd._profiler_enabled, 20_000),
        "nvtx_us": _per_op_us(nvtx, 20_000),
        "record_function_us": _per_op_us(record_function, 20_000),
        "annotate_us": _per_op_us(annotate, 20_000),
        "is_available_us": _per_op_us(torch.cuda.is_available, 20_000)})
    obs.start()
    with obs.span("root"):  # sites inside a call, as the program's are
        res["on_span_site_us"] = _per_op_us(site, 20_000)
    obs.stop()
    torch.cuda.synchronize()
    out({"sitecost": res, **info})


def _desc(call, top, names):
    """The spans of ``call`` named in ``names`` below ``top``."""
    found = []
    for s in call:
        p = s.parent
        while p is not None and p is not top:
            p = p.parent
        if p is top and s.name in names:
            found.append(s)
    return found


def inside_per_call(calls):
    n = len(calls)
    got = {}
    for name, kernel, metric in PAIRS:
        ms = [s.ms() for c in calls for s in c if s.name == name
              and (kernel is None or s.counts.get("kernel") == kernel)]
        if ms:
            got[metric] = sum(ms) / n
    self_ms = 0.0
    seen = False
    for c in calls:
        for x in (s for s in c if s.name == "crossover"):
            seen = True
            inner = [s for s in _desc(c, x, ("polish", "batched_lu",
                                             "segment"))
                     if s.name != "segment" or s.counts.get("kernel") == 1]
            # spans nested in another of these are inside it already
            inner = [s for s in inner if s.parent.name not in (
                "polish", "batched_lu", "segment")]
            self_ms += x.ms() - sum(s.ms() for s in inner)
    if seen:
        got["crossover_ms"] = self_ms / n
    return got


def cmd_agree(seconds, seeds):
    info = card()
    from lpbench.metrics import _program

    man = harness.manifest(ROOT)
    for name in CELLS:
        for seed in seeds:
            r = harness.run_cell(man, name, seed, seconds, True, DEVICE,
                                 time.time(), OVERRIDES)
            n = r["calls"]["n"]
            calls = _program.REC.calls()[-n:]
            inside = inside_per_call(calls)
            m = {k: v["value"] for k, v in r["metrics"].items()}
            cmp = {}
            for k, v in inside.items():
                if k in m:
                    d = abs(v - m[k])
                    cmp[k] = [v, m[k], d <= max(0.05 * m[k], 0.5)]
            idle_ms = None
            if "device_idle_pct" in m:
                idle_ms = m["device_idle_pct"] / 100 * 1e3 * r["calls"][
                    "median_s"]
            out({"cell": name, "seed": seed, **info,
                 "correct": r["correct"], "calls": n,
                 "median_call_s": r["calls"]["median_s"], "metrics": m,
                 "inside_vs_outside": cmp, "idle_ms_a_call": idle_ms,
                 "device": r["device"], "breakdown": r.get("breakdown")})


def cmd_layout(seconds, seeds, cells=CELLS):
    info = card()
    from lpbench.metrics import _program

    man = harness.manifest(ROOT)
    for name in cells:
        for seed in seeds:
            r = harness.run_cell(man, name, seed, seconds, True, DEVICE,
                                 time.time(), OVERRIDES)
            n = r["calls"]["n"]
            seen = Counter()
            paths = []  # each call's retry and fallback, in window order
            span_ms = Counter()  # ms a call by span name (nested included)
            dd = []  # each call's dd kernel launches in its polish spans
            lu = []  # each call's batched LU: kernel launches, library calls
            lu_spans = []  # each call's lu_library spans, tallied
            for call in _program.REC.calls()[-n:]:
                dd.append([sp.counts.get("dd_launches", 0) for sp in call
                           if sp.name in ("polish", "bounded_polish")])
                lu.append([call[0].counts.get("lu_launches"),
                           call[0].counts.get("lu_library")])
                tally = Counter((sp.counts["op"], sp.counts["shape"],
                                 sp.counts["dtype"], sp.counts["device"])
                                for sp in call if sp.name == "lu_library")
                lu_spans.append([[*k, v] for k, v in sorted(tally.items())])
                for sp in call:
                    span_ms[sp.name] += sp.ms() / n
                for sp in call:
                    if sp.name == "segment":
                        c = sp.counts
                        seen[(c["kernel"], c["mode"], c.get("held_cols"),
                              c.get("cluster"), c.get("branch"))] += 1
                counts = {sp.name: sp.read_counts() for sp in call
                          if sp.name in ("retry", "fallback")}
                paths.append({
                    "retry_lanes": counts.get("retry", {}).get("lanes", 0),
                    "retry_crossed": counts.get("retry", {}).get("crossed",
                                                                 0),
                    "fallback": counts.get("fallback", {}).get("lanes", 0),
                    "profiled": getattr(call[0], "profiled", None)})
            out({"cell": name, "seed": seed, **info, "correct": r["correct"],
                 "calls": n, "segments": [[*k, v] for k, v in
                                          sorted(seen.items())],
                 "paths": paths, "dd_launches": dd, "lu": lu,
                 "lu_spans": lu_spans,
                 "span_ms_a_call": dict(span_ms),
                 "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                 "device": r["device"], "breakdown": r.get("breakdown")})


def cmd_phase22():
    """``chip_smoke.py`` phase 22 (the m = 1024 exact leg on its own batch)
    with the recorder on: each timed run's kernel-1 time as the phase's
    outside wrapper reads it, against the program's ``segment`` spans of
    kernel 1's streaming branch in the same call (what ``k1_stream_ms``
    reads)."""
    info = card()
    import chip_smoke

    rec = obs.start()
    failed = None
    try:
        chip_smoke.phase_exact_m1024()
    except SystemExit as err:  # a guard of the phase failed; it reported
        failed = str(err)
    finally:
        obs.stop()
    rep = chip_smoke.REPORTS["exact_m1024"]
    outside = [1e3 * s for s in rep["segment_kernel_s"]]
    roots = [c for c in rec.calls() if c[0].name == "solve_batch_exact"]
    inside, branches = [], Counter()
    for call in roots[-len(outside):]:
        k1 = [s for s in call if s.name == "segment"
              and s.counts["kernel"] == 1]
        branches.update((s.counts["branch"], s.counts["cluster"])
                        for s in k1)
        inside.append(sum(s.ms() for s in k1
                          if s.counts["branch"] == "stream"))
    out({"phase": 22, **info, "outside_ms": outside, "inside_ms": inside,
         "ratio": [a / b for a, b in zip(inside, outside)],
         "kernel1_branch_cluster": [[*k, v] for k, v in branches.items()],
         "wall_s": rep["wall_s"], "crossed": rep["crossed"],
         "retry_crossed": rep["retry_crossed"],
         "fallback": rep["fallback"], "certified": rep["certified"],
         "phase_failed": failed})


def cmd_overhead(seconds, seeds):
    info = card()
    man = harness.manifest(ROOT)
    for name in CELLS:
        for k, seed in enumerate(seeds):
            row = []
            for recording in ((False, True) if k % 2 == 0 else (True, False)):
                obs.stop()
                if recording:
                    obs.start()
                r = harness.run_cell(man, name, seed, seconds, False,
                                     DEVICE, time.time(), OVERRIDES)
                obs.stop()
                row.append([recording, r["metrics"]["lps_per_s"]["value"],
                            r["calls"]["median_s"], r["correct"]])
            on = statistics.mean(v[1] for v in row if v[0])
            off = statistics.mean(v[1] for v in row if not v[0])
            out({"cell": name, "seed": seed, **info, "runs": row,
                 "cost_pct": 100.0 * (off - on) / off})


def cmd_alternate(n_calls):
    """Calls in pairs on each batch, recording off and on in turn: the
    paired difference of their walls, and the host time a call spent
    opening and closing spans."""
    info = card()
    spent = [0.0]
    enter, exit_ = obs.Span.__enter__, obs.Span.__exit__

    def timed(fn):
        def inner(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[0] += time.perf_counter() - t
        return inner

    obs.Span.__enter__, obs.Span.__exit__ = timed(enter), timed(exit_)
    for name in CELLS:
        cell = make_cell(name)
        n = n_calls[name]
        walls = {False: [], True: []}
        spans, host_s = [], []
        for i in range(n):
            for recording in ((False, True) if i % 2 == 0 else (True, False)):
                obs.stop()
                rec = obs.start() if recording else None
                spent[0] = 0.0
                harness._sync(DEVICE)
                t = time.perf_counter()
                cell.call(i)
                harness._sync(DEVICE)
                walls[recording].append(time.perf_counter() - t)
                obs.stop()
                if rec is not None:
                    spans.append(len(rec.calls()[-1]))
                    host_s.append(spent[0])
        diff = [b - a for a, b in zip(walls[False], walls[True])]
        med = statistics.median(walls[False])
        out({"cell": name, **info, "pairs": n,
             "median_off_s": med, "median_on_s": statistics.median(walls[True]),
             "median_diff_ms": 1e3 * statistics.median(diff),
             "median_diff_pct": 100 * statistics.median(diff) / med,
             "on_slower_pairs": sum(d > 0 for d in diff),
             "spans_a_call": statistics.mean(spans),
             "span_host_ms_a_call": 1e3 * statistics.mean(host_s)})
        del cell
    obs.Span.__enter__, obs.Span.__exit__ = enter, exit_


def main(argv):
    if argv and argv[0] == "alternate":
        if not torch.cuda.is_available():
            sys.exit("trace_check: needs a CUDA card")
        cmd_alternate(dict(zip(CELLS, (int(a) for a in argv[1:4]))))
        return
    if not argv or argv[0] not in ("bits", "sitecost", "agree", "overhead",
                                   "layout", "phase22"):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("trace_check: needs a CUDA card")
    if argv[0] == "bits":
        cmd_bits(argv[1:])
    elif argv[0] == "sitecost":
        cmd_sitecost()
    elif argv[0] == "phase22":
        cmd_phase22()
    else:
        fn = {"agree": cmd_agree, "overhead": cmd_overhead,
              "layout": cmd_layout}[argv[0]]
        seeds = [int(a) for a in argv[2:] if a.isdigit()]
        cells = [a for a in argv[2:] if not a.isdigit()]
        if cells and argv[0] != "layout":
            sys.exit(__doc__)
        fn(float(argv[1]), seeds, *([cells] if cells else []))


if __name__ == "__main__":
    main(sys.argv[1:])
