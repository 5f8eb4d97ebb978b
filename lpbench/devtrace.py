"""A ``torch.profiler`` window over a stretch of calls, read back.

The stretch is marked with a ``record_function`` range on the host; the
trace is exported as Chrome JSON under ``lpbench/out/``, read, and
deleted.  From it: the seconds in which an operation ran on the device
(kernels, copies and sets, intervals merged) within the stretch, the
stretch's length, each kernel's device seconds, and the idle gaps labelled
by the host operation that overlaps each most.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import torch

STRETCH = "lpbench_stretch"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


class Profile(NamedTuple):
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]  # device seconds by short kernel name
    idle_by_host: List[Tuple[str, float]]  # gap seconds by host operation


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces (as
    ``(anonymous namespace)::`` or ``<unnamed>::``), template arguments
    and parameters."""
    for anon in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(anon, "")
    name = name.split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].strip()[:120]


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(path: str) -> Profile:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == STRETCH
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("profile: the stretch's range is not in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernel_s = [], defaultdict(float)
    for e in events:
        if e.get("cat") in _DEVICE_CATS and "dur" in e:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
                if e.get("cat") == "kernel":
                    kernel_s[short_name(e["name"])] += (b - a) * 1e-6
                else:
                    kernel_s[e["cat"]] += (b - a) * 1e-6
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") in _HOST_CATS and "dur" in e)
    starts = [h[0] for h in host]
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle = defaultdict(float)
    for a, b in gaps:
        # the host operation that overlaps the gap most (the later one on
        # a tie: the innermost)
        i = bisect.bisect_left(starts, b) - 1
        label, best = "host: none", 0.0
        for j in range(i, max(i - 400, -1), -1):
            over = min(host[j][1], b) - max(host[j][0], a)
            if over > best:
                label, best = host[j][2][:120], over
        idle[label] += (b - a) * 1e-6
    return Profile(busy_s=busy_s, window_s=(w1 - w0) * 1e-6,
                   kernel_s=dict(kernel_s),
                   idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def stretch(out_dir: str):
    """Profile the block; yields a list that receives the :class:`Profile`
    on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function

    got: List[Profile] = []
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            yield got
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        got.append(read_trace(path))
    finally:
        os.remove(path)
