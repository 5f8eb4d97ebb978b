"""Span arithmetic shared by the per-layer readers."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..roofline import launch_bound_s


def per_call_ms(run, name: str) -> Optional[float]:
    """The span's total over the window divided by the calls; None where
    it never fired."""
    iv = run.rec.intervals(name)
    if not iv:
        return None
    return sum(b - a for a, b in iv) / run.calls


def self_per_call_ms(run, name: str, children: Sequence[str]
                     ) -> Optional[float]:
    """As :func:`per_call_ms`, less the time of the child spans that lie
    inside each of its spans."""
    iv = run.rec.intervals(name)
    if not iv:
        return None
    inner = [c for child in children for c in run.rec.intervals(child)]
    total = 0.0
    for a, b in iv:
        total += b - a
        total -= sum(min(d, b) - max(c, a) for c, d in inner
                     if c < b and d > a)
    return total / run.calls


def segment_probe(*args, **kw):
    """Before a segment launch: its shape, the running lanes and the
    iteration counts (device copies, no host read); the finisher returns
    the pivots the launch did."""
    A = args[0]
    state = next(a for a in args if hasattr(a, "iters")
                 and hasattr(a, "status"))
    before = state.iters.clone()
    running = (state.status == 0).sum()

    def finish():
        return {"shape": tuple(A.shape), "running": running,
                "pivots": (state.iters - before).sum()}
    return finish


def roofline_pct(run, name: str, symbols: Sequence[str]) -> Optional[float]:
    """The least time of the launches inside the profiled stretch over the
    profiler's device time of the kernel's symbols there, in %.  None where
    the profiler shows none of them: the metric is then left out of the
    result, never read from the spans."""
    spans = [s for s in run.rec.spans if s.name == name and s.profiled]
    if not spans or run.profile is None:
        return None
    device = sum(v for k, v in run.profile.kernel_s.items()
                 if any(sym in k for sym in symbols))
    if device <= 0:
        return None
    least = 0.0
    for s in spans:
        _, m, n = s.probe["shape"]
        least += launch_bound_s(int(s.probe["running"]), m, n,
                                int(s.probe["pivots"]))
    return 100.0 * least / device
