"""Readers of the program's ``retry`` span and of the ``branch`` its
kernel wrappers note on each ``segment`` span (the streaming branches of
kernels 1 and 3, past the m = 512 lines).

The program notes ``branch`` on every segment launch it records, so a
window whose segment spans carry none comes from a program that has
neither the count nor the ``retry`` span: every reader then returns None.
On a program that has them, a window in which no retry fired, or no
launch ran a branch, reads 0.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from ..roofline_stream import launch_bound_s
from ._program import _host, window_calls


def _noting(calls) -> bool:
    return any("branch" in s.counts for call in calls for s in call
               if s.name == "segment")


def calls_of(run) -> Optional[list]:
    """The window's calls where the program notes ``branch``, else None."""
    calls = window_calls(run)
    if calls is None or not _noting(calls):
        return None
    return calls


def per_call(run, of_call: Callable[[list], float]) -> Optional[float]:
    calls = calls_of(run)
    if calls is None:
        return None
    return sum(of_call(call) for call in calls) / len(calls)


def launches(call, kernel: int, branch: Optional[str] = None) -> list:
    """The call's ``segment`` spans of ``kernel`` (and ``branch``)."""
    return [s for s in call if s.name == "segment"
            and s.counts.get("kernel") == kernel
            and (branch is None or s.counts.get("branch") == branch)]


def segment_ms(run, kernel: int, branch: Optional[str] = None
               ) -> Optional[float]:
    """The time of those launches, ms a call."""
    return per_call(run, lambda call: sum(s.ms() for s in launches(
        call, kernel, branch)))


def retry_count(run, key: str) -> Optional[float]:
    """The count ``key`` of the ``retry`` spans, summed a call."""
    return per_call(run, lambda call: sum(_host(s.counts[key]) for s in call
                                          if s.name == "retry"))


def retry_ms(run) -> Optional[float]:
    return per_call(run, lambda call: sum(s.ms() for s in call
                                          if s.name == "retry"))


def roofline_pct(run, kernel: int, branch: Optional[str],
                 symbols: Sequence[str]) -> Optional[float]:
    """The least time of the launches in the profiled calls
    (``lpbench/roofline_stream.py``) over the profiler's device time of the
    kernel's symbols there, in %.  None where no profiled call ran such a
    launch or the trace shows none of the symbols."""
    calls = calls_of(run)
    if calls is None or run.profile is None:
        return None
    spans = [s for call in calls if getattr(call[0], "profiled", False)
             for s in launches(call, kernel, branch)]
    device = sum(v for k, v in run.profile.kernel_s.items()
                 if any(sym in k for sym in symbols))
    if not spans or device <= 0:
        return None
    least = 0.0
    for s in spans:
        _, m, n = s.counts["shape"]
        least += launch_bound_s(m, n, _host(s.counts["pivots"]))
    return 100.0 * least / device
