"""The program's own span recorder (``linprog_tpu_torch.observability``),
read by the per-layer metrics of the spans and counts inside the program.

The harness imports per-layer readers only in a traced run, so importing
this module, which turns the recorder on, records in traced runs only: a
``--trace 0`` process never records.  A program without the recorder
records nothing, and every reader here then returns None.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

try:
    from linprog_tpu_torch import observability as _obs
except ImportError:  # no program in this checkout: nothing to read
    _obs = None

REC = _obs.start() if hasattr(_obs, "start") else None


def window_calls(run) -> Optional[List[list]]:
    """The spans of the window's calls, one list a root call: the last
    ``run.calls`` recorded (the warm-up call in set-up came before them).
    None where the program recorded none."""
    if REC is None or run.calls == 0:
        return None
    calls = REC.calls()
    if len(calls) < run.calls:
        return None
    return calls[-run.calls:]


def per_call(run, of_call: Callable[[list], float]) -> Optional[float]:
    """``of_call`` summed over the window's calls, over the calls."""
    calls = window_calls(run)
    if calls is None:
        return None
    return sum(of_call(call) for call in calls) / len(calls)


def _host(v) -> float:
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)


def spans_per_call(run, name: str) -> Optional[float]:
    """How many spans ``name`` a call."""
    return per_call(run, lambda call: sum(s.name == name for s in call))


def ms_per_call(run, name: str) -> Optional[float]:
    """The time of the spans ``name``, ms a call."""
    return per_call(run, lambda call: sum(s.ms() for s in call
                                          if s.name == name))


def count_per_call(run, name: str, key: str) -> Optional[float]:
    """The count ``key`` of the spans ``name``, summed a call."""
    return per_call(run, lambda call: sum(_host(s.counts[key])
                                          for s in call if s.name == name))
