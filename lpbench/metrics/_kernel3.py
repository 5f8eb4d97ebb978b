"""Readers of kernel 3's launches by the exact router's path (the
crossover, or the two-phase fallback and its repair under the ``fallback``
span) and of the ``lu_library`` spans (``engine.inv_or_nan`` /
``solve_or_nan`` calls that went to ``torch.linalg``)."""

from __future__ import annotations

from typing import Optional

from ._branch import launches, per_call
from ._program import _host, window_calls


def under(span, name: str) -> bool:
    """Whether a span ``name`` is among ``span``'s ancestors."""
    p = span.parent
    while p is not None:
        if p.name == name:
            return True
        p = p.parent
    return False


def k3_ms(run, in_fallback: bool) -> Optional[float]:
    """Kernel 3's ``segment`` spans with (or without) a ``fallback``
    ancestor, ms a call; None where the program notes no ``branch``."""
    return per_call(run, lambda call: sum(
        s.ms() for s in launches(call, 3)
        if under(s, "fallback") == in_fallback))


def lu_library_ms(run) -> Optional[float]:
    """The ``lu_library`` spans, ms a call.  Where the window holds none:
    0 if every root call notes ``lu_library`` (its CUDA factorizations on
    ``torch.linalg``) and they add up to 0; None otherwise, since a
    program that counts library calls but records no span is a program
    without the span."""
    calls = window_calls(run)
    if calls is None:
        return None
    if any(s.name == "lu_library" for call in calls for s in call):
        return sum(s.ms() for call in calls for s in call
                   if s.name == "lu_library") / len(calls)
    roots = [call[0].counts.get("lu_library") for call in calls]
    if any(v is None for v in roots) or sum(_host(v) for v in roots) > 0:
        return None
    return 0.0
