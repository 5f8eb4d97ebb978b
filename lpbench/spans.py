"""Spans around the program's layers, taken from the benchmark's side.

:func:`stage_spans` is a copy of ``chip_smoke.py :: _stage_spans``: while
the block runs, each named module attribute is replaced by a wrapper that
brackets the call with two CUDA events, with no synchronisation, so the
run is not perturbed.  An attribute is wrapped where the caller looks it
up (``bounded.py`` binds ``solve_bounded_segment`` by name, so the span
wraps ``bounded.solve_bounded_segment``).  Additions to the copy: a probe
per span (called with the call's arguments before it, its return called
after it, both without a host read) and host-clock events for CPU tensors,
so that the CPU tests see every span fire.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU (tests only)."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


class Span(NamedTuple):
    name: str
    start: object  # event
    end: object  # event
    probe: Optional[dict]  # what the probe's finisher returned
    profiled: bool  # recorded while the profiler was on


class Recorder:
    """Holds the spans of one run, and the reference event that places
    them on one time line."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: List[Span] = []
        self.profiling = False
        self.origin = self.event()
        self.origin.record()

    def event(self):
        if self.cuda:
            return torch.cuda.Event(enable_timing=True)
        return _HostEvent()

    def intervals(self, name: str) -> List[Tuple[float, float]]:
        """``(start, end)`` in ms from the origin of each span ``name``
        (after a synchronize)."""
        return [(self.origin.elapsed_time(s.start),
                 self.origin.elapsed_time(s.end))
                for s in self.spans if s.name == name]


def resolve(target: str):
    """``"pkg.module:attr"`` -> ``(module, attr)``."""
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


@contextlib.contextmanager
def stage_spans(rec: Recorder, targets: Dict[str, List[str]],
                probes: Optional[Dict[str, Callable]] = None):
    """Wrap every ``"module:attr"`` of ``targets[name]`` so that each call
    adds a :class:`Span` ``name`` to ``rec.spans``; ``probes[name](*args,
    **kw)`` runs before the call and returns a finisher, whose result the
    span keeps."""
    probes = probes or {}
    saved = []

    def wrap(name, fn, probe):
        def timed(*args, **kw):
            t_a, t_b = rec.event(), rec.event()
            finish = probe(*args, **kw) if probe else None
            t_a.record()
            out = fn(*args, **kw)
            t_b.record()
            rec.spans.append(Span(name, t_a, t_b,
                                  finish() if finish else None,
                                  rec.profiling))
            return out
        return timed

    for name, where in targets.items():
        for target in where:
            module, attr = resolve(target)
            fn = getattr(module, attr)
            saved.append((module, attr, fn))
            setattr(module, attr, wrap(name, fn, probes.get(name)))
    try:
        yield rec
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)
