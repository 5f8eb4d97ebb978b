"""Observability: structured solve summaries, residuals, profiling hooks
and the in-memory span recorder (counterpart of
:mod:`linprog_tpu.observability`).

* :func:`solution_quality` -- per-instance quality metrics of a batch
  (primal residual ``||Ax - b||_inf``, bound violation, objective),
  computed on the batch's device.
* :func:`solve_report` -- host-side structured summary (dict) for logging
  and JSON.
* :func:`trace` -- a ``torch.profiler`` window around a region, written as
  a Chrome trace; :func:`annotate` names a region in it (and, on a card,
  in an NVTX range).
* :func:`start` / :func:`stop` -- the span recorder (:class:`Recorder`).
  It starts off.  Off, a span site costs one check of a module-level
  reference and returns a shared no-op, and :func:`host_read` is the read
  itself.  On, each span holds its name, a start and an end event
  (``torch.cuda.Event`` on a card, the host clock on a CPU), its parent,
  the id of the root call it belongs to and a small dict of counts; the
  first span opened with no span open is the root of a call.  While a
  ``torch.profiler`` trace is being taken, every span also opens
  :func:`annotate` with its name, so the trace holds the spans as nested
  ranges on its own clock (and NVTX ranges on a card).
  Recording changes no result and adds no host synchronisation: counts
  that live on the device stay device tensors until they are read.

Recording, reading a call's spans, and seeing them in a trace::

    from linprog_tpu_torch import observability as obs

    obs.start()
    res, info = solve_batch_exact(c, G, h)
    with obs.trace("/tmp/trace"):          # ranges inside the trace
        solve_batch_exact(c, G, h)
    rec = obs.stop()
    for call in rec.calls():                # one list per root call
        for sp in call:                     # the root first, then in order
            print(sp.name, sp.parent.name if sp.parent else None,
                  sp.ms(), sp.read_counts())

Spans (name: where; counts):

* ``solve_batch_exact``, ``solve_batch_two_phase``,
  ``solve_batch_bounded``: the entry points of the same names (a root, or
  a child where one runs inside another, as the exact router's fallback
  does).
* ``ipm``: :func:`ipm._ipm_core`; ``steps``, the Newton loop's count.
* ``crossover``: :func:`crossover.crossover_batch_canonical`; ``rounds``
  (repair rounds with lanes in them) and ``uncrossed`` (the lanes it did
  not cross, by status code); its children ``xover.guess`` (the basis
  guess, its inverse and ``bfs0``), ``xover.refactor`` (the exact
  refactorization after each dual phase) and ``xover.verify`` (the
  terminal dd solve and its check).
* ``segment``: one kernel launch of a segment loop; ``kernel`` (1, 3 or
  4), ``mode``, the device counts ``running`` (lanes running at the
  launch) and ``pivots`` (pivots it did), ``shape`` (A's), ``held_cols``
  (the columns of A it held in shared memory: kernel 1's ``n_d`` in its
  unit layout, else n), ``cluster`` (its CTAs a lane; 0 for a plain
  version) and ``branch`` (kernels 1 and 4: ``"resident"`` for the
  cluster-resident branch, ``"stream"`` for the streaming one; kernel 3,
  which streams in every mode: ``"stream"``; ``"plain"`` for a plain
  version).
* ``batched_lu``: :func:`engine_batched.refresh_running_lanes`.
* ``lu_library``: each call of :func:`engine.inv_or_nan` or
  :func:`engine.solve_or_nan` that goes to ``torch.linalg`` (every one
  the batched LU kernel does not take, wherever it opens); ``op``
  (``"inv"`` or ``"solve"``), ``shape``, ``dtype`` and ``device`` (type)
  of the matrices factored.
* ``polish`` and ``bounded_polish``: :func:`refine.polish_batch` and
  :func:`refine.polish_bounded_batch`; ``pivots``, the rounds that
  pivoted, and ``dd_launches``, the double-word kernel's launches inside
  it (0 where a CPU tensor takes the plain version).
* ``retry``: the exact router's retry of the uncrossed lanes (the
  gathered bucket's IPM and crossover, whose ``ipm`` and ``crossover``
  spans are its children, and the merge); ``lanes`` (uncrossed before
  it), ``bucket``, ``crossed`` (``info["retry_crossed"]``) and ``guess``.
* ``fallback``: the exact router's two-phase fallback with its repair
  crossover; ``lanes``, ``bucket`` and ``reason`` (the uncrossed lanes by
  the status code they carry out of the IPM, a device count; the
  crossover's ``uncrossed`` says why it did not cross them).
* ``host_read``: each blocking read of a device value on these paths
  (:func:`host_read`).  On a card its events bracket the read, so its
  device time is the stretch in which the queue stood empty waiting for
  the host to come back.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from . import status as st
from .results import BatchResult


def solution_quality(c, A, b, x) -> dict:
    """Per-instance quality metrics of a batch: ``c[B, n], A[B, m, n],
    b[B, m], x[B, n]`` -> primal residual (inf-norm), nonnegativity
    violation and objective value, each ``[B]``."""
    Ax = torch.einsum("bmn,bn->bm", A, x)
    resid = torch.abs(Ax - b).max(dim=1).values
    neg = torch.clamp_min(-x.min(dim=1).values, 0.0) + 0.0  # never -0.0
    obj = (c * x).sum(dim=1)
    return {"primal_residual": resid, "bound_violation": neg, "objective": obj}


def solve_report(result: BatchResult, c=None, A=None, b=None) -> dict:
    """Host-side structured summary of a batched solve."""
    status = result.status.cpu().numpy()
    iters = result.iters.cpu().numpy()
    report = {
        "lanes": int(status.shape[0]),
        "status_counts": {
            st.STATUS_NAMES[code]: int((status == code).sum())
            for code in np.unique(status)
        },
        "iters": {
            "total": int(iters.sum()),
            "mean": float(iters.mean()),
            "max": int(iters.max()),
        },
    }
    if c is not None and A is not None and b is not None:
        q = solution_quality(c, A, b, result.x)
        report["quality"] = {
            "max_primal_residual": float(q["primal_residual"].max()),
            "max_bound_violation": float(q["bound_violation"].max()),
        }
    return report


@contextlib.contextmanager
def annotate(label: str):
    """Name a region in profiler timelines: a ``record_function`` range,
    and an NVTX range where there is a card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, label: str = "linprog_solve"):
    """Profile a solve region.  With ``logdir`` a ``torch.profiler`` window
    (host and, where there is a card, device activity) is written there as
    a Chrome trace, ``<label>.<pid>.trace.json``; the region is one range
    named ``label``.  ``trace.last_elapsed_s`` holds the region's wall
    time (the device is synchronised first where there is a card).

    Usage::

        with observability.trace("/tmp/trace"):
            res = solve_batch_two_phase(...)
    """
    t0 = time.perf_counter()
    prof = None
    if logdir is not None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    try:
        with annotate(label):
            yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(logdir, f"{label}.{os.getpid()}.trace.json"))
        trace.last_elapsed_s = time.perf_counter() - t0


trace.last_elapsed_s = None


# ---- the span recorder ----------------------------------------------------


class _HostEvent:
    """The host clock in the place of ``torch.cuda.Event`` (no card)."""

    __slots__ = ("t",)

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


class Recorder:
    """The spans of the last ``KEEP_CALLS`` root calls, in memory; timed
    with CUDA events where there is a card (on the stream current when
    the root call opened), else with the host clock."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self._calls = collections.deque(maxlen=KEEP_CALLS)
        self._ids = itertools.count()
        self._local = threading.local()

    def event(self):
        if self.cuda:
            return torch.cuda.Event(enable_timing=True)
        return _HostEvent()

    def thread(self):
        """This thread's open spans (``open``, the innermost last), the
        list of spans of its current root call (``call``) and the stream
        its events are recorded on (``stream``)."""
        state = getattr(self._local, "state", None)
        if state is None:
            state = self._local.state = _ThreadState()
        return state

    def calls(self) -> list:
        """The recorded root calls, oldest first: each a list of its
        :class:`Span` s, the root first, then in the order they opened."""
        return [list(call) for call in self._calls]


class _ThreadState:
    __slots__ = ("open", "call", "stream")

    def __init__(self):
        self.open, self.call, self.stream = [], None, None


class Span:
    """One span: ``name``, ``parent`` (None for a root), ``root`` (the id
    of its root call), ``counts``, the ``start`` / ``end`` events and
    ``profiled`` (opened while a ``torch.profiler`` trace was taken)."""

    __slots__ = ("name", "parent", "root", "counts", "start", "end",
                 "profiled", "_rec", "_state", "_range")

    def __init__(self, rec: Recorder, name: str):
        self._rec = rec
        self.name = name
        self.counts = {}

    def __bool__(self):
        return True

    def __enter__(self):
        rec = self._rec
        state = self._state = rec.thread()
        if state.open:
            self.parent = state.open[-1]
            self.root = self.parent.root
        else:
            self.parent = None
            self.root = next(rec._ids)
            state.call = []
            rec._calls.append(state.call)
            # one stream lookup a call (it costs as much as a record)
            state.stream = torch.cuda.current_stream() if rec.cuda else None
        state.call.append(self)
        state.open.append(self)
        self._rec = None  # spans kept for reading hold no recorder
        # a range in the torch.profiler trace where one is being taken
        # (record_function costs ~10 us a span and records nothing else)
        self.profiled = torch._C._autograd._profiler_enabled()
        self._range = annotate(self.name) if self.profiled else None
        if self._range is not None:
            self._range.__enter__()
        self.start, self.end = rec.event(), rec.event()
        self.start.record(state.stream)
        return self

    def __exit__(self, *exc):
        state = self._state
        self.end.record(state.stream)
        state.open.pop()
        self._state = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False

    def set(self, **counts) -> None:
        """Add counts: host numbers, or device tensors read only by
        :meth:`read_counts`."""
        self.counts.update(counts)

    def ms(self) -> float:
        """The span's time in ms (waits for its end event on a card)."""
        self.end.synchronize()
        return self.start.elapsed_time(self.end)

    def read_counts(self) -> dict:
        """``counts`` with device tensors read to host numbers (a list for
        a tensor of more than one element)."""
        return {k: (v.tolist() if isinstance(v, torch.Tensor) else v)
                for k, v in self.counts.items()}


class _NoSpan:
    """What a span site gets while recording is off."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_NO_SPAN = _NoSpan()
# root calls a recorder keeps (a benchmark window holds a few hundred)
KEEP_CALLS = 4096
# the recording flag: None while recording is off
_recorder: Optional[Recorder] = None


def start() -> Recorder:
    """Turn recording on (a no-op if it is on) and return the
    recorder."""
    global _recorder
    if _recorder is None:
        _recorder = Recorder()
    return _recorder


def stop() -> Optional[Recorder]:
    """Turn recording off; returns the recorder that was on (or None)."""
    global _recorder
    rec, _recorder = _recorder, None
    return rec


def span(name: str):
    """A span ``name`` around a ``with`` block: a :class:`Span` while
    recording is on, else the shared no-op (falsy, so a site computes a
    device count only under ``if sp:``)."""
    rec = _recorder
    if rec is None:
        return _NO_SPAN
    return Span(rec, name)


def spanned(name: str):
    """Decorator: the function's calls as spans ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            rec = _recorder
            if rec is None:
                return fn(*args, **kw)
            with Span(rec, name):
                return fn(*args, **kw)
        return inner
    return wrap


def current():
    """The innermost open span of this thread (the no-op where none is
    open or recording is off)."""
    rec = _recorder
    if rec is None:
        return _NO_SPAN
    open_ = rec.thread().open
    return open_[-1] if open_ else _NO_SPAN


def note(name: str, **counts) -> None:
    """Add ``counts`` to the innermost open span where it is a span
    ``name`` (a no-op otherwise, and while recording is off): how a callee
    reports on the span its caller opened, as a kernel's wrapper gives the
    ``segment`` span its launch's layout."""
    sp = current()
    if sp and sp.name == name:
        sp.set(**counts)


def host_read(read, *args, **kw):
    """``read(*args, **kw)``, a read that makes the host wait for the
    device (``bool`` or ``int`` of a device scalar, ``torch.nonzero``,
    ``Tensor.tolist``), as a span ``host_read`` while recording is on."""
    rec = _recorder
    if rec is None:
        return read(*args, **kw)
    with Span(rec, "host_read"):
        return read(*args, **kw)


def by_status(status, mask=None):
    """Lanes by status code, ``[len(STATUS_NAMES)]`` int64 on the lanes'
    device, over the lanes of ``mask`` (all where None); compares and sums
    where ``torch.bincount`` on a card would read its maximum on the
    host."""
    codes = torch.arange(len(st.STATUS_NAMES), device=status.device)
    hit = status.long()[:, None] == codes
    if mask is not None:
        hit = hit & mask[:, None]
    return hit.sum(dim=0)
