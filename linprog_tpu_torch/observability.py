"""Observability: structured solve summaries, residuals, profiling hooks
(counterpart of :mod:`linprog_tpu.observability`).

* :func:`solution_quality` -- per-instance quality metrics of a batch
  (primal residual ``||Ax - b||_inf``, bound violation, objective),
  computed on the batch's device.
* :func:`solve_report` -- host-side structured summary (dict) for logging
  and JSON.
* :func:`trace` -- a ``torch.profiler`` window around a region, written as
  a Chrome trace; :func:`annotate` names a region in it (and, on a card,
  in an NVTX range).
"""

from __future__ import annotations

import contextlib
import os
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
