"""Solver iterations (``BatchResult.iters``), mean over the lanes of every
call of the window."""


def read(run):
    return run.pivots / (run.calls * run.lanes)
