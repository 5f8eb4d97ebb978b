"""The exact router's two-phase fallback with its repair crossover (the
program's span ``fallback``), ms a call over the window (0 in a window in
which no lane fell back)."""

from ._program import ms_per_call


def read(run):
    return ms_per_call(run, "fallback")
