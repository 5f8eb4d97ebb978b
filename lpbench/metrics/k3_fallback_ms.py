"""Kernel 3 in the exact router's fallback (the program's spans
``segment`` with ``kernel`` 3 under a ``fallback`` span: the two-phase
simplex at n = 3m and the repair crossover), ms a call over the window (0
in a window in which no lane fell back)."""

from ._kernel3 import k3_ms


def read(run):
    return k3_ms(run, in_fallback=True)
