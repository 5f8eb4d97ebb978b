"""Kernel 3 in the exact router's crossover (the program's spans
``segment`` with ``kernel`` 3 and no ``fallback`` ancestor: at m = 2048 the
crossover's dual and primal drives at n = 2m), ms a call over the
window."""

from ._kernel3 import k3_ms


def read(run):
    return k3_ms(run, in_fallback=False)
