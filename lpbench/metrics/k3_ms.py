"""Kernel 3, the streaming kernel (the program's spans ``segment`` with
``kernel`` 3, every mode), ms a call over the window (0 in a window that
launched none)."""

from ._branch import segment_ms


def read(run):
    return segment_ms(run, 3)
