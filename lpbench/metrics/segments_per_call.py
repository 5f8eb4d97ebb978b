"""Segment kernel launches (the program's spans ``segment``: kernels 1, 3
and 4, each launch of a segment loop) a call."""

from ._program import spans_per_call


def read(run):
    return spans_per_call(run, "segment")
