"""Kernel 1's streaming branch (the program's spans ``segment`` with
``kernel`` 1 and ``branch`` ``"stream"``: a cluster of CTAs a lane past
the largest resident cluster), ms a call."""

from ._branch import segment_ms


def read(run):
    return segment_ms(run, 1, "stream")
