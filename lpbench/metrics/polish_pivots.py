"""Pivots of the dd polish (the ``pivots`` count of the program's span
``polish``, ``refine.polish_batch``: its rounds that pivoted), summed a
call."""

from ._program import count_per_call


def read(run):
    return count_per_call(run, "polish", "pivots")
