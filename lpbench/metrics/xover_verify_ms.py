"""The crossover's terminal dd solve and its primal check (the
program's span ``xover.verify``), ms a call."""

from ._program import ms_per_call


def read(run):
    return ms_per_call(run, "xover.verify")
