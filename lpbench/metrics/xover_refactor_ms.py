"""The crossover's exact refactorization after each dual phase (the
program's span ``xover.refactor``), ms a call."""

from ._program import ms_per_call


def read(run):
    return ms_per_call(run, "xover.refactor")
