"""The crossover's basis guess (the program's span ``xover.guess``: the
topk guess, its batched inverse and bfs0), ms a call."""

from ._program import ms_per_call


def read(run):
    return ms_per_call(run, "xover.guess")
