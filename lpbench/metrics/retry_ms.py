"""The exact router's retry of the uncrossed lanes from the alternate
basis guess (the program's span ``retry``: the gathered bucket's IPM and
crossover and the merge), ms a call over the window (0 in a window in
which no lane was retried)."""

from ._branch import retry_ms


def read(run):
    return retry_ms(run)
