"""Lanes of the calls completed in the window over the window's seconds
(the first call's start to the last call's end): LPs solved a second."""


def read(run):
    return run.calls * run.lanes / run.window_s
