"""Lanes the exact router retried from the alternate basis guess (the
``lanes`` count of the program's span ``retry``: the lanes the first
pass left uncrossed), summed a call over the window."""

from ._branch import retry_count


def read(run):
    return retry_count(run, "lanes")
