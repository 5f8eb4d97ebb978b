"""Blocking host reads of device values (the program's spans
``host_read``) a call."""

from ._program import spans_per_call


def read(run):
    return spans_per_call(run, "host_read")
