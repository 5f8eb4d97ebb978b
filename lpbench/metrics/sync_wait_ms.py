"""The device time of the program's ``host_read`` spans, ms a call: from
the event before each blocking read to the event after it, the stretch
in which the device queue stood empty waiting for the host to come back
(a lower bound on the idle the reads cause)."""

from ._program import ms_per_call


def read(run):
    return ms_per_call(run, "host_read")
