"""Newton steps of the IPM (the ``steps`` count of the program's span
``ipm``, ``ipm._ipm_core``), summed a call."""

from ._program import count_per_call


def read(run):
    return count_per_call(run, "ipm", "steps")
