"""Kernel 3's share of its roofline in the profiled calls: the least time
of its launches (``lpbench/roofline_stream.py``: each pivot moves A once
and the factor three times at 3.35 TB/s, or its 2mn + 6m^2 operations at
67 TFLOP/s, the larger) over the profiler's device time of
``solve_segment_stream_kernel``."""

from ._branch import roofline_pct

SYMBOLS = ("solve_segment_stream_kernel",)


def read(run):
    return roofline_pct(run, 3, None, SYMBOLS)
