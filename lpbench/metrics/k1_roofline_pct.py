"""Kernel 1's share of its roofline in the profiled stretch: the least
time of its launches (the pivots each did at 2mn + 6m^2 operations, at 67
TFLOP/s, or its bytes read and written once at 3.35 TB/s, whichever is
larger) over the profiler's device time of its CUDA symbols."""

from ._spans import roofline_pct, segment_probe

SYMBOLS = ("solve_segment_cluster_kernel", "solve_segment_large_kernel")
SPANS = {"k1": ["linprog_tpu_torch.engine_batched:solve_segment"]}
PROBES = {"k1": segment_probe}


def read(run):
    return roofline_pct(run, "k1", SYMBOLS)
