"""Kernel 4's share of its roofline in the profiled stretch, counted as
kernel 1's (``k1_roofline_pct``)."""

from ._spans import roofline_pct, segment_probe

SYMBOLS = ("solve_bounded_cluster_kernel", "solve_bounded_stream_kernel")
SPANS = {"k4": ["linprog_tpu_torch.bounded:solve_bounded_segment"]}
PROBES = {"k4": segment_probe}


def read(run):
    return roofline_pct(run, "k4", SYMBOLS)
