"""Kernel 4, the bounded-variable segment kernel
(``bounded.solve_bounded_segment``), ms a call."""

from ._spans import per_call_ms, segment_probe

SPANS = {"k4": ["linprog_tpu_torch.bounded:solve_bounded_segment"]}
PROBES = {"k4": segment_probe}


def read(run):
    return per_call_ms(run, "k4")
