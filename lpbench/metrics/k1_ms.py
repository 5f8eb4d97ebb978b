"""Kernel 1, the whole-segment simplex kernel (``solve_segment`` as
``engine_batched`` binds it), ms a call."""

from ._spans import per_call_ms, segment_probe

SPANS = {"k1": ["linprog_tpu_torch.engine_batched:solve_segment"]}
PROBES = {"k1": segment_probe}


def read(run):
    return per_call_ms(run, "k1")
