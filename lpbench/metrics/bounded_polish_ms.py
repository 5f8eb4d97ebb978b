"""The bound-aware dd polish (``refine.polish_bounded_batch``), ms a
call."""

from ._spans import per_call_ms

SPANS = {"bounded_polish": ["linprog_tpu_torch.refine:polish_bounded_batch"]}


def read(run):
    return per_call_ms(run, "bounded_polish")
