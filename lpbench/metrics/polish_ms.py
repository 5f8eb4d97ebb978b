"""The dd polish (``refine.polish_batch``), ms a call."""

from ._spans import per_call_ms

SPANS = {"polish": ["linprog_tpu_torch.refine:polish_batch"]}


def read(run):
    return per_call_ms(run, "polish")
