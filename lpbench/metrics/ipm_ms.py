"""The batched IPM with its normal factor (``ipm.ipm_canonical_state``,
looked up there by the crossover), ms a call."""

from ._spans import per_call_ms

SPANS = {"ipm": ["linprog_tpu_torch.ipm:ipm_canonical_state"]}


def read(run):
    return per_call_ms(run, "ipm")
