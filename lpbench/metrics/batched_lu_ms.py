"""The segment drivers' refactorization between launches
(``engine_batched.refresh_running_lanes`` and its binding in
``bounded``), ms a call."""

from ._spans import per_call_ms

SPANS = {
    "batched_lu": ["linprog_tpu_torch.engine_batched:refresh_running_lanes",
                   "linprog_tpu_torch.bounded:refresh_running_lanes"],
}


def read(run):
    return per_call_ms(run, "batched_lu")
