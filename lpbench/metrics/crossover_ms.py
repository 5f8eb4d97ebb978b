"""The crossover's own time (``crossover.crossover_batch_canonical``, the
fallback's repair pass included), less the dd polish, the segment
driver's refactorizations and kernel 1 inside it, ms a call."""

from ._spans import self_per_call_ms

SPANS = {
    "crossover": ["linprog_tpu_torch.crossover:crossover_batch_canonical"],
    "polish": ["linprog_tpu_torch.refine:polish_batch"],
    "batched_lu": ["linprog_tpu_torch.engine_batched:refresh_running_lanes",
                   "linprog_tpu_torch.bounded:refresh_running_lanes"],
    "k1": ["linprog_tpu_torch.engine_batched:solve_segment"],
}


def read(run):
    return self_per_call_ms(run, "crossover",
                            ("polish", "batched_lu", "k1"))
