"""The cells at a size a CPU test can hold: the same drivers, traffic and
comparison, with the configuration's sizes cut."""

CELLS = ("ineq_m256.exact", "ineq_m256.simplex", "bounded_m256.cold")
TINY = {"config": {"m": 16, "n": 16, "lanes": 8, "pool_batches": 2},
        "traffic": {"sample_lanes_per_call": 4}}


def run(cell, seed=12345678901, seconds=0.5, trace=False, control=False):
    import time

    from lpbench import harness

    return harness.run_cell(harness.manifest(), cell, seed, seconds, trace,
                            "cpu", time.time(), TINY, control=control)
