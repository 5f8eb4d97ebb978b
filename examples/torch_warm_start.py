"""Warm-started scenario re-optimization: the dual-simplex workflow, batched
(the port's counterpart of ``examples/warm_start.py``).

Solve a batch of LPs once, then re-solve right-hand-side perturbations
(e.g. demand scenarios) from the previous optimal bases: a basis stays
dual feasible, so each re-solve needs a few dual pivots instead of a full
two-phase solve.

Run: python examples/torch_warm_start.py [batch] [--device cuda|cpu]
"""

import argparse
import time


def main(argv=None):
    import numpy as np
    import torch

    from linprog_tpu_torch.batch import (
        batch_summary,
        reoptimize_batch_new_rhs,
        solve_batch_two_phase,
    )
    from linprog_tpu_torch.config import SolverConfig
    from linprog_tpu_torch.generators import (
        device_inequality_lps,
        device_standard_form_batch,
    )
    from linprog_tpu_torch.ipm_sparse import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", type=int, nargs="?", default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    B, m = args.batch, 64
    cfg = SolverConfig(pricing="dantzig", refactor_every=64)

    gen = torch.Generator(device=dev).manual_seed(0)
    cs, As, bs = device_standard_form_batch(
        *device_inequality_lps(gen, B, m, m, dev))

    t0 = time.time()
    base = solve_batch_two_phase(cs, As, bs, 500, 500, cfg)
    print(f"base solve: {batch_summary(base)}  ({time.time() - t0:.2f}s)")

    # demand scenario: the right-hand side shifts by +/-5%
    gen.manual_seed(1)
    bs_new = bs * (1.0 + 0.05 * torch.randn(bs.shape, generator=gen,
                                             device=dev))
    t0 = time.time()
    warm = reoptimize_batch_new_rhs(cs, As, bs_new, base.basis, 300, cfg)
    shift = (warm.cost - base.cost).cpu().numpy()
    print(f"warm re-solve: {batch_summary(warm)}  ({time.time() - t0:.2f}s)")
    print(f"objective shift: mean {float(np.mean(shift)):+.4f}")
    return base, warm


if __name__ == "__main__":
    main()
