"""Scenario analysis: solve thousands of perturbed LPs in one device batch
(the port's counterpart of ``examples/scenario_batch.py``).

Take a base model (the SAS diet LP of ``examples/torch_diet.py``), make
scenarios with perturbed prices, and solve them all in one batched
two-phase solve on the device, then reduce the results.

Run: python examples/torch_scenario_batch.py [num_scenarios] [--device cuda|cpu]
"""

import argparse

import numpy as np

from examples.torch_diet import G, costs, h, lb, ub


def build_scenarios(num: int, seed: int = 0):
    """Perturb food prices +/-20% per scenario; constraints stay fixed."""
    from linprog_tpu_torch.forms import bounds_to_rows, canonical_to_standard

    rng = np.random.default_rng(seed)
    price_mult = rng.uniform(0.8, 1.2, size=(num, costs.shape[0]))
    cs, As, bs = [], [], []
    for k in range(num):
        c_std, A_std, b_std = canonical_to_standard(
            costs * price_mult[k], G, h
        )
        c_k, A_k, b_k = bounds_to_rows(
            c_std, A_std, b_std, np.concatenate([lb, np.zeros(G.shape[0])]),
            np.concatenate([ub, np.full(G.shape[0], np.inf)]))
        cs.append(c_k)
        As.append(A_k)
        bs.append(b_k)
    return np.stack(cs), np.stack(As), np.stack(bs), price_mult


def main(argv=None):
    import torch

    from linprog_tpu_torch.batch import batch_summary, solve_batch_two_phase
    from linprog_tpu_torch.config import SolverConfig
    from linprog_tpu_torch.ipm_sparse import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("num", type=int, nargs="?", default=512)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cs, As, bs, mult = build_scenarios(args.num)
    cs, As, bs = (torch.as_tensor(a, device=dev) for a in (cs, As, bs))
    cfg = SolverConfig(pricing="dantzig", refactor_every=64)
    res = solve_batch_two_phase(cs, As, bs, 500, 500, cfg)
    summary = batch_summary(res)
    cost = res.cost.cpu().numpy()

    print(f"scenarios: {args.num}  ->  {summary}")
    print(f"diet cost: mean={cost.mean():.4f}  min={cost.min():.4f}  "
          f"max={cost.max():.4f}  std={cost.std():.4f}")
    best = int(np.argmin(cost))
    print(f"cheapest scenario #{best}: price multipliers {mult[best].round(3)}")
    return res


if __name__ == "__main__":
    main()
