"""Rolling-horizon re-solves with the warm-started interior-point family
(the port's counterpart of ``examples/warm_ipm.py``).

The same LP structure re-solved every period with a slightly different
right-hand side: the IPM warm-starts from the previous iterate with
complementarity lifted back into the interior
(:func:`linprog_tpu_torch.ipm.warm_start_point`).

Run: python examples/torch_warm_ipm.py [batch] [m] [periods] [--device cuda|cpu]
"""

import argparse


def main(argv=None):
    import numpy as np
    import torch

    from linprog_tpu_torch import status as st
    from linprog_tpu_torch.generators import random_inequality_lps
    from linprog_tpu_torch.ipm import (
        IPMConfig,
        ipm_solve_batch_canonical,
        reoptimize_ipm_batch_canonical,
    )
    from linprog_tpu_torch.ipm_sparse import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", type=int, nargs="?", default=64)
    p.add_argument("m", type=int, nargs="?", default=128)
    p.add_argument("periods", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    B, m = args.batch, args.m

    cfg = IPMConfig(eps_rel=1e-3, maxiters=40)
    c, G, h = (torch.as_tensor(a, device=dev)
               for a in random_inequality_lps(B, m, m, seed=0))

    res, state = ipm_solve_batch_canonical(c, G, h, cfg, return_state=True)
    opt = int((res.status == st.OPTIMAL).sum())
    print(f"period 0 (cold): {opt}/{B} optimal, "
          f"mean iters {res.iters.double().mean().item():.1f}")

    rng = np.random.default_rng(1)
    for t in range(1, args.periods + 1):
        h = h * torch.as_tensor(1.0 + 0.02 * rng.standard_normal(h.shape),
                                dtype=h.dtype, device=dev)
        res, state = reoptimize_ipm_batch_canonical(c, G, h, state, cfg,
                                                    return_state=True)
        opt = int((res.status == st.OPTIMAL).sum())
        print(f"period {t} (warm): {opt}/{B} optimal, "
              f"mean iters {res.iters.double().mean().item():.1f}, "
              f"mean cost {res.cost.double().mean().item():.4f}")
    return res


if __name__ == "__main__":
    main()
