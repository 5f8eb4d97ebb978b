"""Batched sparse first-order solving of structured LPs (the port's
counterpart of ``examples/sparse_batch.py``).

Structured LP families (transportation, assignment, network flow) share
one sparsity pattern across instances; only the data varies.
``pdhg_solve_batch_sparse`` keeps one COO pattern (``rows/cols[nnz]``) for
the whole batch and ``nnz`` values a lane, so memory scales with
``B * nnz`` instead of ``B * m * n``.

Run: python examples/torch_sparse_batch.py [batch] [n_supply] [n_demand] [--device cuda|cpu]
"""

import argparse


def main(argv=None):
    import numpy as np
    import torch

    from linprog_tpu_torch import status as st
    from linprog_tpu_torch.generators import transportation_lps
    from linprog_tpu_torch.ipm_sparse import resolve_device
    from linprog_tpu_torch.pdhg import PDHGConfig, pdhg_solve_batch_sparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", type=int, nargs="?", default=32)
    p.add_argument("ns", type=int, nargs="?", default=8)
    p.add_argument("nd", type=int, nargs="?", default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    c, A, b = transportation_lps(args.batch, args.ns, args.nd, seed=7)
    B, m, n = A.shape

    # shared pattern: every lane has the same incidence structure
    rows, cols = np.nonzero(A[0])
    vals = A[:, rows, cols]  # [B, nnz]
    nnz = rows.size
    print(f"{B} transportation LPs ({args.ns}x{args.nd}): m={m}, n={n}, "
          f"nnz={nnz} ({nnz / (m * n):.1%} dense)")
    print(f"sparse batch storage: {vals.nbytes / 1e3:.1f} kB values "
          f"+ {rows.nbytes * 2 / 1e3:.1f} kB shared pattern "
          f"(dense: {A.nbytes / 1e3:.1f} kB)")

    cfg = PDHGConfig(eps_rel=1e-6, dtype="float64")
    states = pdhg_solve_batch_sparse(
        c, rows, cols, torch.as_tensor(vals, device=dev), b, n_eq=m,
        lb=np.zeros((B, n)), ub=np.full((B, n), np.inf),
        shape=(m, n), maxiters=200_000, cfg=cfg,
    )
    status = states.status.cpu().numpy()
    costs = np.einsum("bn,bn->b", c, states.x.cpu().numpy())
    print(f"optimal: {(status == st.OPTIMAL).sum()}/{B}, "
          f"mean cost {costs.mean():.4f}")

    # cross-check a few lanes against HiGHS
    from scipy.optimize import linprog as highs

    worst = 0.0
    for i in range(min(4, B)):
        ref = highs(c[i], A_eq=A[i], b_eq=b[i], bounds=(0, None),
                    method="highs")
        if ref.status == 0:
            worst = max(worst, abs(costs[i] - ref.fun) / abs(ref.fun))
    print(f"max rel gap vs HiGHS on {min(4, B)} lanes: {worst:.2e}")
    return states, worst


if __name__ == "__main__":
    main()
