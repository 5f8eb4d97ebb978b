"""Oracle-free per-lane vertex certificates (counterpart of
:mod:`linprog_tpu.certify`).

Given the basis a lane reports, verify all four KKT conditions of
``min c'x, Gx <= h, x >= 0`` (slack-extended ``[G | I]``) from the problem
data, with double-word refined residuals: primal feasibility
``B x_B = h, x_B >= 0``, dual feasibility ``c - y G >= 0, -y >= 0`` and a
zero duality gap.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import inv_or_nan
from .refine import dd_dot, dd_residual, dd_residual_rowmat, refine_bfs, refine_duals


def certify_vertex_batch(c, G, h, basis):
    """Per-lane KKT verification of ``basis[B, m]`` (columns of ``[G | I]``).

    Returns a dict of per-lane tensors: ``certified`` (bool: all conditions
    within 1e-5 relative), ``primal_residual``, ``min_xB``,
    ``min_reduced_cost`` and ``gap`` (see the reference for definitions).
    """
    B, m, n = G.shape
    tol = 1e-5
    basis = basis.long()
    safe = torch.clamp(basis, 0, n - 1)
    struct_cols = torch.gather(G, 2, safe[:, None, :].expand(B, m, m))
    slack_idx = torch.clamp(basis - n, 0, m - 1)
    eye_cols = torch.nn.functional.one_hot(slack_idx, m).to(G.dtype)
    eye_cols = eye_cols.transpose(1, 2)  # column k = e_{basis_k - n}
    is_struct = (basis < n)[:, None, :]
    B_mat = torch.where(is_struct, struct_cols, eye_cols)

    inv_B = inv_or_nan(B_mat)
    xB = torch.einsum("bmk,bk->bm", inv_B, h)
    xB = refine_bfs(B_mat, h, inv_B, xB, steps=2)
    rp = dd_residual(h, B_mat, xB)
    h_scale = 1.0 + torch.abs(h).max(dim=1).values
    primal_residual = torch.abs(rp).max(dim=1).values / h_scale
    min_xB = xB.min(dim=1).values / h_scale

    cB = torch.where(basis < n, torch.gather(c, 1, safe), 0.0)
    y = refine_duals(cB, B_mat, inv_B, steps=2)
    rc_struct = dd_residual_rowmat(c, y, G)  # c - y G
    c_scale = 1.0 + torch.abs(c).max(dim=1).values
    min_rc = torch.minimum(rc_struct.min(dim=1).values,
                           (-y).min(dim=1).values) / c_scale

    # gap via the identity c_B'x_B - h'y = rc_B'x_B - y'r_p
    pobj = dd_dot(cB, xB)
    rcB = dd_residual_rowmat(cB, y, B_mat)
    gap = torch.abs(dd_dot(rcB, xB) - dd_dot(y, rp)) / (1.0 + torch.abs(pobj))

    finite = torch.isfinite(xB).all(dim=1) & torch.isfinite(y).all(dim=1)
    certified = (
        finite
        & (primal_residual <= tol)
        & (min_xB >= -tol)
        & (min_rc >= -tol)
        & (gap <= tol)
    )
    return {
        "certified": certified,
        "primal_residual": primal_residual,
        "min_xB": min_xB,
        "min_reduced_cost": min_rc,
        "gap": gap,
    }


def certificate_summary(cert: dict) -> dict:
    """Host digest: certified count and the worst residual of each
    condition over the certified lanes."""
    ok = cert["certified"].cpu().numpy()
    out = {"certified": int(ok.sum()), "lanes": int(ok.size)}
    if ok.any():
        def worst(key, fn):
            return float(f"{fn(cert[key].cpu().numpy()[ok]):.3e}")

        out.update({
            "max_primal_residual": worst("primal_residual", np.max),
            "min_xB": worst("min_xB", np.min),
            "min_reduced_cost": worst("min_reduced_cost", np.min),
            "max_gap": worst("gap", np.max),
        })
    return out
