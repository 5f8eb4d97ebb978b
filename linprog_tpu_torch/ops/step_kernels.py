"""The two per-step kernels of the batched simplex iteration (counterpart
of :mod:`linprog_tpu.ops.pallas_kernels`).

* :func:`price_entering` replaces ``linprog_tpu/ops/pallas_kernels.py ::
  price_entering`` (body ``_price_kernel``): per lane the duals
  ``y = c_B B^-1``, the reduced costs ``r = c - yA + penalty`` and the
  entering column with an eligibility flag, in one pass over ``B^-1`` and
  ``A``; two integers per lane leave the kernel.
* :func:`ratio_eta_pivot` replaces ``... :: ratio_eta_pivot`` (body
  ``_ratio_eta_kernel``): per lane the direction ``d = B^-1 a``, the masked
  min-ratio leaving row, the unbounded flag and the masked rank-1 eta
  update of ``B^-1`` and ``bfs``, IN PLACE (the reference aliases input to
  output), so ``B^-1`` is read twice and written once per pivot.

What must carry over exactly, and does in the plain versions and the CUDA
kernels: arg-reductions take the first index on ties; dantzig does NOT
zero ``enter`` on an ineligible lane, bland does; with a NaN reduced cost
dantzig's ``enter`` is ``n`` (callers clamp before they gather); the ratio
test divides the UNCLAMPED ``bfs``; ``leave`` is 0 and nothing changes when
no ``d > pivot_tol``; the eta column is zero unless ``go`` and a positive
``d`` exists.  The reference's grouping of 4 or 8 lanes per grid step is a
Mosaic tiling rule and is not carried over.

On the H100 (``csrc/price_entering.cu``, ``csrc/ratio_eta_pivot.cu``): one
thread block per lane, each bound by device-memory bandwidth (``B^-1`` and
``A`` read once by the first; ``B^-1`` read twice and written once by the
second).
"""

from __future__ import annotations

import torch

from . import _build
from .solve_kernel import check_tensors

launches = {"price_entering": 0, "ratio_eta_pivot": 0}  # CUDA launches


def _first_where(mask, size: int):
    idx = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    return torch.where(mask, idx, size).min(dim=1).values


def price_entering_plain(cB, invB, A, c, penalty, *, dantzig: bool,
                         opt_tol: float):
    """The plain PyTorch version of :func:`price_entering`."""
    n = A.shape[2]
    y = torch.einsum("bm,bmk->bk", cB, invB)
    r = c - torch.einsum("bm,bmn->bn", y, A)
    r = r + penalty  # +inf on masked columns
    if dantzig:
        best = r.min(dim=1).values
        enter = _first_where(r == best[:, None], n)
        eligible = best < -opt_tol
    else:  # bland: first negative reduced cost
        neg = r < -opt_tol
        eligible = neg.any(dim=1)
        enter = torch.where(eligible, _first_where(neg, n), 0)
    return enter.to(torch.int32), eligible.to(torch.int32)


def price_entering(cB, invB, A, c, penalty, *, dantzig: bool, opt_tol: float):
    """Entering column per lane: ``(enter[B] i32, eligible[B] i32)``.

    ``cB[B, m]``, ``invB[B, m, m]``, ``A[B, m, n]``, ``c[B, n]``,
    ``penalty[B, n]`` (+inf on columns that may not enter), all f32 and
    contiguous.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel.
    """
    B, m, n = A.shape
    f32 = torch.float32
    check_tensors("price_entering", {
        "A": (A, (B, m, n), f32), "cB": (cB, (B, m), f32),
        "invB": (invB, (B, m, m), f32), "c": (c, (B, n), f32),
        "penalty": (penalty, (B, n), f32)}, A.device)
    if A.device.type == "cpu":
        return price_entering_plain(cB, invB, A, c, penalty, dantzig=dantzig,
                                    opt_tol=opt_tol)
    if A.device.type != "cuda":
        raise ValueError(f"price_entering: unsupported device {A.device}")
    enter = torch.empty((B,), dtype=torch.int32, device=A.device)
    elig = torch.empty((B,), dtype=torch.int32, device=A.device)
    if B == 0:
        return enter, elig
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    code = lib.lp_price_entering(
        cB.data_ptr(), invB.data_ptr(), A.data_ptr(), c.data_ptr(),
        penalty.data_ptr(), enter.data_ptr(), elig.data_ptr(),
        B, m, n, int(bool(dantzig)), float(opt_tol), stream,
    )
    _build.check(code, "price_entering launch")
    launches["price_entering"] += 1
    return enter, elig


def ratio_eta_pivot_plain(invB, bfs, acol, go, *, pivot_tol: float):
    """The plain PyTorch version of :func:`ratio_eta_pivot`; updates
    ``invB`` and ``bfs`` in place."""
    B, m, _ = invB.shape
    inf = float("inf")
    lane_m = torch.arange(m, dtype=torch.int32, device=invB.device)
    d = torch.einsum("bmk,bk->bm", invB, acol)
    pos = d > pivot_tol
    any_pos = pos.any(dim=1)
    theta = torch.where(pos, bfs / torch.where(pos, d, 1.0), inf)
    best = theta.min(dim=1).values
    leave = _first_where(pos & (theta == best[:, None]), m)
    # a NaN ratio leaves no row equal to the minimum: stay inside the lane
    leave = torch.where(any_pos, leave, 0).clamp_max(m - 1).to(torch.int32)

    go = go.reshape(B) > 0
    do_pivot = go & any_pos
    at_leave = lane_m[None, :] == leave[:, None]
    d_l = torch.where(at_leave, d, 0.0).sum(dim=1)
    safe = torch.where(d_l == 0, 1.0, d_l)
    u = -d / safe[:, None]
    u = torch.where(at_leave, (1.0 / safe - 1.0)[:, None], u)
    u = torch.where(do_pivot[:, None], u, 0.0)
    row = torch.gather(invB, 1, leave.long()[:, None, None].expand(B, 1, m))
    bfs_l = torch.where(at_leave, bfs, 0.0).sum(dim=1)
    invB.copy_(invB + u[:, :, None] * row)
    bfs.copy_(bfs + u * bfs_l[:, None])
    return invB, bfs, leave, (go & ~any_pos).to(torch.int32)


def ratio_eta_pivot(invB, bfs, acol, go, *, pivot_tol: float):
    """Ratio test and masked eta pivot per lane, IN PLACE on ``invB`` and
    ``bfs``.

    ``invB[B, m, m]``, ``bfs[B, m]``, ``acol[B, m]`` f32, ``go[B, 1]`` i32
    (0/1), all contiguous.  Returns ``(invB, bfs, leave[B] i32,
    unbounded[B] i32)`` with the first two the arguments themselves.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    B, m, _ = invB.shape
    f32 = torch.float32
    check_tensors("ratio_eta_pivot", {
        "invB": (invB, (B, m, m), f32), "bfs": (bfs, (B, m), f32),
        "acol": (acol, (B, m), f32), "go": (go, (B, 1), torch.int32)},
        invB.device)
    if invB.device.type == "cpu":
        return ratio_eta_pivot_plain(invB, bfs, acol, go, pivot_tol=pivot_tol)
    if invB.device.type != "cuda":
        raise ValueError(f"ratio_eta_pivot: unsupported device {invB.device}")
    leave = torch.empty((B,), dtype=torch.int32, device=invB.device)
    unb = torch.empty((B,), dtype=torch.int32, device=invB.device)
    if B == 0:
        return invB, bfs, leave, unb
    lib = _build.library()
    stream = torch.cuda.current_stream(invB.device).cuda_stream
    code = lib.lp_ratio_eta_pivot(
        invB.data_ptr(), bfs.data_ptr(), acol.data_ptr(), go.data_ptr(),
        leave.data_ptr(), unb.data_ptr(), B, m, float(pivot_tol), stream,
    )
    _build.check(code, "ratio_eta_pivot launch")
    launches["ratio_eta_pivot"] += 1
    return invB, bfs, leave, unb
