"""Shared-pattern sparse batched IPM (counterpart of
:mod:`linprog_tpu.ipm_sparse`).

One COO pattern ``rows/cols[nnz]`` serves the whole batch, with per-lane
values ``vals[B, nnz]``, the input convention of
:func:`linprog_tpu_torch.pdhg.pdhg_solve_batch_sparse`, at the IPM's
accuracy class.

* Matvecs are gathers, never scatters: the pattern is padded on the host
  into row-major ``[m, k_row]`` and column-major ``[n, k_col]`` slot tables
  (:class:`SharedTables`, which the sparse PDHG and the sparse generator
  use too), so ``G x`` and ``G' y`` are one gather and a masked sum over
  the padded axis.
* The normal matrix ``G D_g G' + diag(D_s)`` is assembled dense from the
  sparse values: each column contributes the lower half of the outer
  product of its nonzeros scaled by ``d_j``, and the products are summed
  by ``torch.segment_reduce`` over the pair stream pre-sorted by target
  (a pattern constant), then written once onto their distinct targets.
  No floating-point ``index_add_`` or ``scatter_add_``: on a card those sum
  through atomics in a different order on every run.  ``assembly="cumsum"``
  (the reference's second mode) reads each target instead as the
  difference of a compensated prefix sum of the stream at the pattern's
  segment bounds (:meth:`SparsePattern.seg_bounds`).
* Everything downstream (the inverse-Cholesky factor on the panel kernel,
  predictor-corrector, Farkas certificates) is the dense family's
  ``ipm._ipm_core`` on the operator :class:`_SparseSlackOp`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import status as st
from .ipm import (
    _DTYPES,
    DEFAULT_IPM_CONFIG,
    IPMConfig,
    _ipm_core,
    ipm_state_to_result,
    recover_stragglers_pooled,
)
from .results import BatchResult


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a card
    raises instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the host")
    return dev


def _host_index(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.int32)


def _pad(keys, other, size):
    """Slot tables of a pattern grouped by ``keys``: ``(idx, slot, mask)``
    of shape ``[size, k]``, entries of each group in their stable sorted
    order (the reference's per-entry loop, vectorised)."""
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=size)
    k = max(1, int(counts.max())) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    ks = keys[order]
    pos = np.arange(keys.size, dtype=np.int64) - starts[ks]
    idx = np.zeros((size, k), np.int32)
    slot = np.zeros((size, k), np.int32)
    mask = np.zeros((size, k), np.float32)
    idx[ks, pos] = other[order]
    slot[ks, pos] = order
    mask[ks, pos] = 1.0
    return idx, slot, mask


class SharedTables:
    """The padded slot tables of one ``m x n`` COO pattern.

    Host arrays (numpy, equal to the reference's ``SparsePattern``
    members): ``row_cols/row_slot/row_mask[m, k_row]`` and
    ``col_rows/col_slot/col_mask[n, k_col]``.  :meth:`tables` gives them as
    tensors on a device (cached per device).
    """

    _KEYS = ("row_cols", "row_slot", "row_mask", "col_rows", "col_slot",
             "col_mask")

    def __init__(self, rows, cols, m: int, n: int, device="cuda"):
        rows, cols = _host_index(rows), _host_index(cols)
        if rows.shape != cols.shape:
            raise ValueError("rows/cols must have the same length")
        self.m, self.n, self.nnz = int(m), int(n), int(rows.shape[0])
        self.rows, self.cols = rows, cols
        self.row_cols, self.row_slot, self.row_mask = _pad(rows, cols, m)
        self.col_rows, self.col_slot, self.col_mask = _pad(cols, rows, n)
        self.k_row = self.row_cols.shape[1]
        self.k_col = self.col_rows.shape[1]
        self.device = resolve_device(device)
        self._dev = {}

    def _host_tables(self) -> dict:
        return {k: getattr(self, k) for k in self._KEYS}

    def tables(self, device=None) -> dict:
        """The tables as tensors on ``device`` (default: the pattern's):
        index tables int64, masks f32."""
        dev = resolve_device(device if device is not None else self.device)
        key = str(dev)
        if key not in self._dev:
            out = {}
            for k, a in self._host_tables().items():
                dt = torch.float32 if a.dtype == np.float32 else torch.long
                out[k] = torch.as_tensor(a, dtype=dt, device=dev)
            out["rows"] = torch.as_tensor(self.rows, dtype=torch.long,
                                          device=dev)
            out["cols"] = torch.as_tensor(self.cols, dtype=torch.long,
                                          device=dev)
            self._dev[key] = out
        return self._dev[key]

    def value_tables(self, vals):
        """Per-lane padded values ``(Vr[B, m, k_row], Vc[B, n, k_col])``."""
        return _value_tables(self.tables(vals.device), vals, self.m, self.n)

    def gx(self, Vr, x):
        """``G x`` for ``x[B, n]``."""
        return _gather_sum(Vr, self.tables(x.device)["row_cols"], x)

    def gty(self, Vc, w):
        """``G' w`` for ``w[B, m]``."""
        return _gather_sum(Vc, self.tables(w.device)["col_rows"], w)


def _value_tables(pat: dict, vals, m: int, n: int):
    B = vals.shape[0]
    mask_r = pat["row_mask"].to(vals.dtype)
    mask_c = pat["col_mask"].to(vals.dtype)
    Vr = vals.index_select(1, pat["row_slot"].reshape(-1)).reshape(
        B, m, -1) * mask_r
    Vc = vals.index_select(1, pat["col_slot"].reshape(-1)).reshape(
        B, n, -1) * mask_c
    return Vr, Vc


def _gather_sum(V, idx, v):
    """``sum_k V[b, i, k] * v[b, idx[i, k]]``: one gather, one reduction."""
    B, rows, k = V.shape
    g = v.index_select(1, idx.reshape(-1)).reshape(B, rows, k)
    return (V * g).sum(dim=2)


class SparsePattern(SharedTables):
    """Host-side padded formats and pair plan for one COO pattern (no
    duplicate coordinates), ``m x n``; the tables are numpy arrays equal to
    the reference's, array for array, and go to ``device`` as tensors.

    The pair plan of the normal assembly: ``pair_perm`` (positions in the
    padded ``[n, k_col, k_col]`` block of every live pair ``i1 <= i2``,
    sorted by target) and ``pair_ids`` (their flat targets ``i1 * m +
    i2``), as in the reference; then the port's segment form of the same
    stream: ``pair_targets`` (the distinct targets, ascending) and
    ``pair_starts`` (each one's first position in the stream, with the
    stream's length last).
    """

    _KEYS = SharedTables._KEYS + ("pair_perm", "pair_ids", "pair_targets",
                                  "pair_starts")

    def __init__(self, rows, cols, m: int, n: int, device="cuda"):
        super().__init__(rows, cols, m, n, device)
        i1 = self.col_rows[:, :, None].astype(np.int64)
        i2 = self.col_rows[:, None, :].astype(np.int64)
        pm = (self.col_mask[:, :, None] * self.col_mask[:, None, :]) > 0
        pm &= i1 <= i2
        flat = np.where(pm, i1 * m + i2, -1).reshape(-1)
        live = np.flatnonzero(flat >= 0)
        order = np.argsort(flat[live], kind="stable")
        self.pair_perm = live[order].astype(np.int32)
        self.pair_ids = flat[live][order].astype(np.int32)
        targets, starts = np.unique(self.pair_ids, return_index=True)
        self.pair_targets = targets.astype(np.int64)
        self.pair_starts = np.append(starts, self.pair_ids.size).astype(
            np.int64)
        self._seg_bounds = None

    def seg_bounds(self):
        """``(starts, ends)[m * m]`` int32: each flat target's ``[start,
        end)`` in the sorted pair stream (empty where ``start == end``), as
        the reference's; computed on first use (only ``"cumsum"`` reads
        them)."""
        if self._seg_bounds is None:
            grid = np.arange(self.m * self.m, dtype=np.int64)
            self._seg_bounds = tuple(
                np.searchsorted(self.pair_ids, grid, side=side)
                .astype(np.int32) for side in ("left", "right"))
        return self._seg_bounds

    def cumsum_tables(self, device) -> dict:
        """:meth:`tables` with the segment bounds as int64 tensors
        (``seg_starts``, ``seg_ends``) for ``assembly="cumsum"``."""
        dev = resolve_device(device)
        key = "cumsum:" + str(dev)
        if key not in self._dev:
            starts, ends = self.seg_bounds()
            self._dev[key] = dict(
                self.tables(dev),
                seg_starts=torch.as_tensor(starts, dtype=torch.long,
                                           device=dev),
                seg_ends=torch.as_tensor(ends, dtype=torch.long, device=dev))
        return self._dev[key]


def compensated_cumsum(pv):
    """Exclusive prefix sums of ``pv[P, B]`` along dim 0 as ``(sum, err)``
    pairs ``[P + 1, B]`` (row 0 zero), by a log-step scan under the TwoSum
    combine: what a plain f32 prefix rounds away below ``eps |prefix|``
    lives in ``err``, so ``(s[e] - s[a]) + (err[e] - err[a])`` recovers a
    short segment's sum even where the prefix is 1e8 times larger."""
    s, e = pv, torch.zeros_like(pv)
    off, P = 1, pv.shape[0]
    while off < P:
        a, b = s[:-off], s[off:]
        t = a + b
        z = t - a
        err = (a - (t - z)) + (b - z)
        s = torch.cat([s[:off], t])
        e = torch.cat([e[:off], (e[:-off] + e[off:]) + err])
        off *= 2
    zero = torch.zeros_like(pv[:1])
    return torch.cat([zero, s]), torch.cat([zero, e])


class _SparseSlackOp:
    """Operator for ``A = [G | I]`` with shared-pattern sparse ``G``: the
    protocol of :class:`linprog_tpu_torch.ipm._SlackOp`, iterate layout
    ``x = [x_G; x_slack]`` with ``n = n_G + m``.  ``pat`` is
    :meth:`SparsePattern.tables` on the values' device."""

    def __init__(self, pat: dict, vals, m: int, ng: int):
        self.B = vals.shape[0]
        self.m, self.ng = m, ng
        self.n = ng + m
        self.pat = pat
        self.Vr, self.Vc = _value_tables(pat, vals, m, ng)
        self._vals_absmax = torch.clamp_min(vals.abs().amax(dim=1), 1.0)
        # each live pair's column j and its two entries a, b in Vc[:, j]
        k = self.Vc.shape[2]
        perm = pat["pair_perm"]
        self._pj = torch.div(perm, k * k, rounding_mode="floor")
        self._pa = (self._pj * k
                    + torch.div(perm, k, rounding_mode="floor") % k)
        self._pb = self._pj * k + perm % k

    def _gx(self, x):
        return _gather_sum(self.Vr, self.pat["row_cols"], x)

    def _gty(self, w):
        return _gather_sum(self.Vc, self.pat["col_rows"], w)

    def mv(self, v):
        return self._gx(v[:, : self.ng]) + v[:, self.ng:]

    def mtv(self, w):
        return torch.cat([self._gty(w), w], dim=1)

    def normal(self, d):
        """``G D_g G' + diag(D_s)`` from the sorted half-pair stream.

        Each live pair ``(j, a, b)`` gives ``d_j V[j, a] V[j, b]`` (the
        reference's product order), laid out ``[pairs, B]``.  By default one
        ``segment_reduce`` over the pattern's constant offsets sums every
        target's run in stream order, and the sums are written onto their
        distinct targets.  With the segment bounds in the tables
        (``assembly="cumsum"``) every target is read from the compensated
        prefix sum instead (:func:`compensated_cumsum`; a plain f32 prefix
        cancels catastrophically near convergence, where ``d`` spreads over
        ~1e8).  The symmetric matrix is the half plus its transpose with the
        diagonal fixed."""
        B, m, ng = self.B, self.m, self.ng
        dgT = d[:, :ng].t().contiguous()
        VcT = self.Vc.reshape(B, -1).t().contiguous()
        pv = (dgT.index_select(0, self._pj) * VcT.index_select(0, self._pa)
              * VcT.index_select(0, self._pb))  # [pairs, B]
        if "seg_starts" in self.pat:
            s, e = compensated_cumsum(pv)
            ends, starts = self.pat["seg_ends"], self.pat["seg_starts"]
            flat = ((s.index_select(0, ends) - s.index_select(0, starts))
                    + (e.index_select(0, ends) - e.index_select(0, starts)))
        else:
            sums = torch.segment_reduce(pv, "sum",
                                        offsets=self.pat["pair_starts"],
                                        axis=0)
            flat = torch.zeros((m * m, B), dtype=d.dtype, device=d.device)
            flat.index_copy_(0, self.pat["pair_targets"], sums)
        U = flat.t().reshape(B, m, m)
        N = U + U.transpose(1, 2)
        diagU = torch.diagonal(U, dim1=1, dim2=2)
        torch.diagonal(N, dim1=1, dim2=2).add_(d[:, ng:] - diagU)
        return N

    def max_abs(self):
        return self._vals_absmax


def _ruiz_sparse(rows, cols, vals, c, h, m, n, iters: int = 6):
    """Per-lane Ruiz equilibration of shared-pattern sparse ``G``.

    Returns ``(vals', c', h', row_scale, col_scale)`` with ``G' = R G C``,
    ``h' = R h`` and ``c' = C c``.  Row and column maxima are
    ``scatter_reduce(..., "amax")`` (exact in any order); an empty row or
    column stays unscaled.
    """
    B = vals.shape[0]
    rows = torch.as_tensor(rows, dtype=torch.long, device=vals.device)
    cols = torch.as_tensor(cols, dtype=torch.long, device=vals.device)
    r = torch.ones((B, m), dtype=vals.dtype, device=vals.device)
    cl = torch.ones((B, n), dtype=vals.dtype, device=vals.device)
    absv = vals.abs()

    def gather(t, idx):
        return t.index_select(1, idx)

    def segmax(av, idx, size):
        out = torch.zeros((B, size), dtype=av.dtype, device=av.device)
        out = out.scatter_reduce(1, idx.expand(B, -1), av, "amax",
                                 include_self=False)
        return torch.where(out > 0, out, 1.0)

    for _ in range(iters):
        av = absv * gather(r, rows) * gather(cl, cols)
        r = r / torch.sqrt(segmax(av, rows, m))
        av = absv * gather(r, rows) * gather(cl, cols)
        cl = cl / torch.sqrt(segmax(av, cols, n))
    vals_s = vals * gather(r, rows) * gather(cl, cols)
    return vals_s, c * cl, h * r, r, cl


def ipm_solve_batch_sparse_canonical(c, rows, cols, vals, h, shape,
                                     cfg: IPMConfig = DEFAULT_IPM_CONFIG,
                                     pattern: Optional[SparsePattern] = None,
                                     equilibrate: bool = True,
                                     assembly: str = "segment"):
    """Batched sparse IPM on canonical LPs ``min c'x, Gx <= h, x >= 0``.

    ``c[B, n], vals[B, nnz], h[B, m]`` (tensors, computed on their device)
    with the COO pattern ``rows/cols[nnz]`` shared across the batch and
    ``shape = (m, n)``.  Returns a :class:`BatchResult` in the
    slack-extended space, like
    :func:`linprog_tpu_torch.ipm.ipm_solve_batch_canonical`.  Pass a
    prebuilt :class:`SparsePattern` to build the tables once for many
    calls.  ``equilibrate`` runs a per-lane Ruiz scaling first and reports
    ``x``, ``cost`` and ``y`` in the original scaling.  ``assembly`` is
    ``"segment"`` (a segmented sum of the sorted pair stream) or
    ``"cumsum"`` (differences of its compensated prefix sum; slower, and
    kept as the reference keeps it).
    """
    if assembly not in ("segment", "cumsum"):
        raise ValueError(f"unknown assembly mode {assembly!r}")
    m, ng = shape
    dev = vals.device
    if pattern is None:
        pattern = SparsePattern(rows, cols, m, ng, device=dev)
    pat = (pattern.cumsum_tables(dev) if assembly == "cumsum"
           else pattern.tables(dev))
    dt = _DTYPES[cfg.dtype]
    B = vals.shape[0]
    c, vals, h = c.to(dt), vals.to(dt), h.to(dt)
    zeros = torch.zeros((B, m), dtype=dt, device=dev)
    if equilibrate:
        vals_s, c_s, h_s, r, cl = _ruiz_sparse(pat["rows"], pat["cols"],
                                               vals, c, h, m, ng)
    else:
        vals_s, c_s, h_s = vals, c, h
    cs = torch.cat([c_s, zeros], dim=1)
    state = _ipm_core(cs, _SparseSlackOp(pat, vals_s, m, ng), h_s, cfg)
    res = ipm_state_to_result(cs, state)
    if equilibrate:
        # x_user = C x', slack = s' / r, y = R y' (certificate rays too)
        x = torch.cat([res.x[:, :ng] * cl, res.x[:, ng:] / r], dim=1)
        res = res._replace(x=x, y=res.y * r)
    cost = (torch.cat([c, zeros], dim=1) * res.x).sum(dim=1)
    return res._replace(cost=cost)


def _densify_lanes(rows, cols, vals, m, ng):
    """Shared-pattern values into a dense ``[bucket, m, ng]`` (an
    assignment onto distinct coordinates)."""
    rows = torch.as_tensor(rows, dtype=torch.long, device=vals.device)
    cols = torch.as_tensor(cols, dtype=torch.long, device=vals.device)
    Z = torch.zeros((vals.shape[0], m, ng), dtype=vals.dtype,
                    device=vals.device)
    Z[:, rows, cols] = vals
    return Z


def recover_stragglers_sparse(c, rows, cols, vals, h, shape, res,
                              recover_cfg=None, maxiters=None):
    """Repair non-OPTIMAL sparse-IPM lanes to exact vertices.

    Gathers the stragglers into a power-of-two bucket (at least 8, at most
    B, cyclic fill), densifies only that bucket and sends it through the
    pooled dense crossover
    (:func:`linprog_tpu_torch.ipm.recover_stragglers_pooled`).  Crossed
    lanes come back as exact vertices with a basis; the others keep their
    sparse-IPM answer and status.  ``res`` is the slack-extended result of
    :func:`ipm_solve_batch_sparse_canonical` (``y`` feeds the Tapia
    ranking).  Returns the (possibly replaced) :class:`BatchResult`.
    """
    m, ng = shape
    bad = np.flatnonzero(res.status.cpu().numpy() != st.OPTIMAL)
    if bad.size == 0:
        return res
    B = vals.shape[0]
    dev = vals.device
    bucket = min(max(8, 1 << int(bad.size - 1).bit_length()), B)
    idx = np.resize(bad, bucket)
    idx_dev = torch.as_tensor(idx, dtype=torch.long, device=dev)

    G_sub = _densify_lanes(rows, cols, vals[idx_dev], m, ng)
    sub = BatchResult(*(None if t is None else t[idx_dev] for t in res))
    rec = recover_stragglers_pooled(
        [(c[idx_dev], G_sub, h[idx_dev])], [sub], recover_cfg=recover_cfg,
        maxiters=maxiters,
    )[0]
    rec_ok = rec.status.cpu().numpy() == st.OPTIMAL

    seen, lanes, ks = set(), [], []
    for k, lane in enumerate(idx.tolist()):
        if lane in seen or not rec_ok[k]:
            continue
        seen.add(lane)
        lanes.append(lane)
        ks.append(k)
    if not lanes:
        return res
    li = torch.tensor(lanes, dtype=torch.long, device=dev)
    ki = torch.tensor(ks, dtype=torch.long, device=dev)
    x, basis, cost = res.x.clone(), res.basis.clone(), res.cost.clone()
    iters, status = res.iters.clone(), res.status.clone()
    x[li] = rec.x[ki].to(x.dtype)
    basis[li] = rec.basis[ki]
    cost[li] = rec.cost[ki].to(cost.dtype)
    iters[li] = iters[li] + rec.iters[ki] - sub.iters[ki]
    status[li] = st.OPTIMAL
    y = res.y
    if y is not None:
        y = y.clone()
        y[li] = rec.y[ki].to(y.dtype)
    return BatchResult(x=x, basis=basis, cost=cost, iters=iters,
                       status=status, y=y)
