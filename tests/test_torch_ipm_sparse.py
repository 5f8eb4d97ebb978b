"""linprog_tpu_torch.ipm_sparse and the sparse generators against
linprog_tpu's on the same numpy instances (the counterpart of
tests/test_ipm_sparse.py).

The pattern's tables equal the reference's array for array; the operator's
products and its normal matrix agree with the reference's (1e-6 relative)
and with the dense slack operator; the solve gives the reference's
statuses, Newton steps within 1 and costs within 1e-4 relative; the
straggler recovery repairs a starved batch to HiGHS's optima.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog as scipy_linprog

from linprog_tpu import generators as jgen
from linprog_tpu import ipm_sparse as jsp
from linprog_tpu.ipm import IPMConfig as JaxIPMConfig

from linprog_tpu_torch import generators, ipm_sparse
from linprog_tpu_torch import status as st
from linprog_tpu_torch.ipm import IPMConfig, _SlackOp, ipm_solve_batch_canonical
from linprog_tpu_torch.ipm_sparse import (
    SparsePattern,
    _SparseSlackOp,
    ipm_solve_batch_sparse_canonical,
    recover_stragglers_sparse,
)

B, M, N, DENS = 8, 48, 48, 0.15


def _instances(seed=5, b=B, m=M, n=N, dens=DENS):
    c, rows, cols, vals, h = generators.random_sparse_inequality_lps(
        b, m, n, dens, seed=seed)
    G = np.zeros((b, m, n), np.float32)
    G[:, rows, cols] = vals
    return c, rows, cols, vals, h, G


def _ref_pattern(pat):
    return {k: jnp.asarray(getattr(pat, k))
            for k in ("row_cols", "row_slot", "row_mask", "col_rows",
                      "col_slot", "col_mask", "pair_perm", "pair_ids")}


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _highs(c, G, h):
    out = []
    for i in range(c.shape[0]):
        r = scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                          method="highs")
        out.append(r.fun if r.status == 0 else np.nan)
    return np.array(out)


def _rel(a, b):
    return np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))


@pytest.mark.parametrize("shape", [(48, 48, 0.15, 5), (30, 70, 0.05, 1),
                                   (64, 32, 0.3, 2)])
def test_host_generators_and_pattern_tables_equal_the_reference(shape):
    m, n, dens, seed = shape
    mine = generators.random_sparse_inequality_lps(3, m, n, dens, seed=seed)
    theirs = jgen.random_sparse_inequality_lps(3, m, n, dens, seed=seed)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    rows, cols = mine[1], mine[2]
    np.testing.assert_array_equal(
        np.stack(generators.random_sparse_pattern(m, n, dens, seed)),
        np.stack(jgen.random_sparse_pattern(m, n, dens, seed)))
    pat = SparsePattern(rows, cols, m, n, device="cpu")
    ref = jsp.SparsePattern(rows, cols, m, n)
    assert (pat.k_row, pat.k_col, pat.nnz) == (ref.k_row, ref.k_col, ref.nnz)
    for key in ("row_cols", "row_slot", "row_mask", "col_rows", "col_slot",
                "col_mask", "pair_perm", "pair_ids"):
        a, b = getattr(pat, key), getattr(ref, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    # the segment form covers the stream: one run per distinct target
    assert pat.pair_starts[-1] == pat.pair_ids.size
    np.testing.assert_array_equal(pat.pair_ids[pat.pair_starts[:-1]],
                                  pat.pair_targets)


def test_pattern_with_empty_rows_and_columns_equals_the_reference():
    rows = np.array([1, 2, 3, 4, 1], np.int32)
    cols = np.array([2, 1, 4, 3, 4], np.int32)
    pat = SparsePattern(rows, cols, 6, 6, device="cpu")
    ref = jsp.SparsePattern(rows, cols, 6, 6)
    for key in ("row_cols", "row_slot", "row_mask", "col_rows", "col_slot",
                "col_mask", "pair_perm", "pair_ids"):
        np.testing.assert_array_equal(getattr(pat, key), getattr(ref, key))


def test_sparse_op_matches_reference_and_dense_slack_op():
    c, rows, cols, vals, h, G = _instances()
    pat = SparsePattern(rows, cols, M, N, device="cpu")
    op = _SparseSlackOp(pat.tables(), torch.tensor(vals), M, N)
    ref = jsp._SparseSlackOp(_ref_pattern(jsp.SparsePattern(rows, cols, M, N)),
                             jnp.asarray(vals), M, N)
    dop = _SlackOp(torch.tensor(G))
    rng = np.random.default_rng(0)
    v = rng.random((B, N + M)).astype(np.float32)
    w = rng.random((B, M)).astype(np.float32)
    # the spread of d near convergence (x / s over ~1e8)
    d = np.exp(rng.uniform(-9.0, 9.0, (B, N + M))).astype(np.float32)
    for name, mine, theirs, arg in (("mv", op.mv, ref.mv, v),
                                    ("mtv", op.mtv, ref.mtv, w)):
        a = mine(torch.tensor(arg)).numpy()
        b = np.asarray(theirs(jnp.asarray(arg)))
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), name
    Nm = op.normal(torch.tensor(d)).numpy()
    Nr = np.asarray(ref.normal(jnp.asarray(d)))
    assert np.abs(Nm - Nr).max() <= 1e-6 * np.abs(Nr).max()
    np.testing.assert_array_equal(Nm, Nm.transpose(0, 2, 1))
    Nd = dop.normal(torch.tensor(d)).double().numpy()
    assert np.abs(Nm - Nd).max() <= 1e-5 * np.abs(Nd).max()
    np.testing.assert_allclose(op.max_abs().numpy(), np.asarray(ref.max_abs()),
                               rtol=1e-6)
    # the same inputs give the same bits
    np.testing.assert_array_equal(op.normal(torch.tensor(d)).numpy(), Nm)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sparse_ipm_matches_reference(dtype):
    c, rows, cols, vals, h, G = _instances()
    kw = dict(eps_rel=1e-3, maxiters=40, dtype=dtype)
    ref = jsp.ipm_solve_batch_sparse_canonical(
        c, rows, cols, vals, h, (M, N), JaxIPMConfig(**kw))
    res = ipm_solve_batch_sparse_canonical(*_t(c), rows, cols, *_t(vals, h),
                                           (M, N), IPMConfig(**kw))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert int((res.status == st.OPTIMAL).sum()) >= B - 1
    assert np.abs(res.iters.numpy() - np.asarray(ref.iters)).max() <= 1
    assert _rel(res.cost.numpy(), np.asarray(ref.cost)).max() < 1e-4
    assert res.x.shape == (B, N + M) and res.y.shape == (B, M)
    assert bool((res.basis == -1).all())
    gaps = _rel(res.cost.numpy(), _highs(c, G, h))
    assert np.nanmax(gaps) < 5e-3
    # without equilibration as well, and against the dense IPM
    ref_raw = jsp.ipm_solve_batch_sparse_canonical(
        c, rows, cols, vals, h, (M, N), JaxIPMConfig(**kw),
        equilibrate=False)
    raw = ipm_solve_batch_sparse_canonical(*_t(c), rows, cols, *_t(vals, h),
                                           (M, N), IPMConfig(**kw),
                                           equilibrate=False)
    np.testing.assert_array_equal(raw.status.numpy(),
                                  np.asarray(ref_raw.status))
    assert np.abs(raw.iters.numpy() - np.asarray(ref_raw.iters)).max() <= 1
    dense = ipm_solve_batch_canonical(*_t(c, G, h), IPMConfig(**kw))
    np.testing.assert_array_equal(raw.status.numpy(), dense.status.numpy())


def test_sparse_ipm_infeasible_certificate():
    """Farkas grading through the sparse operator: no lane OPTIMAL, some
    certified, the reference's verdicts and the dense IPM's."""
    c, rows, cols, vals, h, G = _instances(seed=9)
    r0 = rows == rows[0]
    vals = vals.copy()
    vals[:, r0] = np.abs(vals[:, r0]) + 0.1
    h = h.copy()
    h[:, rows[0]] = -1.0
    cfg = dict(eps_rel=1e-3, maxiters=40)
    res = ipm_solve_batch_sparse_canonical(*_t(c), rows, cols, *_t(vals, h),
                                           (M, N), IPMConfig(**cfg),
                                           equilibrate=False)
    ref = jsp.ipm_solve_batch_sparse_canonical(
        c, rows, cols, vals, h, (M, N), JaxIPMConfig(**cfg),
        equilibrate=False)
    status = res.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(ref.status))
    assert (status == st.OPTIMAL).sum() == 0
    assert (status == st.PRIMAL_INFEASIBLE).sum() >= 1
    Gd = np.zeros_like(G)
    Gd[:, rows, cols] = vals
    dense = ipm_solve_batch_canonical(*_t(c, Gd, h), IPMConfig(**cfg))
    np.testing.assert_array_equal(status, dense.status.numpy())


def test_ruiz_matches_reference_and_leaves_empty_segments_unscaled():
    c, rows, cols, vals, h, _ = _instances()
    mine = ipm_sparse._ruiz_sparse(rows, cols, *_t(vals, c, h), M, N)
    theirs = jsp._ruiz_sparse(jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(vals), jnp.asarray(c),
                              jnp.asarray(h), M, N)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # rows 0 and 5, columns 0 and 5 are empty
    rows = np.array([1, 2, 3, 4], np.int32)
    cols = np.array([2, 1, 4, 3], np.int32)
    vals = torch.tensor([[2.0, 0.5, 8.0, 1.0]])
    vals_s, _, _, r, cl = ipm_sparse._ruiz_sparse(
        rows, cols, vals, torch.ones((1, 6)), torch.ones((1, 6)), 6, 6)
    assert bool(torch.isfinite(r).all() and torch.isfinite(cl).all())
    assert float(r[0, 0]) == 1.0 and float(cl[0, 5]) == 1.0
    np.testing.assert_allclose(vals_s.abs().numpy(), 1.0, atol=1e-3)


def test_device_generator_is_feasible_and_repeatable():
    rows, cols = generators.random_sparse_pattern(16, 16, 0.2, seed=1)
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(0)
        draws.append(generators.device_sparse_inequality_lps(
            gen, 4, rows, cols, 16, 16, "cpu"))
    c, vals, h = draws[0]
    assert c.shape == (4, 16) and h.shape == (4, 16)
    assert vals.shape == (4, rows.shape[0])
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    G = np.zeros((4, 16, 16), np.float32)
    G[:, rows, cols] = vals.numpy()
    assert np.all(np.isfinite(_highs(c.numpy(), G, h.numpy())))


def test_sparse_straggler_recovery_repairs_every_lane():
    """A starved sparse IPM leaves stragglers; the densified bucket through
    the pooled crossover returns every lane as an exact vertex with a
    basis, at HiGHS's optimum."""
    Bs, m, n = 8, 24, 24
    c, rows, cols, vals, h, G = _instances(seed=9, b=Bs, m=m, n=n, dens=0.3)
    ct, vt, ht = _t(c, vals, h)
    res = ipm_solve_batch_sparse_canonical(ct, rows, cols, vt, ht, (m, n),
                                           IPMConfig(eps_rel=1e-3,
                                                     maxiters=4))
    ref = jsp.ipm_solve_batch_sparse_canonical(
        c, rows, cols, vals, h, (m, n), JaxIPMConfig(eps_rel=1e-3,
                                                     maxiters=4))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert int((res.status == st.OPTIMAL).sum()) < Bs
    rec = recover_stragglers_sparse(ct, rows, cols, vt, ht, (m, n), res)
    assert bool((rec.status == st.OPTIMAL).all())
    assert bool((rec.basis >= 0).all())
    assert rec.x.shape == (Bs, n + m)
    assert _rel(rec.cost.numpy(), _highs(c, G, h)).max() < 2e-5
    # no straggler: the result comes back as it was
    assert recover_stragglers_sparse(ct, rows, cols, vt, ht, (m, n),
                                     rec) is rec


def test_cumsum_assembly_is_not_ported():
    """Once refused, ``assembly="cumsum"`` now runs (the name is kept from
    when the mode was refused): it gives the segment assembly's statuses
    and costs within 2e-3 (two answers of the eps 1e-3 class, the
    reference's own tolerance between its two modes), and an unknown mode
    still raises."""
    c, rows, cols, vals, h, _ = _instances()
    kw = dict(cfg=IPMConfig(eps_rel=1e-3, maxiters=40))
    seg = ipm_solve_batch_sparse_canonical(*_t(c), rows, cols, *_t(vals, h),
                                           (M, N), **kw)
    cum = ipm_solve_batch_sparse_canonical(*_t(c), rows, cols, *_t(vals, h),
                                           (M, N), assembly="cumsum", **kw)
    np.testing.assert_array_equal(cum.status.numpy(), seg.status.numpy())
    assert _rel(cum.cost.numpy(), seg.cost.numpy()).max() < 2e-3
    with pytest.raises(ValueError, match="unknown assembly"):
        ipm_solve_batch_sparse_canonical(*_t(c), rows, cols, *_t(vals, h),
                                         (M, N), assembly="scatter")


def test_cumsum_assembly_matches_float64_and_the_reference():
    """At the size of the reference's own test
    (``tests/test_ipm_sparse.py::test_cumsum_assembly_matches_segment_assembly``:
    B = 6, m = n = 32, density 0.25, seed 2): the compensated prefix-sum
    normal matrix is within 1e-5 relative of a float64 segment sum even
    where d spreads over ~1e8 (where a plain f32 prefix cancels), the
    segment bounds equal the reference's, and the IPM gives the
    reference's cumsum statuses, Newton steps within 1 and costs within
    2e-3 (the eps 1e-3 class: the two normal matrices round apart)."""
    Bs, m, n = 6, 32, 32
    c, rows, cols, vals, h = jgen.random_sparse_inequality_lps(
        Bs, m, n, density=0.25, seed=2)
    pat = SparsePattern(rows, cols, m, n, device="cpu")
    ref_pat = jsp.SparsePattern(rows, cols, m, n)
    for mine, theirs in zip(pat.seg_bounds(), ref_pat.seg_bounds()):
        np.testing.assert_array_equal(mine, theirs)
    rng = np.random.default_rng(0)
    d = np.exp(rng.uniform(-9.0, 9.0, (Bs, n + m))).astype(np.float32)
    vt, dt = torch.tensor(vals), torch.tensor(d)
    N_cum = _SparseSlackOp(pat.cumsum_tables("cpu"), vt, m, n).normal(dt)
    N_64 = _SparseSlackOp(pat.tables(), vt.double(), m, n).normal(dt.double())
    err = (N_cum.double() - N_64).abs().amax(dim=(1, 2))
    assert bool((err <= 1e-5 * N_64.abs().amax(dim=(1, 2))).all()), err
    # a plain f32 prefix sum loses these entries (what the pairs guard)
    s, e = ipm_sparse.compensated_cumsum(torch.tensor([[1e8], [1.0], [1.0]]))
    assert float((s[3] - s[1]) + (e[3] - e[1])) == 2.0
    cfg = dict(eps_rel=1e-3, maxiters=40)
    ref = jsp.ipm_solve_batch_sparse_canonical(
        c, rows, cols, vals, h, (m, n), JaxIPMConfig(**cfg), assembly="cumsum")
    res = ipm_solve_batch_sparse_canonical(*_t(c), rows, cols, *_t(vals, h),
                                           (m, n), IPMConfig(**cfg),
                                           assembly="cumsum")
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert np.abs(res.iters.numpy() - np.asarray(ref.iters)).max() <= 1
    assert _rel(res.cost.numpy(), np.asarray(ref.cost)).max() < 2e-3


def test_pattern_wants_a_card_or_the_cpu(monkeypatch):
    rows, cols = generators.random_sparse_pattern(8, 8, 0.3, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparsePattern(rows, cols, 8, 8)
    pat = SparsePattern(rows, cols, 8, 8, device="cpu")
    assert pat.tables()["row_cols"].device.type == "cpu"
    # a prebuilt pattern serves the solve
    c, _, _, vals, h = generators.random_sparse_inequality_lps(2, 8, 8, 0.3)
    res = ipm_solve_batch_sparse_canonical(*_t(c), rows, cols, *_t(vals, h),
                                           (8, 8), pattern=pat)
    assert res.status.shape == (2,)
