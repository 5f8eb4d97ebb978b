"""linprog_tpu_torch.pdhg against linprog_tpu.pdhg on the same numpy
instances (the counterpart of tests/test_pdhg.py).

The power iteration's start vector is the one thing torch cannot draw as
the reference does (``jax.random.normal(PRNGKey(0), (n,))``); the
``reference_start`` fixture hands the port the reference's vector, so both
packages use the same ``||K||`` estimate and can be held lane by lane: in
float64 the same status and iteration count on every lane and ``x``, ``y``
within 1e-7 of scale; in f32 the same status and the objective within the
eps class of HiGHS.  The port's own start vector is tested on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse
from scipy.optimize import linprog as scipy_linprog

from linprog_tpu import pdhg as jpdhg
from linprog_tpu.generators import random_inequality_lps, transportation_lps

from linprog_tpu_torch import pdhg
from linprog_tpu_torch import status as st
from linprog_tpu_torch.convert import pdhg_state_from_numpy, pdhg_state_to_numpy
from linprog_tpu_torch.pdhg import (
    PDHGConfig,
    PDHGSolver,
    pdhg_solve_batch,
    pdhg_solve_batch_canonical,
    pdhg_solve_batch_sparse,
    pdhg_solve_sparse,
)

CFG64 = dict(eps_rel=1e-5, maxiters=100_000, dtype="float64")


@pytest.fixture
def reference_start(monkeypatch):
    def start(n, dtype, device, seed=0):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        v = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,), jdt))
        return torch.as_tensor(v, device=device)

    monkeypatch.setattr(pdhg, "_power_start", start)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _scale(a):
    return max(1.0, float(np.abs(a).max()))


def _assert_same_state(mine, theirs, tol=1e-7):
    np.testing.assert_array_equal(mine.status.numpy(),
                                  np.asarray(theirs.status))
    np.testing.assert_array_equal(mine.iters.numpy(), np.asarray(theirs.iters))
    for name in ("x", "y"):
        a, b = getattr(mine, name).numpy(), np.asarray(getattr(theirs, name))
        assert np.abs(a - b).max() <= tol * _scale(b), name


def _highs_costs(c, G, h, **kw):
    out = []
    for i in range(c.shape[0]):
        r = scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], method="highs", **kw)
        assert r.status == 0
        out.append(r.fun)
    return np.array(out)


def _rel(a, b):
    return np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))


@pytest.mark.parametrize("variant", [
    dict(adaptive=True), dict(adaptive=False), dict(halpern=True),
    dict(halpern=True, halpern_patience=300),
], ids=["adaptive", "fixed", "halpern", "halpern_reverts"])
def test_batch_float64_matches_reference(reference_start, variant):
    B, m, n = 6, 8, 12
    c, G, h = random_inequality_lps(B, m, n, seed=3, dtype=np.float64)
    lb, ub = np.zeros((B, n)), np.full((B, n), np.inf)
    ref = jpdhg.pdhg_solve_batch(*_j(c, G, h), 0, *_j(lb, ub), 100_000,
                                 jpdhg.PDHGConfig(**CFG64, **variant))
    mine = pdhg_solve_batch(*_t(c, G, h), 0, *_t(lb, ub), 100_000,
                            PDHGConfig(**CFG64, **variant))
    _assert_same_state(mine, ref)
    assert bool((mine.status == st.OPTIMAL).all())
    np.testing.assert_array_equal(mine.halpern_off.numpy(),
                                  np.asarray(ref.halpern_off))
    np.testing.assert_allclose(mine.omega.numpy(), np.asarray(ref.omega),
                               rtol=1e-9)


def test_canonical_float32_matches_reference_and_highs(reference_start):
    """The Ruiz-equilibrated canonical batch in f32 (the bench's form):
    the reference's statuses, objectives within the eps class of HiGHS."""
    B, m, n = 8, 12, 16
    c, G, h = random_inequality_lps(B, m, n, seed=17)
    for adaptive in (True, False):
        jcfg = jpdhg.PDHGConfig(eps_rel=1e-4, adaptive=adaptive)
        tcfg = PDHGConfig(eps_rel=1e-4, adaptive=adaptive)
        _, jcost, jstatus, jiters = jpdhg.pdhg_solve_batch_canonical(
            *_j(c, G, h), 40_000, jcfg)
        x, cost, status, iters = pdhg_solve_batch_canonical(
            *_t(c, G, h), 40_000, tcfg)
        np.testing.assert_array_equal(status.numpy(), np.asarray(jstatus))
        assert bool((status == st.OPTIMAL).all())
        assert x.dtype == torch.float32 and x.shape == (B, n)
        ref = _highs_costs(c, G, h, bounds=(0, None))
        assert _rel(cost.numpy(), ref).max() < 1e-3
        assert _rel(np.asarray(jcost), ref).max() < 1e-3


def test_canonical_float64_matches_reference(reference_start):
    B, m, n = 4, 12, 16
    c, G, h = random_inequality_lps(B, m, n, seed=17, dtype=np.float64)
    cfg = dict(eps_rel=1e-5, dtype="float64")
    jx, jcost, jstatus, jiters = jpdhg.pdhg_solve_batch_canonical(
        *_j(c, G, h), 200_000, jpdhg.PDHGConfig(**cfg))
    x, cost, status, iters = pdhg_solve_batch_canonical(
        *_t(c, G, h), 200_000, PDHGConfig(**cfg))
    np.testing.assert_array_equal(status.numpy(), np.asarray(jstatus))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert np.abs(x.numpy() - np.asarray(jx)).max() <= 1e-7 * _scale(jx)
    assert _rel(cost.numpy(), _highs_costs(c, G, h, bounds=(0, None))
                ).max() < 1e-3


def test_frozen_lanes_keep_their_state(reference_start):
    """A lane that finished before a chunk keeps every field bit for bit
    while the others run on (the vmapped while loop's per-lane select);
    running lanes stop at the first chunk boundary past ``maxiters``."""
    B, m, n = 6, 8, 12
    c, G, h = random_inequality_lps(B, m, n, seed=3, dtype=np.float64)
    lb, ub = np.zeros((B, n)), np.full((B, n), np.inf)
    cfg = PDHGConfig(**CFG64)
    init_state, run = pdhg._pdhg_core(*_t(c, G, h), 0, *_t(lb, ub), cfg)
    s1 = run(init_state(), 300)
    done = (s1.status == st.OPTIMAL).numpy()
    assert done.any() and not done.all()
    # the running lanes overshoot 300 to the next multiple of 64
    assert (s1.iters.numpy()[~done] == 320).all()
    s2 = run(s1, 100_000)
    assert bool((s2.status == st.OPTIMAL).all())
    assert (s2.iters.numpy()[~done] > 320).all()
    for a, b in zip(s1, s2):
        np.testing.assert_array_equal(a.numpy()[done], b.numpy()[done])
    # the same as the reference's lanes, frozen ones included
    ref = jpdhg.pdhg_solve_batch(*_j(c, G, h), 0, *_j(lb, ub), 100_000,
                                 jpdhg.PDHGConfig(**CFG64))
    _assert_same_state(s2, ref)


def test_own_norm_estimate_is_within_five_percent_below():
    rng = np.random.default_rng(0)
    for m, n in ((8, 12), (40, 30), (64, 64)):
        K = rng.standard_normal((3, m, n))
        est = pdhg._estimate_norm(torch.tensor(K), 30, lanes=3).numpy()
        true = np.linalg.norm(K, 2, axis=(1, 2))
        assert np.all(est <= true * (1 + 1e-12))
        assert np.all(est >= 0.95 * true)
    # the start vector is the port's own, drawn the same every time
    a = pdhg._power_start(16, torch.float32, "cpu")
    np.testing.assert_array_equal(a.numpy(),
                                  pdhg._power_start(16, torch.float32,
                                                    "cpu").numpy())


@pytest.mark.parametrize("halpern", [False, True])
def test_certificates(reference_start, halpern):
    """Infeasible and unbounded instances through the general-form solver
    (equality rows, certificates from the epoch's movement)."""
    cfg = dict(eps_rel=1e-6, maxiters=40_000 if halpern else 20_000,
               halpern=halpern)
    infeasible = dict(c=np.array([1.0, 1.0]), A=np.array([[1.0, 1.0]]),
                      b=np.array([2.0]), G=np.array([[1.0, 1.0]]),
                      h=np.array([1.0]))
    unbounded = dict(c=np.array([-1.0, 0.0]), G=np.array([[1.0, -1.0]]),
                     h=np.array([1.0]))
    for case, want in ((infeasible, st.PRIMAL_INFEASIBLE),
                       (unbounded, st.PRIMAL_UNBOUNDED)):
        ref = jpdhg.PDHGSolver(**case, config=jpdhg.PDHGConfig(**cfg)).solve()
        mine = PDHGSolver(**case, config=PDHGConfig(**cfg),
                          device="cpu").solve()
        assert mine.status == ref.status == want
        assert mine.iters == ref.iters


def test_general_form_matches_reference(reference_start):
    """Equality rows, finite upper bounds, a lower bound above zero; the
    textbook instance; the duals property."""
    eq = dict(c=np.array([-1.0, 0.0]), A=np.array([[1.0, 1.0]]),
              b=np.array([3.0]), lb=np.array([0.5, 0.0]),
              ub=np.array([2.0, np.inf]))
    ineq = dict(c=np.array([-1.0, -2.0]),
                G=np.array([[1.0, 1.0], [0.0, 1.0]]), h=np.array([4.0, 2.0]))
    for case, cfg in ((eq, CFG64), (ineq, CFG64), (ineq, {})):
        ref_s = jpdhg.PDHGSolver(**case, config=jpdhg.PDHGConfig(**cfg))
        mine_s = PDHGSolver(**case, config=PDHGConfig(**cfg), device="cpu")
        ref, mine = ref_s.solve(), mine_s.solve()
        assert mine.optimum and ref.optimum
        assert mine.iters == ref.iters
        np.testing.assert_allclose(mine.x, ref.x, atol=1e-5)
        assert mine.cost == pytest.approx(ref.cost, abs=1e-5)
        np.testing.assert_allclose(mine_s.duals, ref_s.duals, atol=1e-5)
        assert mine.basis is None
    assert mine.cost == pytest.approx(-6.0, abs=1e-3)
    with pytest.raises(AttributeError):
        PDHGSolver(**ineq, device="cpu").duals
    with pytest.raises(ValueError):
        PDHGSolver(np.ones(2), device="cpu")


def test_entry_points_want_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = dict(c=np.array([-1.0]), G=np.array([[1.0]]), h=np.array([1.0]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PDHGSolver(**case)
    K = torch.tensor([[1.0]]).to_sparse()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdhg_solve_sparse(case["c"], K, case["h"])
    assert PDHGSolver(**case, device="cpu").solve().optimum


def test_sparse_batch_matches_reference_and_dense(reference_start):
    """The shared-pattern batch: the reference's sparse batch lane for
    lane in float64, and the port's dense batch on the densified
    instances."""
    rng = np.random.default_rng(5)
    B, m, n = 4, 12, 16
    mask = rng.random((m, n)) < 0.4
    mask[np.arange(m), rng.integers(0, n, m)] = True
    G = rng.standard_normal((B, m, n)) * mask[None]
    x0 = rng.random((B, n))
    h = np.einsum("bmn,bn->bm", G, x0) + rng.random((B, m))
    y0 = rng.random((B, m))
    c = 0.1 + 0.9 * rng.random((B, n)) - np.einsum("bmn,bm->bn", G, y0)
    lb, ub = np.zeros((B, n)), np.full((B, n), np.inf)
    rows, cols = np.nonzero(mask)
    vals = G[:, rows, cols]
    cfg = dict(eps_rel=1e-6, maxiters=100_000, dtype="float64")
    ref = jpdhg.pdhg_solve_batch_sparse(c, rows, cols, vals, h, 0, lb, ub,
                                        (m, n), cfg=jpdhg.PDHGConfig(**cfg))
    mine = pdhg_solve_batch_sparse(*_t(c), rows, cols, *_t(vals, h), 0,
                                   *_t(lb, ub), (m, n),
                                   cfg=PDHGConfig(**cfg))
    _assert_same_state(mine, ref)
    dense = pdhg_solve_batch(*_t(c, G, h), 0, *_t(lb, ub),
                             cfg=PDHGConfig(**cfg))
    np.testing.assert_array_equal(dense.status.numpy(), mine.status.numpy())
    assert bool((mine.status == st.OPTIMAL).all())
    cost_s = (torch.tensor(c) * mine.x).sum(1).numpy()
    cost_d = (torch.tensor(c) * dense.x).sum(1).numpy()
    np.testing.assert_allclose(cost_s, cost_d, rtol=1e-4, atol=1e-4)


def test_sparse_single_matches_reference_bcoo(reference_start):
    """``pdhg_solve_sparse`` on a coalesced sparse COO tensor against the
    reference on the same matrix as a BCOO, and against HiGHS."""
    rng = np.random.default_rng(3)
    m, n = 40, 60
    G = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.1)
    G[np.arange(m), np.arange(m)] += 1.0
    h = G @ rng.uniform(0, 1, n) + rng.uniform(0.5, 1.5, m)
    c = 0.1 + rng.random(n) - G.T @ rng.uniform(0, 1, m)
    cfg = dict(eps_rel=1e-6, maxiters=300_000, dtype="float64")
    ref = jpdhg.pdhg_solve_sparse(c, jsparse.BCOO.fromdense(G), h, n_eq=0,
                                  cfg=jpdhg.PDHGConfig(**cfg))
    mine = pdhg_solve_sparse(c, torch.tensor(G).to_sparse(), h, n_eq=0,
                             cfg=PDHGConfig(**cfg), device="cpu")
    assert mine.optimum and ref.optimum
    assert mine.iters == ref.iters
    assert mine.cost == pytest.approx(ref.cost, abs=1e-6)
    highs = scipy_linprog(c, A_ub=G, b_ub=h, bounds=(0, None),
                          method="highs")
    assert mine.cost == pytest.approx(highs.fun, abs=1e-3)


def test_sparse_batch_of_structured_lps_with_equalities(reference_start):
    """The sparse-batch example's family: transportation LPs (equality
    rows only, one redundant) on one shared pattern, as
    examples/sparse_batch.py runs them."""
    c, A, b = transportation_lps(16, 6, 8, seed=7)
    B, m, n = A.shape
    rows, cols = np.nonzero(A[0])
    vals = A[:, rows, cols]
    cfg = dict(eps_rel=1e-6, dtype="float64")
    lb, ub = np.zeros((B, n)), np.full((B, n), np.inf)
    ref = jpdhg.pdhg_solve_batch_sparse(c, rows, cols, vals, b, m, lb, ub,
                                        (m, n), maxiters=200_000,
                                        cfg=jpdhg.PDHGConfig(**cfg))
    mine = pdhg_solve_batch_sparse(*_t(c), rows, cols, *_t(vals, b), m,
                                   *_t(lb, ub), (m, n), maxiters=200_000,
                                   cfg=PDHGConfig(**cfg))
    np.testing.assert_array_equal(mine.status.numpy(),
                                  np.asarray(ref.status))
    assert int((mine.status == st.OPTIMAL).sum()) == B
    costs = np.einsum("bn,bn->b", c, mine.x.numpy())
    for i in range(4):
        r = scipy_linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=(0, None),
                          method="highs")
        assert abs(costs[i] - r.fun) / abs(r.fun) < 1e-4


def test_pdhg_state_round_trips_through_numpy(reference_start):
    B, m, n = 3, 5, 7
    c, G, h = random_inequality_lps(B, m, n, seed=4, dtype=np.float64)
    lb, ub = np.zeros((B, n)), np.full((B, n), np.inf)
    ref = jpdhg.pdhg_solve_batch(*_j(c, G, h), 0, *_j(lb, ub), 128,
                                 jpdhg.PDHGConfig(**CFG64, halpern=True))
    state = pdhg_state_from_numpy(
        {k: np.asarray(v) for k, v in ref._asdict().items()},
        dtype=torch.float64)
    assert state.halpern_off.dtype == torch.bool
    assert state.iters.dtype == torch.int32
    back = pdhg_state_to_numpy(state)
    for k, v in ref._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    # a reference state continues in the port as it would have there
    init_state, run = pdhg._pdhg_core(*_t(c, G, h), 0, *_t(lb, ub),
                                      PDHGConfig(**CFG64, halpern=True))
    mine = run(state, 100_000)
    theirs = jpdhg.pdhg_solve_batch(*_j(c, G, h), 0, *_j(lb, ub), 100_000,
                                    jpdhg.PDHGConfig(**CFG64, halpern=True))
    _assert_same_state(mine, theirs)
