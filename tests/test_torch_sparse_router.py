"""linprog_tpu_torch's sparse front door and PDHG -> crossover against the
reference's on the same numpy instances (the sparse half of
tests/test_router.py and tests/test_ipm_sparse.py, and
``crossover.pdhg_crossover_batch_canonical``).

The routing rule is held on a grid; ``solve_batch_auto_sparse`` in both
families gives the reference's family, statuses and answers (HiGHS within
the eps 1e-3 class: 2e-3, the gap criterion scaling by
``1 + |primal| + |dual|``); its ``"pdhg"``
branch returns the solver's statuses unmapped, RUNNING included, as the
reference does.  The crossover from PDHG points crosses at least as many
lanes as the reference's (which runs its segment kernel in interpret mode).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog as scipy_linprog


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Same XLA CPU compile-count workaround as tests/test_solve_kernel.py."""
    jax.clear_caches()
    yield
    jax.clear_caches()


from linprog_tpu import crossover as jxover  # noqa: E402
from linprog_tpu import router as jrouter  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402

import linprog_tpu_torch  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from linprog_tpu_torch.crossover import pdhg_crossover_batch_canonical  # noqa: E402
from linprog_tpu_torch.generators import (  # noqa: E402
    random_inequality_lps,
    random_sparse_inequality_lps,
)
from linprog_tpu_torch.router import (  # noqa: E402
    choose_family_sparse,
    solve_batch_auto_sparse,
)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _dense(rows, cols, vals, m, n):
    G = np.zeros((vals.shape[0], m, n), np.float32)
    G[:, rows, cols] = vals
    return G


def _highs(c, G, h):
    return np.array([
        scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                      method="highs").fun for i in range(c.shape[0])])


def _rel(a, b):
    return np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))


def test_sparse_routing_rule_matches_reference_on_a_grid():
    for m in (64, 512, 2048, 4096, 16384, 65536):
        for lanes in (1, 8, 128, 1024):
            for density in (1e-4, 1e-3, 1e-2, 0.1):
                nnz = max(m, int(density * m * m))
                for acc in (1e-6, 1e-4, 1e-3, 1e-2, 5e-2, 0.1):
                    assert (choose_family_sparse(m, m, nnz, acc, lanes)
                            == jrouter.choose_family_sparse(m, m, nnz, acc,
                                                            lanes))
    assert choose_family_sparse(2048, 2048, 41943, 1e-3, lanes=128) == "ipm"
    assert choose_family_sparse(65536, 65536, 400000, 1e-3, lanes=8) == "pdhg"
    assert choose_family_sparse(4096, 4096, 16384, 1e-2, lanes=1) == "pdhg"


def test_sparse_front_door_ipm_with_recovery_matches_reference():
    Bs, m, n = 6, 20, 20
    c, rows, cols, vals, h = random_sparse_inequality_lps(Bs, m, n, 0.3,
                                                          seed=4)
    ref, jinfo = jrouter.solve_batch_auto_sparse(
        jnp.asarray(c), rows, cols, jnp.asarray(vals), jnp.asarray(h),
        (m, n), accuracy=1e-3)
    res, info = solve_batch_auto_sparse(*_t(c), rows, cols, *_t(vals, h),
                                        (m, n), accuracy=1e-3)
    assert info == jinfo and info["family"] == "sparse-ipm"
    assert info["recovered"]
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert bool((res.status == st.OPTIMAL).all())
    assert res.x.shape == (Bs, n)
    highs = _highs(c, _dense(rows, cols, vals, m, n), h)
    assert _rel(res.cost.numpy(), highs).max() < 2e-3
    # recover=False leaves the raw IPM's answer
    raw, rinfo = solve_batch_auto_sparse(*_t(c), rows, cols, *_t(vals, h),
                                         (m, n), accuracy=1e-3,
                                         recover=False)
    assert "recovered" not in rinfo and bool((raw.basis == -1).all())


def test_sparse_front_door_pdhg_matches_reference_statuses_unmapped():
    """The ``"pdhg"`` branch keeps the solver's status: a lane out of
    budget stays RUNNING in both packages (the dense front door maps it to
    ITER_LIMIT)."""
    Bs, m, n = 6, 20, 20
    c, rows, cols, vals, h = random_sparse_inequality_lps(Bs, m, n, 0.3,
                                                          seed=4)
    args_j = (jnp.asarray(c), rows, cols, jnp.asarray(vals), jnp.asarray(h),
              (m, n))
    args_t = (*_t(c), rows, cols, *_t(vals, h), (m, n))
    ref, jinfo = jrouter.solve_batch_auto_sparse(
        *args_j, accuracy=1e-3, prefer="pdhg", maxiters=40_000)
    res, info = solve_batch_auto_sparse(*args_t, accuracy=1e-3,
                                        prefer="pdhg", maxiters=40_000)
    assert info == jinfo and info["family"] == "sparse-pdhg"
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    ok = res.status.numpy() == st.OPTIMAL
    assert ok.sum() >= Bs - 1
    assert bool((res.basis == -1).all()) and res.y.shape == (Bs, m)
    # the gap criterion scales by 1 + |primal| + |dual|: up to twice eps
    # against the objective alone
    highs = _highs(c, _dense(rows, cols, vals, m, n), h)
    assert _rel(res.cost.numpy()[ok], highs[ok]).max() < 2e-3
    assert _rel(np.asarray(ref.cost)[ok], highs[ok]).max() < 2e-3
    # a starved budget: RUNNING lanes come back RUNNING, as the reference's
    ref, _ = jrouter.solve_batch_auto_sparse(*args_j, accuracy=1e-3,
                                             prefer="pdhg", maxiters=64)
    res, _ = solve_batch_auto_sparse(*args_t, accuracy=1e-3, prefer="pdhg",
                                     maxiters=64)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert bool((res.status == st.RUNNING).any())
    with pytest.raises(ValueError, match="unknown sparse family"):
        solve_batch_auto_sparse(*args_t, prefer="simplex")


def test_sparse_front_door_routes_loose_requests_to_pdhg():
    """At loose accuracy on a very sparse pattern the work model picks the
    first-order family, in both packages."""
    Bs, m, n = 4, 48, 48
    c, rows, cols, vals, h = random_sparse_inequality_lps(Bs, m, n, 0.02,
                                                          seed=6)
    nnz = rows.shape[0]
    assert choose_family_sparse(m, n, nnz, 1e-2, Bs) == "pdhg"
    res, info = solve_batch_auto_sparse(*_t(c), rows, cols, *_t(vals, h),
                                        (m, n), accuracy=1e-2)
    ref, jinfo = jrouter.solve_batch_auto_sparse(
        jnp.asarray(c), rows, cols, jnp.asarray(vals), jnp.asarray(h),
        (m, n), accuracy=1e-2)
    assert info == jinfo and info["family"] == "sparse-pdhg"
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert bool((res.status == st.OPTIMAL).all())


def test_pdhg_crossover_crosses_at_least_the_references_lanes():
    B, m, n = 8, 16, 16
    c, G, h = random_inequality_lps(B, m, n, seed=2)
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig",
                           polish_pivots=8, refactor_every=128)
    ref, jcrossed = jxover.pdhg_crossover_batch_canonical(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), cfg=jcfg)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    res, crossed = pdhg_crossover_batch_canonical(*_t(c, G, h), cfg=cfg)
    assert int(crossed.sum()) >= int(np.asarray(jcrossed).sum()) >= B - 1
    ok = crossed.numpy()
    assert bool((res.status[crossed] == st.OPTIMAL).all())
    assert bool((res.basis[crossed] >= 0).all())
    highs = _highs(c, G, h)
    assert _rel(res.cost.numpy()[ok], highs[ok]).max() < 1e-5
    # a starved first-order stage still gives supports the crossover uses
    res2, crossed2 = pdhg_crossover_batch_canonical(*_t(c, G, h),
                                                    pdhg_maxiters=256,
                                                    cfg=cfg)
    assert int(crossed2.sum()) >= 1
    assert _rel(res2.cost.numpy()[crossed2.numpy()],
                highs[crossed2.numpy()]).max() < 1e-5


def test_package_exports_the_first_order_and_sparse_families():
    import linprog_tpu

    new = ["PDHGConfig", "PDHGSolver", "SparsePattern",
           "ipm_solve_batch_sparse_canonical", "recover_stragglers_sparse",
           "solve_batch_auto_sparse", "choose_family_sparse",
           "pdhg_crossover_batch_canonical"]
    for name in new:
        assert name in linprog_tpu.__all__
        assert name in linprog_tpu_torch.__all__
        assert getattr(linprog_tpu_torch, name) is not None
    assert sorted(linprog_tpu_torch.__all__) == linprog_tpu_torch.__all__
