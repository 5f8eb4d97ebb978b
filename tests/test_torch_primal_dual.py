"""linprog_tpu_torch's primal-dual algorithm against the reference's on the
same numpy inputs; the port on the CPU.

The host loop (``PrimalDualAlgorithm``, ``np.isclose`` admissibility) and
the batched device loop (``solve_primal_dual_batch``, the bounding row
always added, admissibility tolerances from the config) are two routines
in the reference and in the port.  Each is held against its counterpart:
the host class x, cost, basis and outer iterations; the batch lane for
lane, status and counter equal, x, cost and y within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Clear JAX's caches around a module that compiles many programs
    (same workaround as tests/test_solve_kernel.py)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


import linprog_tpu as jlt  # noqa: E402
from linprog_tpu.primal_dual import (  # noqa: E402
    solve_primal_dual_batch as jax_pd_batch,
)

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import forms  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)
from linprog_tpu_torch.primal_dual import solve_primal_dual_batch  # noqa: E402
from tests.problems import PRIMAL_DUAL_PROBLEMS  # noqa: E402

TOL = 1e-5


@pytest.mark.parametrize("problem", PRIMAL_DUAL_PROBLEMS,
                         ids=lambda p: p.name)
def test_host_class_matches_reference(problem):
    ref = jlt.PrimalDualAlgorithm(problem.c, problem.A, problem.b).solve()
    port = lt.PrimalDualAlgorithm(problem.c, problem.A, problem.b,
                                  device="cpu").solve()
    assert port.optimum and ref.optimum
    assert port.status == ref.status and port.iters == ref.iters
    np.testing.assert_array_equal(port.basis, ref.basis)
    np.testing.assert_allclose(port.x, ref.x, rtol=TOL, atol=TOL)
    assert port.cost == pytest.approx(ref.cost, rel=TOL, abs=TOL)
    np.testing.assert_allclose(port.x, problem.optimal_bfs, atol=1e-4)


def test_host_class_infeasible_raises_as_reference():
    # -x1 - x2 = 1 with x >= 0 is infeasible
    args = (np.array([1.0, 1.0]), np.array([[-1.0, -1.0]]), np.array([1.0]))
    with pytest.raises(jlt.DualIsUnboundedError):
        jlt.PrimalDualAlgorithm(*args).solve()
    with pytest.raises(lt.DualIsUnboundedError):
        lt.PrimalDualAlgorithm(*args, device="cpu").solve()


def test_host_class_iteration_cap_as_reference():
    """One outer iteration is short of the negative-cost problem's
    optimum: ITER_LIMIT and the same x in both."""
    p = PRIMAL_DUAL_PROBLEMS[2]
    ref = jlt.PrimalDualAlgorithm(p.c, p.A, p.b).solve(maxiters1=1)
    port = lt.PrimalDualAlgorithm(p.c, p.A, p.b, device="cpu").solve(
        maxiters1=1)
    assert port.status == ref.status == st.ITER_LIMIT
    np.testing.assert_allclose(port.x, ref.x, rtol=TOL, atol=TOL)


def padded_textbook(tile=1, seed=None):
    """The three textbook problems padded as one batch
    (``m_pad`` = the most rows, ``n_pad`` = the most columns + ``m_pad``),
    tiled; with ``seed`` the costs of each lane are scaled by
    ``1 + 0.01 N(0, 1)``."""
    m_pad = max(p.A.shape[0] for p in PRIMAL_DUAL_PROBLEMS)
    n_pad = max(p.A.shape[1] for p in PRIMAL_DUAL_PROBLEMS) + m_pad
    cs, As, bs = [], [], []
    for p in PRIMAL_DUAL_PROBLEMS:
        c0, A0, b0 = forms.preprocess_problem(p.c, p.A, p.b)
        c1, A1, b1, _, _ = forms.pad_problem(c0, A0, b0, m_pad, n_pad)
        cs.append(c1)
        As.append(A1)
        bs.append(b1)
    c, A, b = (np.tile(np.stack(a), (tile,) + (1,) * a[0].ndim)
               for a in (cs, As, bs))
    if seed is not None:
        rng = np.random.default_rng(seed)
        c = (c * (1.0 + 0.01 * rng.standard_normal(c.shape))).astype(
            np.float32)
    return c, A, b


def random_standard(B, m, n, seed):
    """Standard-form lanes of ``random_inequality_lps`` with ``b >= 0``;
    half the lanes take a negative cost somewhere (the bounding row's
    dual start)."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    cs, A, b = to_standard_form_batch(c, G, h)
    return cs.astype(np.float32), A, b


def both_batches(c, A, b, maxiters1=100, maxiters2=100):
    ref = [np.asarray(a) for a in jax_pd_batch(
        jnp.asarray(c), jnp.asarray(A), jnp.asarray(b), maxiters1,
        maxiters2)]
    port = [t.numpy() for t in solve_primal_dual_batch(
        torch.tensor(c), torch.tensor(A), torch.tensor(b), maxiters1,
        maxiters2)]
    return ref, port


def residual(A, b, x):
    """``max|Ax - b|`` per lane, over the lane's scale."""
    r = np.abs(np.einsum("bmn,bn->bm", A, x) - b).max(axis=1)
    return r / np.maximum(np.abs(b).max(axis=1), 1.0)


def same_lanes(ref, port, A=None, b=None):
    """Lane for lane: status and counter equal, cost and y within 1e-5 of
    the lane's scale; x too, on every lane or (given ``A``, ``b``) on the
    lanes where the reference's x solves ``Ax = b`` to 1e-5.  Returns
    those lanes."""
    x_r, cost_r, it_r, st_r, y_r = ref
    x_p, cost_p, it_p, st_p, y_p = port
    np.testing.assert_array_equal(st_p, st_r)
    np.testing.assert_array_equal(it_p, it_r)

    def close(got, want):
        scale = np.maximum(np.abs(want).max(axis=1), 1.0)
        return np.abs(got - want).max(axis=1) <= TOL * scale

    assert close(cost_p[:, None], cost_r[:, None]).all()
    assert close(y_p, y_r).all()
    held = np.ones(x_r.shape[0], bool)
    if A is not None:
        held = residual(A, b, x_r) <= TOL
    assert close(x_p, x_r)[held].all()
    return held


@pytest.mark.parametrize("seed", [None, 3])
def test_batch_textbook_matches_reference(seed):
    """The padded textbook batch (tiled twice; with seed 3 the costs
    perturbed per lane): every lane OPTIMAL at its known optimum."""
    c, A, b = padded_textbook(tile=2, seed=seed)
    ref, port = both_batches(c, A, b)
    same_lanes(ref, port)
    assert (port[3] == st.OPTIMAL).all()
    if seed is None:
        for i, p in enumerate(PRIMAL_DUAL_PROBLEMS):
            np.testing.assert_allclose(port[0][i, :p.c.shape[0]],
                                       p.optimal_bfs, atol=1e-3)


@pytest.mark.parametrize("maxiters1", [100, 2])
def test_batch_random_lanes_match_reference(maxiters1):
    """Eight random standard-form lanes (m = 6, n = 14): the same statuses
    and outer counts (at a cap of 2, ITER_LIMIT lanes too), the same cost
    and y, and the same x on the lanes where the reference's x is
    feasible (see the next test for the others)."""
    c, A, b = random_standard(8, 6, 8, seed=4)
    ref, port = both_batches(c, A, b, maxiters1=maxiters1, maxiters2=200)
    held = same_lanes(ref, port, A, b)
    if maxiters1 == 2:  # stopped lanes sit mid-solve, off Ax = b
        assert (port[3] == st.ITER_LIMIT).any()
    else:
        assert held.sum() >= 5


def test_batch_cost_tolerance_follows_the_bounding_row_in_both():
    """A fault the port shares with the reference: the restricted primal
    counts as feasible while its artificial cost is at most
    ``feas_tol * max|b_x| * m``, and ``b_x`` holds the bounding row's
    ``n M`` (here ~5e8), so lanes stop OPTIMAL with artificials still
    basic.  Lanes 6 and 7 do so in both packages, x off ``Ax = b`` by
    ~1.7 and ~1.5 and the cost above HiGHS's (3.49 against 0.546, 0.0143
    against -0.897); on lane 5 the reference's x is off by 0.34 at the
    optimal cost, while the port's, whose dual on row 2 is exactly 0
    (the reference's 1.6e-7), admits that row's slack and is feasible."""
    from scipy.optimize import linprog as highs

    c, A, b = random_standard(8, 6, 8, seed=4)
    ref, port = both_batches(c, A, b, maxiters2=200)
    same_lanes(ref, port, A, b)
    assert (port[3] == st.OPTIMAL).all()
    oracle = np.array([highs(c[k], A_eq=A[k], b_eq=b[k], method="highs").fun
                       for k in range(8)])
    gap = np.abs(port[1] - oracle) / np.maximum(np.abs(oracle), 1.0)
    np.testing.assert_array_equal(gap > 1e-3, np.arange(8) >= 6)
    np.testing.assert_array_equal(residual(A, b, ref[0]) > 1e-3,
                                  np.arange(8) >= 5)
    np.testing.assert_array_equal(residual(A, b, port[0]) > 1e-3,
                                  np.arange(8) >= 6)


def test_batch_infeasible_lane_is_dual_unbounded():
    """An infeasible lane beside a feasible one: DUAL_UNBOUNDED there,
    OPTIMAL beside it, lane for lane as the reference."""
    c = np.array([[1.0, 1.0, 0.0], [1.0, 2.0, 0.0]], np.float32)
    A = np.array([[[-1.0, -1.0, 0.0]], [[1.0, 1.0, 1.0]]], np.float32)
    b = np.array([[1.0], [2.0]], np.float32)
    ref, port = both_batches(c, A, b, maxiters1=50, maxiters2=50)
    same_lanes(ref, port)
    np.testing.assert_array_equal(port[3], [st.DUAL_UNBOUNDED, st.OPTIMAL])
