"""linprog_tpu_torch's ``IPMSolver`` (the general-form interior-point
surface) against the reference's on the same numpy inputs; the port on
the CPU.  Statuses equal, the cost within 1e-4 at eps 1e-6 (float64), the
duals in the user's row space (equality, inequality, then upper-bound
rows), ``ValueError`` on a free variable, and a warm ``resolve`` of
perturbed data in fewer Newton steps than a cold solve.
"""

import jax
import numpy as np
import pytest
from scipy.optimize import linprog as highs


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Clear JAX's caches around a module that compiles many programs
    (same workaround as tests/test_solve_kernel.py)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


import linprog_tpu as jlt  # noqa: E402
from linprog_tpu.ipm import IPMConfig as JaxIPMConfig  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.generators import random_inequality_lps  # noqa: E402
from tests.test_torch_api import same_outcome  # noqa: E402

F64_EPS6 = dict(eps_rel=1e-6, dtype="float64")


def general_instance(m=12, n=16, m_eq=3, seed=0):
    """``random_inequality_lps``'s G and h, ``m_eq`` equality rows through
    its feasible point x0, finite upper bounds on a quarter of the
    variables and a nonzero lower bound on one (all holding at x0)."""
    c, G, h = random_inequality_lps(1, m, n, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(seed)
    rng.standard_normal(size=(1, m, n), dtype=np.float32)
    x0 = rng.random(size=(1, n), dtype=np.float32)[0].astype(np.float64)
    A = rng.standard_normal((m_eq, n))
    ub = np.full(n, np.inf)
    ub[: n // 4] = x0[: n // 4] + 0.5
    lb = np.zeros(n)
    lb[n - 1] = -0.25
    return dict(c=c[0], A=A, b=A @ x0, G=G[0], h=h[0], lb=lb, ub=ub)


def both(problem, jcfg=None, **kw):
    jcfg = jcfg or JaxIPMConfig()
    ref = jlt.IPMSolver(**problem, config=jcfg)
    port = lt.IPMSolver(**problem, config=lt.IPMConfig(**{
        k: getattr(jcfg, k) for k in ("eps_rel", "maxiters", "dtype")}),
        device="cpu")
    return ref, port


def highs_general(p):
    return highs(p["c"], A_eq=p["A"], b_eq=p["b"], A_ub=p["G"], b_ub=p["h"],
                 method="highs", bounds=[
                     (lo, None if np.isinf(hi) else hi)
                     for lo, hi in zip(p["lb"], p["ub"])])


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_matches_reference_float64(seed):
    p = general_instance(seed=seed)
    ref, port = both(p, JaxIPMConfig(**F64_EPS6))
    r_ref, r_port = ref.solve(), port.solve()
    assert r_port.status == r_ref.status == st.OPTIMAL
    assert abs(r_port.iters - r_ref.iters) <= 1
    oracle = highs_general(p)
    scale = max(1.0, abs(oracle.fun))
    assert abs(r_port.cost - r_ref.cost) <= 1e-4 * scale
    assert abs(r_port.cost - oracle.fun) <= 1e-4 * scale
    assert (r_port.x >= p["lb"] - 1e-5).all()
    assert (r_port.x <= p["ub"] + 1e-5).all()
    # duals in the user's rows: equality, inequality, upper-bound rows
    n_ub = int(np.isfinite(p["ub"]).sum())
    assert r_port.y.shape == (3 + 12 + n_ub,)
    np.testing.assert_allclose(r_port.y, r_ref.y, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(port.duals, r_port.y)
    np.testing.assert_allclose(r_port.y[:3], oracle.eqlin.marginals,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(r_port.y[3:15], oracle.ineqlin.marginals,
                               rtol=1e-3, atol=1e-3)


def test_solve_f32_matches_reference_status_and_cost():
    """f32 at the default eps (1e-3): the same status, the cost within the
    eps class of the reference's and of HiGHS."""
    p = general_instance(seed=2)
    ref, port = both(p)
    r_ref, r_port = ref.solve(), port.solve()
    assert r_port.status == r_ref.status == st.OPTIMAL
    fun = highs_general(p).fun
    assert abs(r_port.cost - r_ref.cost) <= 5e-3 * max(1.0, abs(fun))
    assert abs(r_port.cost - fun) <= 5e-3 * max(1.0, abs(fun))


def test_free_variable_and_empty_polyhedron_raise_value_error():
    p = general_instance()
    free = dict(p, lb=np.where(np.arange(16) == 2, -np.inf, 0.0))
    for pkg, kw in ((jlt, {}), (lt, dict(device="cpu"))):
        with pytest.raises(ValueError, match="free variables"):
            pkg.IPMSolver(**free, **kw)
        with pytest.raises(ValueError, match="misspecified"):
            pkg.IPMSolver(np.ones(3), **kw)


def test_infeasible_raises_as_reference():
    """x1 + x2 = -1 with x >= 0: the same exception class (the Farkas
    verdict) in both."""
    p = dict(c=np.array([1.0, 1.0]), A=np.array([[1.0, 1.0]]),
             b=np.array([-1.0]))
    ref_exc, port_exc = same_outcome(
        lambda: jlt.IPMSolver(**p).solve(),
        lambda: lt.IPMSolver(**p, device="cpu").solve())
    assert port_exc == "PrimalIsInfeasibleError"


def test_resolve_warm_in_fewer_newton_steps():
    """h scaled by 1 + 0.02 N(0, 1): the warm re-solve takes fewer Newton
    steps than a cold solve of the perturbed data, within 5e-3 of its
    cost, and agrees with the reference's warm re-solve."""
    p = general_instance(m=24, n=32, m_eq=4, seed=3)
    cfg = JaxIPMConfig(**F64_EPS6)
    ref, port = both(p, cfg)
    ref.solve()
    port.solve()
    h2 = p["h"] * (1.0 + 0.02 * np.random.default_rng(7).standard_normal(
        p["h"].shape))
    warm, warm_ref = port.resolve(h=h2), ref.resolve(h=h2)
    _, cold_port = both(dict(p, h=h2), cfg)
    cold = cold_port.solve()
    assert warm.status == warm_ref.status == cold.status == st.OPTIMAL
    assert warm.iters < cold.iters
    assert abs(warm.iters - warm_ref.iters) <= 1
    scale = max(1.0, abs(cold.cost))
    assert abs(warm.cost - cold.cost) <= 5e-3 * scale
    assert abs(warm.cost - warm_ref.cost) <= 1e-4 * scale
    # chained: the solver holds the perturbed problem now
    again = port.resolve(h=h2)
    assert again.status == st.OPTIMAL and again.iters <= warm.iters


def test_resolve_and_duals_need_a_solve():
    port = lt.IPMSolver(**general_instance(), device="cpu")
    with pytest.raises(AttributeError, match="solve"):
        port.resolve(h=np.ones(12))
    with pytest.raises(AttributeError, match="solve"):
        port.duals
