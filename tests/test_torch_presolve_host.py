"""linprog_tpu_torch's host presolve against the reference's: both are
NumPy, so ``presolve_problem`` must give the same reduced problem field by
field, exactly; ``Postsolve.expand`` the same vector; ``solve_with_presolve``
(the port's ``SimplexSolver`` on the CPU) the same outcome, x and cost
within 1e-5.
"""

import dataclasses

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


from linprog_tpu import presolve_host as jph  # noqa: E402

from linprog_tpu_torch import presolve_host as ph  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from tests.test_torch_api import same_outcome  # noqa: E402


def structured_case():
    """x0 fixed, x2 an empty column, a singleton G row, a singleton A row
    fixing x3 (the reference's reductions test)."""
    n = 6
    c = np.array([1.0, -2.0, 0.5, 1.0, -1.0, 2.0])
    A = np.zeros((2, n))
    A[0, [1, 4, 5]] = [1.0, 2.0, -1.0]
    A[1, 3] = 2.0
    b = np.array([3.0, 2.0])
    G = np.zeros((3, n))
    G[0, [1, 4]] = [1.0, 1.0]
    G[1, 4] = 1.0
    G[2, [1, 5]] = [-1.0, 1.0]
    h = np.array([2.5, 1.5, 4.0])
    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    lb[0] = ub[0] = 0.7
    ub[1] = 5.0
    return dict(c=c, A=A, b=b, G=G, h=h, lb=lb, ub=ub)


def random_case(seed):
    rng = np.random.default_rng(seed)
    m, n = 6, 9
    G = rng.standard_normal((m, n))
    x0 = rng.random(n)
    h = G @ x0 + rng.random(m)
    c = 0.2 + rng.random(n) - G.T @ rng.random(m)
    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    lb[0] = ub[0] = 0.3
    G[:, 1] = 0.0
    c[1] = abs(c[1])
    G[2, :] = 0.0
    G[2, 3] = 1.0
    h[2] = 0.8
    return dict(c=c, G=G, h=h, lb=lb, ub=ub)


CASES = {
    "structured": structured_case(),
    "random_4": random_case(4),
    "random_5": random_case(5),
    "inconsistent_bounds": dict(c=np.ones(3), lb=np.array([0.0, 2.0, 0.0]),
                                ub=np.ones(3)),
    "zero_row_nonzero_rhs": dict(c=np.ones(3), A=np.zeros((1, 3)),
                                 b=np.array([1.0])),
    "unbounded_empty_column": dict(c=np.array([-1.0, 1.0]),
                                   G=np.array([[0.0, 1.0]]),
                                   h=np.array([2.0])),
    "fully_determined": dict(c=np.array([1.0, 2.0]),
                             A=np.array([[2.0, 0.0], [0.0, 1.0]]),
                             b=np.array([4.0, 3.0])),
    "contradictory_singletons": dict(c=np.ones(2),
                                     A=np.array([[1.0, 0.0], [1.0, 0.0]]),
                                     b=np.array([1.0, 2.0])),
}


def assert_same_value(got, want, name):
    if want is None:
        assert got is None, name
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, name)
    else:
        assert got == want, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_presolve_problem_field_by_field(case):
    p = CASES[case]
    want = jph.presolve_problem(**p)
    got = ph.presolve_problem(**p)
    for field in dataclasses.fields(want):
        if field.name == "post":
            continue
        assert_same_value(getattr(got, field.name),
                          getattr(want, field.name), field.name)
    for field in dataclasses.fields(want.post):
        assert_same_value(getattr(got.post, field.name),
                          getattr(want.post, field.name), field.name)
    x_red = np.linspace(0.1, 1.0, got.post.keep_cols.size)
    np.testing.assert_array_equal(got.post.expand(x_red),
                                  want.post.expand(x_red))
    np.testing.assert_array_equal(got.post.expand(None),
                                  want.post.expand(None))


def test_presolve_verdicts():
    assert ph.presolve_problem(
        **CASES["inconsistent_bounds"]).post.status == st.PRIMAL_INFEASIBLE
    assert ph.presolve_problem(
        **CASES["unbounded_empty_column"]).post.status == st.PRIMAL_UNBOUNDED
    red = ph.presolve_problem(**CASES["structured"])
    assert red.post.status == st.RUNNING
    assert red.post.fixed_mask[[0, 2, 3]].all()
    assert red.G.shape[0] < 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_with_presolve_matches_reference(case):
    """The same outcome (a result, or the same exception class) and, on a
    result, x and cost within 1e-5 and HiGHS's optimum."""
    p = CASES[case]
    ref, port = same_outcome(
        lambda: jph.solve_with_presolve(**p),
        lambda: ph.solve_with_presolve(**p, device="cpu"))
    if isinstance(port, str):
        assert port in ("PrimalIsInfeasibleError", "PrimalIsUnboundedError")
        return
    assert port.status == ref.status and port.optimum == ref.optimum
    assert port.basis is None and port.y is None
    np.testing.assert_allclose(port.x, ref.x, rtol=1e-5, atol=1e-5)
    assert port.cost == pytest.approx(ref.cost, rel=1e-5, abs=1e-5)
    n = len(p["c"])
    lb = p.get("lb", np.zeros(n))
    ub = p.get("ub", np.full(n, np.inf))
    oracle = highs(p["c"], A_eq=p.get("A"), b_eq=p.get("b"),
                   A_ub=p.get("G"), b_ub=p.get("h"), method="highs",
                   bounds=[(lo, None if np.isinf(hi) else hi)
                           for lo, hi in zip(lb, ub)])
    assert oracle.status == 0
    assert port.cost == pytest.approx(oracle.fun, rel=1e-5, abs=1e-6)
    if case == "fully_determined":
        assert port.iters == 0
        np.testing.assert_allclose(port.x, [2.0, 3.0])
