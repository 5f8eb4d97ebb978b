"""linprog_tpu_torch's ``SimplexSolver`` (the general form: equality and
inequality rows, bounds, free variables, no starting basis) against the
reference package's on the same numpy inputs; the port on the CPU.

Mirrors the reference's ``test_general_solver.py``,
``test_free_variables.py``, ``test_diet_example.py`` and the duals test of
``test_duals_and_guards.py``: statuses and exception classes equal, x, cost
and the duals in the user's row space within 1e-5 relative in f32 (1e-9 in
float64), the diet LP at 12.081337630748749 within 1e-6.
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
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
from tests.problems import PRIMAL_PROBLEMS  # noqa: E402
from tests.test_torch_api import (  # noqa: E402
    F32_TOL,
    F64_TOL,
    port_cfg,
    rel_close,
    same_outcome,
)

DIET_COST = 12.081337630748749
DIET_X = np.array([0.0, 0.05359876, 0.44949877, 1.86516786, 0.5, 0.0])


def diet_problem():
    """The SAS diet LP of ``examples/diet.py``."""
    costs = np.array([2.0, 3.5, 8.0, 1.5, 11.0, 1.0])
    protein = np.array([4.0, 8.0, 7.0, 1.3, 8.0, 9.2])
    fat = np.array([1.0, 5.0, 9.0, 0.1, 7.0, 1.0])
    carbs = np.array([15.0, 11.7, 0.4, 22.6, 0.0, 17.0])
    calories = np.array([0.90, 12, 10.6, 9.7, 13, 18])
    G = np.vstack([-calories, protein, -carbs, -fat])
    h = np.array([-30.0, 10.0, -10.0, -8.0])
    lb = np.zeros(6)
    ub = np.full(6, np.inf)
    lb[4] = 0.5  # fish
    ub[1] = 1.0  # milk
    return dict(c=costs, G=G, h=h, lb=lb, ub=ub)


def solve_both(problem, config=None, maxiters=(100, 100), **kw):
    """``SimplexSolver(**problem).solve(*maxiters)`` in each package:
    ``(reference outcome, port outcome)``, each a result or the name of
    the exception raised (equal in both, or the test fails)."""
    def run(pkg, cfg, **extra):
        return pkg.SimplexSolver(**problem, config=cfg, **kw,
                                 **extra).solve(*maxiters)

    return same_outcome(lambda: run(jlt, config),
                        lambda: run(lt, port_cfg(config), device="cpu"))


def same_general(ref, port, tol=F32_TOL):
    assert port.status == int(ref.status) and port.optimum == ref.optimum
    assert port.iters == int(ref.iters)
    assert port.basis is None and ref.basis is None
    rel_close(port.x, ref.x, tol, "x")
    rel_close(port.cost, ref.cost, tol, "cost")
    rel_close(port.y, ref.y, tol, "y")


@pytest.mark.parametrize("bounds_mode", ["native", "rows"])
def test_diet_cost_to_1e6_relative(bounds_mode):
    ref, port = solve_both(diet_problem(), bounds_mode=bounds_mode)
    same_general(ref, port)
    assert port.optimum
    assert abs(port.cost - DIET_COST) / DIET_COST < 1e-6
    np.testing.assert_allclose(port.x, DIET_X, atol=1e-4)


def _arr(*rows):
    return np.array(rows, dtype=np.float64)


GENERAL_CASES = {
    **{f"textbook_{p.name}": dict(c=p.c, A=p.A, b=p.b)
       for p in PRIMAL_PROBLEMS},
    # row 3 = row 1 + row 2: Phase I drops it; x = (2, 2, 2, 0)
    "redundant_rows": dict(
        c=_arr(-1.0, 2.0, -3.0, 0.0),
        A=_arr([1.0, 1.0, 1.0, 0.0], [-1.0, 1.0, 2.0, 0.0],
               [0.0, 2.0, 3.0, 0.0], [0.0, 0.0, 1.0, 1.0]),
        b=_arr(6.0, 4.0, 10.0, 2.0)),
    "inequality_only": dict(c=_arr(-1.0, -1.0),
                            G=_arr([1.0, 1.0], [1.0, 0.0]), h=_arr(4.0, 3.0)),
    "equality_and_inequality": dict(
        c=_arr(-1.0, -2.0, 0.0), A=_arr([1.0, 1.0, 1.0]), b=_arr(4.0),
        G=_arr([0.0, 1.0, 0.0]), h=_arr(2.0)),
    "bounds": dict(c=_arr(-1.0, 0.0), A=_arr([1.0, 1.0]), b=_arr(3.0),
                   lb=_arr(0.5, 0.0), ub=_arr(2.0, np.inf)),
    "one_by_one": dict(c=_arr(2.0), A=_arr([1.0]), b=_arr(3.0)),
    "zero_objective": dict(c=np.zeros(3), G=_arr([1.0, 1.0, 1.0]),
                           h=_arr(5.0)),
    "already_optimal": dict(c=_arr(1.0, 1.0), G=_arr([1.0, 1.0]),
                            h=_arr(4.0)),
    "negative_lb": dict(c=_arr(1.0, 0.0), G=_arr([1.0, 1.0]), h=_arr(1.0),
                        lb=_arr(-3.0, 0.0), ub=_arr(np.inf, np.inf)),
    "negative_lb_finite_ub": dict(c=_arr(-1.0, -1.0), G=_arr([1.0, 1.0]),
                                  h=_arr(2.0), lb=_arr(-1.0, -0.5),
                                  ub=_arr(1.5, 3.0)),
    "negative_lb_equality": dict(c=_arr(1.0, 0.0), A=_arr([1.0, 1.0]),
                                 b=_arr(0.0), lb=_arr(-2.0, 0.0),
                                 ub=_arr(np.inf, 2.0)),
    "tiny_positive_lb": dict(c=_arr(1.0), G=_arr([1.0]), h=_arr(5.0),
                             lb=_arr(1e-3)),
    # free variables: split (doubly free), substituted (finite ub)
    "free_split": dict(c=_arr(1.0, 2.0), A=_arr([1.0, 1.0]), b=_arr(1.0),
                       lb=_arr(-np.inf, 0.0)),
    "free_goes_negative": dict(c=_arr(1.0, 0.0), A=_arr([1.0, -1.0]),
                               b=_arr(-3.0), lb=_arr(-np.inf, 0.0),
                               ub=_arr(np.inf, 1.0)),
    "free_below_finite_above": dict(c=_arr(-1.0, 0.0), G=_arr([1.0, 1.0]),
                                    h=_arr(5.0), lb=_arr(-np.inf, 0.0),
                                    ub=_arr(2.0, np.inf)),
    # errors: Phase I infeasible; the native engine's infeasible and
    # unbounded lanes
    "infeasible": dict(c=_arr(-3.0, 4.0, 0.0, 0.0),
                       A=_arr([1.0, 1.0, 1.0, 0.0], [2.0, 3.0, 0.0, -1.0]),
                       b=_arr(4.0, 18.0)),
    "native_infeasible": dict(c=_arr(1.0, 1.0), A=_arr([1.0, 1.0]),
                              b=_arr(10.0), ub=_arr(2.0, 2.0)),
    "native_unbounded": dict(c=_arr(0.0, -1.0), G=_arr([1.0, 0.0]),
                             h=_arr(1.0), ub=_arr(0.5, np.inf)),
}
KNOWN = {"redundant_rows": (-4.0, [2.0, 2.0, 2.0, 0.0]),
         "equality_and_inequality": (-6.0, [2.0, 2.0, 0.0]),
         "negative_lb_equality": (-2.0, [-2.0, 2.0]),
         "free_split": (1.0, [1.0, 0.0])}


def _has_finite_ub(case):
    ub = GENERAL_CASES[case].get("ub")
    return ub is not None and np.isfinite(ub).any()


# without a finite upper bound both modes run the same rows path
MODE_CASES = [(case, "native") for case in sorted(GENERAL_CASES)] + [
    (case, "rows") for case in sorted(GENERAL_CASES) if _has_finite_ub(case)]


@pytest.mark.parametrize("case,bounds_mode", MODE_CASES)
def test_general_form_matches_reference(case, bounds_mode):
    """Each case (and with finite upper bounds, each bounds mode): the same
    outcome (a result, or the same exception class), and x, cost and y in
    the user's rows within 1e-5; known optima where the reference's tests
    state them."""
    ref, port = solve_both(GENERAL_CASES[case], bounds_mode=bounds_mode)
    if isinstance(port, str):
        assert port in ("PrimalIsInfeasibleError", "PrimalIsUnboundedError")
        return
    same_general(ref, port)
    assert port.optimum
    if case in KNOWN:
        cost, x = KNOWN[case]
        assert port.cost == pytest.approx(cost, abs=1e-5)
        np.testing.assert_allclose(port.x, x, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_free_variables_match_reference_and_highs(seed):
    """The reference's random free-variable instances: one doubly free
    column on even seeds, one free below a finite upper bound."""
    rng = np.random.default_rng(seed)
    m, n = 6, 8
    G = rng.normal(size=(m, n))
    h = G @ rng.uniform(0, 1, n) + rng.uniform(0.5, 1.5, m)
    c = rng.normal(size=n)
    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    lb[1] = -np.inf
    ub[1] = rng.uniform(0.5, 2.0)
    ub[2:] = rng.uniform(1.0, 3.0, n - 2)
    ub[0] = rng.uniform(1.0, 3.0)
    lb[0] = -np.inf if seed % 2 == 0 else -rng.uniform(1.0, 3.0)
    problem = dict(c=c, G=G, h=h, lb=lb, ub=ub)
    ref, port = solve_both(problem, maxiters=(300, 300))
    same_general(ref, port)
    oracle = highs(c, A_ub=G, b_ub=h, method="highs", bounds=[
        (None if np.isneginf(lo) else lo, None if np.isposinf(hi) else hi)
        for lo, hi in zip(lb, ub)])
    assert oracle.status == 0 and port.optimum
    assert port.cost == pytest.approx(oracle.fun, abs=2e-3)


def redundant_flipped(seed):
    """Dyadic data (exact in f32): two equality rows and their sum (a
    redundant row), row 0 with a negative right-hand side, five
    inequality rows, finite upper bounds on every third variable; feasible
    at ``x0``."""
    rng = np.random.default_rng(seed)
    n, mG = 8, 5
    G = rng.integers(-8, 9, (mG, n)) / 4
    A = rng.integers(-8, 9, (2, n)) / 4
    x0 = rng.integers(1, 8, n) / 8
    A = np.vstack([A, A[0] + A[1]])
    b = A @ x0
    if b[0] > 0:
        A[0], b[0] = -A[0], -b[0]
    h = G @ x0 + rng.integers(1, 8, mG) / 8
    c = rng.integers(1, 8, n) / 4 - G.T @ (rng.integers(0, 4, mG) / 4)
    ub = np.where(np.arange(n) % 3 == 0, x0 + 0.5, np.inf)
    return dict(c=c, A=A, b=b, G=G, h=h, ub=ub)


def _highs_general(p):
    return highs(p["c"], A_eq=p["A"], b_eq=p["b"], A_ub=p["G"], b_ub=p["h"],
                 method="highs",
                 bounds=[(0, None if np.isinf(u) else u) for u in p["ub"]])


def same_up_to_redundancy(ref, port, p, tol):
    """Results of an instance with dependent equality rows: the rows whose
    artificial Phase I drops (and so the duals' split over the dependent
    rows) may differ where an exact ratio tie is broken by rounding.  x,
    cost and status are equal within ``tol``; so are what is unique of the
    duals: ``A'y_eq``, ``b'y_eq`` and the inequality duals."""
    m_eq = p["A"].shape[0]
    assert port.status == int(ref.status) and port.optimum == ref.optimum
    rel_close(port.x, ref.x, tol, "x")
    rel_close(port.cost, ref.cost, tol, "cost")
    ry, py = np.asarray(ref.y), port.y
    rel_close(p["A"].T @ py[:m_eq], p["A"].T @ ry[:m_eq], tol, "A'y")
    rel_close(p["b"] @ py[:m_eq], p["b"] @ ry[:m_eq], tol, "b'y")
    rel_close(py[m_eq:], ry[m_eq:], tol, "y_ineq")
    for y in (ry, py):  # the dropped row's dual is zero
        assert (y[:m_eq] == 0.0).sum() >= 1


@pytest.mark.parametrize("seed", [0, 3])
def test_duals_through_flip_dropped_row_and_bound_rows(seed):
    """``bounds_mode="rows"`` in float64 with a sign-flipped equality row,
    a redundant equality row (Phase I drops one of the three) and bound
    rows: the duals come back in the user's rows and agree with the
    reference's to 1e-9 where they are unique; the same problem with row
    0 negated (no flip) gives the same solve with y[0] negated."""
    p = redundant_flipped(seed)
    cfg = JaxSolverConfig(dtype="float64")
    ref, port = solve_both(p, config=cfg, maxiters=(400, 400),
                           bounds_mode="rows")
    same_up_to_redundancy(ref, port, p, F64_TOL)
    assert p["b"][0] < 0 and port.y.shape == (3 + 5,)
    oracle = _highs_general(p)
    assert oracle.status == 0
    assert port.cost == pytest.approx(oracle.fun, rel=1e-9, abs=1e-9)

    q = dict(p, A=p["A"].copy(), b=p["b"].copy())
    q["A"][0], q["b"][0] = -q["A"][0], -q["b"][0]
    unflipped = lt.SimplexSolver(**q, bounds_mode="rows", device="cpu",
                                 config=port_cfg(cfg)).solve(400, 400)
    np.testing.assert_array_equal(unflipped.y[1:], port.y[1:])
    assert unflipped.y[0] == -port.y[0]
    np.testing.assert_array_equal(unflipped.x, port.x)


def test_f32_rows_mode_redundant_row_is_refused_by_both():
    """The same instance (seed 3) in f32 with the bounds as rows: the
    f32 rounding leaves Phase I's drive-out a pivot on noise in a
    dependent row, and both packages refuse the Phase-II start (the
    reference with ``BasisIsPrimalInfeasibleError``, its LU finite but
    huge; the port with ``ValueError``, LAPACK's LU exactly singular).
    Native bounds solve it in f32 in both, at HiGHS's optimum."""
    p = redundant_flipped(3)

    def rows(pkg, **kw):
        return pkg.SimplexSolver(**p, bounds_mode="rows",
                                 **kw).solve(400, 400)

    with pytest.raises(jlt.BasisIsPrimalInfeasibleError):
        rows(jlt)
    with pytest.raises(ValueError, match="singular"):
        rows(lt, device="cpu")
    ref, port = solve_both(p, maxiters=(400, 400))
    assert port.status == int(ref.status) == lt.status.OPTIMAL
    rel_close(port.x, ref.x, F32_TOL, "x")
    rel_close(port.cost, ref.cost, F32_TOL, "cost")
    assert port.cost == pytest.approx(_highs_general(p).fun, rel=1e-5)


def test_general_duals_match_highs_marginals():
    """Equality rows (one sign-flipped) and inequality rows, native mode:
    y in the user's rows equals the reference's and HiGHS's marginals."""
    rng = np.random.default_rng(13)
    n, mA, mG = 8, 2, 5
    G = rng.standard_normal((mG, n))
    A = rng.standard_normal((mA, n))
    x0 = rng.random(n)
    b = A @ x0
    b[0] = -b[0]
    A[0] = -A[0]
    h = G @ x0 + rng.random(mG)
    c = 0.2 + rng.random(n) - G.T @ rng.random(mG)
    ref, port = solve_both(dict(c=c, A=A, b=b, G=G, h=h), maxiters=(400, 400))
    same_general(ref, port)
    oracle = highs(c, A_eq=A, b_eq=b, A_ub=G, b_ub=h, bounds=(0, None),
                   method="highs")
    np.testing.assert_allclose(port.y[:mA], oracle.eqlin.marginals,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.y[mA:], oracle.ineqlin.marginals,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bounds_mode", ["native", "rows"])
def test_float64_general_form_to_1e9(bounds_mode):
    """The diet LP in float64 in both packages: x, cost, y to 1e-9 (the
    published cost, an f32 result, within 1e-6)."""
    ref, port = solve_both(diet_problem(), bounds_mode=bounds_mode,
                           config=JaxSolverConfig(dtype="float64"))
    same_general(ref, port, tol=F64_TOL)
    assert abs(port.cost - DIET_COST) / DIET_COST < 1e-6


def test_native_mode_matches_rows_mode_and_highs():
    """Random boxes around a feasible point (the first trial of the
    reference's native-against-rows test): both modes agree with the
    reference, with each other and with HiGHS."""
    rng = np.random.default_rng(11)
    m, n = 12, 16
    G = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    h = G @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    lb = np.where(rng.random(n) < 0.4, -np.abs(rng.normal(size=n)), 0.0)
    ub = np.where(rng.random(n) < 0.6,
                  x0 + np.abs(rng.normal(size=n)) + 0.1, np.inf)
    problem = dict(c=c, G=G, h=h, lb=lb, ub=ub)
    native = solve_both(problem, maxiters=(500, 500))
    rows = solve_both(problem, maxiters=(500, 500), bounds_mode="rows")
    for ref, port in (native, rows):
        same_general(ref, port)
    oracle = highs(c, A_ub=G, b_ub=h, method="highs", bounds=list(
        zip(lb, [u if np.isfinite(u) else None for u in ub])))
    assert native[1].cost == pytest.approx(oracle.fun, rel=2e-4,
                                           abs=2e-4)
    assert native[1].cost == pytest.approx(rows[1].cost, rel=2e-4,
                                           abs=2e-4)
    assert (native[1].x >= lb - 1e-4).all()
    assert (native[1].x <= ub + 1e-4).all()


def test_unknown_bounds_mode_raises():
    with pytest.raises(ValueError, match="bounds_mode"):
        lt.SimplexSolver(np.ones(2), G=np.ones((1, 2)), h=np.ones(1),
                         bounds_mode="box", device="cpu")
