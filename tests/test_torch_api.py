"""linprog_tpu_torch's standard-form solver classes (primal and dual, naive
and revised, bounded-variable) against the reference package's on the same
numpy inputs.  The port runs on the CPU (``device="cpu"``); the reference's
classes run its jitted per-lane engine.

Mirrors the reference's ``test_primal_solvers.py``, ``test_dual_solvers.py``,
the class half of ``test_bounded_solver.py`` and the API half of
``test_duals_and_guards.py``: the same basis after every ``solve(maxiters=1)``
(Bland's published path), the same exception class (by name, from each
package's ``status``), and x, cost and y within 1e-5 relative in f32 (1e-9
in float64).
"""

import dataclasses

import jax
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
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from tests.problems import (  # noqa: E402
    BLAND_PATH_PAPADIMITRIOU,
    DUAL_PROBLEMS,
    PRIMAL_PROBLEMS,
)

F32_TOL = 1e-5
F64_TOL = 1e-9
PRIMAL = ["PrimalNaiveSimplexSolver", "PrimalRevisedSimplexSolver"]
DUAL = ["DualNaiveSimplexSolver", "DualRevisedSimplexSolver"]


def port_cfg(jcfg):
    """The port's config for a reference config (``None`` stays None);
    ``dtype`` carries over."""
    if jcfg is None:
        return None
    return config_from_reference(dataclasses.asdict(jcfg))


def make_both(name, *args, config=None, **kw):
    """The class ``name`` of each package on the same arguments:
    ``(reference, port)``; ``config`` is a reference config."""
    ref = getattr(jlt, name)(*args, config=config, **kw)
    port = getattr(lt, name)(*args, config=port_cfg(config), device="cpu",
                             **kw)
    return ref, port


def outcome(fn):
    """``("ok", result)`` or ``("raises", exception class name)``."""
    try:
        return "ok", fn()
    except Exception as exc:  # noqa: BLE001 - the class is what is compared
        return "raises", type(exc).__name__


def same_outcome(ref_fn, port_fn):
    """Both calls return, or both raise an exception of the same name."""
    ref, port = outcome(ref_fn), outcome(port_fn)
    assert ref[0] == port[0], (ref, port)
    if ref[0] == "raises":
        assert ref[1] == port[1]
    return ref[1], port[1]


def rel_close(got, want, tol, name=""):
    """Within ``tol`` of ``max(1, max|want|)``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (name, err / scale)


def same_result(ref, port, tol=F32_TOL, basis=True):
    """x, cost, y within ``tol``; status, optimum, iterations and (where
    ``basis``) the basis equal."""
    assert port.status == int(ref.status)
    assert port.optimum == bool(ref.optimum)
    assert port.iters == int(ref.iters)
    if basis:
        np.testing.assert_array_equal(port.basis, np.asarray(ref.basis))
    rel_close(port.x, ref.x, tol, "x")
    rel_close(port.cost, ref.cost, tol, "cost")
    if ref.y is None:
        assert port.y is None
    else:
        rel_close(port.y, ref.y, tol, "y")


@pytest.mark.parametrize("problem", PRIMAL_PROBLEMS, ids=lambda p: p.name)
@pytest.mark.parametrize("name", PRIMAL)
def test_primal_known_optimum_matches_reference(problem, name):
    ref, port = make_both(name, problem.c, problem.A, problem.b,
                          problem.starting_basis)
    r_ref, r_port = ref.solve(), port.solve()
    same_result(r_ref, r_port)
    assert r_port.optimum
    np.testing.assert_array_equal(np.sort(r_port.basis),
                                  np.sort(problem.optimal_basis))
    rel_close(r_port.x[problem.optimal_basis], problem.optimal_bfs, F32_TOL)
    np.testing.assert_allclose(port.inv_basis_matrix, ref.inv_basis_matrix,
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(port.bfs, ref.bfs, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name", PRIMAL)
def test_bland_pivot_path_basis_for_basis(name):
    """Repeated ``solve(maxiters=1)`` walks the published Bland path in
    both packages, basis for basis, and then stays at the optimum."""
    p = BLAND_PATH_PAPADIMITRIOU
    ref, port = make_both(name, p.c, p.A, p.b, p.basis_seq[0])
    np.testing.assert_array_equal(port.basis, p.basis_seq[0])
    for expected in list(p.basis_seq[1:]) + [p.basis_seq[-1]]:
        r_ref, r_port = ref.solve(maxiters=1), port.solve(maxiters=1)
        np.testing.assert_array_equal(r_port.basis, expected)
        same_result(r_ref, r_port)
        assert port.counter == ref.counter == 1
    assert r_port.optimum


@pytest.mark.parametrize("problem", DUAL_PROBLEMS, ids=lambda p: p.name)
@pytest.mark.parametrize("name", DUAL)
def test_dual_known_optimum_matches_reference(problem, name):
    ref, port = make_both(name, problem.c, problem.A, problem.b,
                          problem.starting_basis)
    r_ref, r_port = ref.solve(), port.solve()
    same_result(r_ref, r_port)
    assert r_port.optimum
    rel_close(r_port.x[problem.optimal_basis], problem.optimal_bfs, F32_TOL)


@pytest.mark.parametrize("name,problem", [
    (name, PRIMAL_PROBLEMS[1]) for name in PRIMAL] + [
    (name, DUAL_PROBLEMS[1]) for name in DUAL],
    ids=lambda v: getattr(v, "name", v))
def test_float64_matches_reference_to_1e9(name, problem):
    """In float64 (``SolverConfig(dtype="float64")``, the reference under
    jax_enable_x64) x, cost and y agree to 1e-9, from a start feasible for
    the class's mode."""
    ref, port = make_both(name, problem.c, problem.A, problem.b,
                          problem.starting_basis,
                          config=JaxSolverConfig(dtype="float64"))
    assert port.A.dtype == torch.float64
    same_result(ref.solve(), port.solve(), tol=F64_TOL)


def _unbounded():
    # min -x1 s.t. x1 - x2 = 0: x1 grows without limit
    return (np.array([-1.0, 0.0]), np.array([[1.0, -1.0]]), np.array([0.0]),
            np.array([0]))


def _primal_infeasible_basis():
    # basis [2, 3] gives bfs = b with a negative entry
    return (np.array([1.0, 1.0, 0.0, 0.0]),
            np.array([[1.0, 2.0, 1.0, 0.0], [1.0, 0.0, 0.0, 1.0]]),
            np.array([-2.0, -1.0]), np.array([2, 3]))


def _dual_unbounded():
    # min x1 s.t. -x1 - x2 = 1, x >= 0: infeasible (lhs <= 0 < 1)
    return (np.array([1.0, 0.0]), np.array([[-1.0, -1.0]]), np.array([1.0]),
            np.array([1]))


def _dual_infeasible_basis():
    # the reduced cost of x2 is negative under basis [2, 3]
    return (np.array([-1.0, -1.0, 0.0, 0.0]),
            np.array([[1.0, 1.0, 1.0, 0.0], [1.0, 2.0, 0.0, 1.0]]),
            np.array([2.0, 3.0]), np.array([2, 3]))


def _singular():
    # rank 1: A[:, [0, 1]] is singular
    return (np.array([1.0, 1.0, 0.0]),
            np.array([[1.0, 1.0, 2.0], [2.0, 2.0, 4.0]]),
            np.array([1.0, 2.0]), np.array([0, 1]))


ERROR_CASES = {
    "primal_unbounded": (PRIMAL, _unbounded, "PrimalIsUnboundedError"),
    "primal_infeasible_basis": (PRIMAL, _primal_infeasible_basis,
                                "BasisIsPrimalInfeasibleError"),
    "dual_unbounded": (DUAL, _dual_unbounded, "DualIsUnboundedError"),
    "dual_infeasible_basis": (DUAL, _dual_infeasible_basis,
                              "BasisIsDualInfeasibleError"),
    "singular_primal": (PRIMAL, _singular, "ValueError"),
    "singular_dual": (DUAL, _singular, "ValueError"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_surface_matches_reference(case):
    """The same exception class at construction or at ``solve()``, in
    both packages, for every class of the case's mode."""
    names, build, expected = ERROR_CASES[case]
    c, A, b, basis = build()
    for name in names:
        def run(pkg, **kw):
            return getattr(pkg, name)(c, A, b, basis, **kw).solve()

        _, port_exc = same_outcome(lambda: run(jlt),
                                   lambda: run(lt, device="cpu"))
        assert port_exc == expected
        assert issubclass(getattr(st, expected, ValueError), Exception)


def test_singular_basis_message():
    c, A, b, basis = _singular()
    with pytest.raises(ValueError, match="singular"):
        lt.PrimalRevisedSimplexSolver(c, A, b, basis, device="cpu")


@pytest.mark.parametrize("name", ["PrimalRevisedSimplexSolver",
                                  "DualRevisedSimplexSolver"])
def test_devex_raises_the_same_value_error(name):
    """Devex has no per-lane implementation in either package: a class
    built with it raises ``ValueError`` naming devex at ``solve()``."""
    p = PRIMAL_PROBLEMS[1] if name.startswith("Primal") else DUAL_PROBLEMS[0]
    ref, port = make_both(name, p.c, p.A, p.b, p.starting_basis,
                          config=JaxSolverConfig(pricing="devex"))
    same_outcome(ref.solve, port.solve)
    with pytest.raises(ValueError, match="devex"):
        port.solve()


def test_iter_limit_soft_fail_and_resume():
    """``solve(maxiters=1)`` stops short without raising (optimum False,
    status RUNNING), and the next call resumes from the live state."""
    p = PRIMAL_PROBLEMS[0]
    ref, port = make_both("PrimalRevisedSimplexSolver", p.c, p.A, p.b,
                          p.starting_basis)
    r_ref, r_port = ref.solve(maxiters=1), port.solve(maxiters=1)
    assert not r_port.optimum and r_port.status == st.RUNNING
    same_result(r_ref, r_port)
    r_ref, r_port = ref.solve(maxiters=100), port.solve(maxiters=100)
    same_result(r_ref, r_port)
    assert r_port.optimum


@pytest.mark.parametrize("name", PRIMAL)
def test_explicit_pivot_matches_reference(name):
    """``pivot(leave, enter)`` gives the reference's basis, inverse and
    basic values; the state view carries them unbatched."""
    p = PRIMAL_PROBLEMS[0]
    ref, port = make_both(name, p.c, p.A, p.b, p.starting_basis)
    for leave, enter in ((0, 3), (1, 6)):
        ref.pivot(leave, enter)
        port.pivot(leave, enter)
        np.testing.assert_array_equal(port.basis, ref.basis)
        rel_close(port.inv_basis_matrix, ref.inv_basis_matrix, F32_TOL)
        rel_close(port.bfs, ref.bfs, F32_TOL)
    state = port.state
    assert state.basis.shape == (3,) and state.inv_B.shape == (3, 3)
    assert int(state.status) == st.RUNNING
    same_result(ref.solve(), port.solve())


def test_duals_give_strong_duality():
    """y at the optimum: b'y = c'x and y'A <= c, as the reference's."""
    p = PRIMAL_PROBLEMS[1]
    ref, port = make_both("PrimalRevisedSimplexSolver", p.c, p.A, p.b,
                          p.starting_basis)
    r_ref, r_port = ref.solve(), port.solve()
    same_result(r_ref, r_port)
    assert float(p.b @ r_port.y) == pytest.approx(r_port.cost, abs=1e-4)
    assert (r_port.y @ p.A <= p.c + 1e-4).all()


# --- the bounded-variable class ---------------------------------------------


def _bazaraa_ex_5_6():
    c = np.array([-2.0, -4.0, -1.0, 0.0, 0.0])
    b = np.array([10.0, 4.0])
    A = np.array([[2.0, 1.0, 1.0, 1.0, 0.0], [1.0, 1.0, -1.0, -0.0, 1.0]])
    lb = np.array([0.0, 0.0, 1.0, 0.0, 0.0])
    ub = np.array([4.0, 6.0, 4.0, np.inf, np.inf])
    return (c, A, b, lb, ub), dict(basis=np.array([3, 4]),
                                   lb_nonbasic_vars=np.array([0, 1, 2]),
                                   ub_nonbasic_vars=np.array([]))


def _m_box():
    # min -x1 s.t. x1 - x2 = 1, both unbounded above: the infinite bounds
    # are clamped to M (= 1 here), so x1 lands on M
    return ((np.array([-1.0, 0.0]), np.array([[1.0, -1.0]]), np.array([1.0]),
             np.zeros(2), np.full(2, np.inf)),
            dict(basis=np.array([0]), lb_nonbasic_vars=np.array([1]),
                 ub_nonbasic_vars=np.array([])))


def _bound_flip():
    # min -x1 s.t. x1 + x2 = 5, 0 <= x1 <= 2: x1 flips from lb to ub
    return ((np.array([-1.0, 0.0]), np.array([[1.0, 1.0]]), np.array([5.0]),
             np.zeros(2), np.array([2.0, np.inf])),
            dict(basis=np.array([1]), lb_nonbasic_vars=np.array([0]),
                 ub_nonbasic_vars=np.array([])))


BOUNDED_CASES = {
    "bazaraa_5_6": (_bazaraa_ex_5_6, [2 / 3, 6.0, 8 / 3, 0.0, 0.0]),
    "m_box": (_m_box, None),
    "bound_flip": (_bound_flip, [2.0, 3.0]),
}


@pytest.mark.parametrize("case", sorted(BOUNDED_CASES))
def test_bounded_class_matches_reference(case):
    build, x_known = BOUNDED_CASES[case]
    args, kw = build()
    ref, port = make_both("BoundedVariablePrimalSimplexSolver", *args, **kw)
    r_ref, r_port = ref.solve(), port.solve()
    same_result(r_ref, r_port)
    np.testing.assert_array_equal(port.var_state, np.asarray(ref.var_state))
    assert r_port.optimum
    if x_known is not None:
        rel_close(r_port.x, x_known, 1e-4)
    with pytest.raises(NotImplementedError):
        port.pivot(0, 1)


def test_bounded_class_resumes_after_iter_limit():
    args, kw = _bazaraa_ex_5_6()
    ref, port = make_both("BoundedVariablePrimalSimplexSolver", *args, **kw)
    r_ref, r_port = ref.solve(maxiters=1), port.solve(maxiters=1)
    assert not r_port.optimum
    same_result(r_ref, r_port)
    same_result(ref.solve(maxiters=100), port.solve(maxiters=100))


def test_phase_one_class_matches_reference():
    """``PhaseOneSimplexSolver`` leaves the same basis and the same
    (row-reduced) constraints."""
    from linprog_tpu_torch.generators import transportation_lps

    c, A, b = transportation_lps(1, 3, 4, seed=2)
    ref, port = make_both("PhaseOneSimplexSolver", c[0], A[0], b[0])
    ref.solve(maxiters=200)
    port.solve(maxiters=200)
    np.testing.assert_array_equal(port.basis, ref.basis)
    np.testing.assert_array_equal(port.A, np.asarray(ref.A))
    np.testing.assert_array_equal(port.b, np.asarray(ref.b))
    assert port.m == ref.m == 6
