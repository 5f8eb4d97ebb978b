"""linprog_tpu_torch's ``solve_batch_general`` against the reference's on
the same heterogeneous batches, with the host presolve off and on
(statuses equal, costs within 1e-5), and the structured acceptance suite:
``structured.default_suite()`` bit for bit, each instance through the
port's ``SimplexSolver`` within 1e-5 of HiGHS, and the suite padded into
one batch under dantzig and devex pricing.

The port runs ``kernels="cuda"`` on CPU tensors (kernel 1's plain
version) and ``"torch"``; the reference its default (``"xla"``).  The
two may pivot differently (kernel 1 takes ``opt_tol`` as it is, the
per-step paths scale it), so iteration counts are not compared.
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


from linprog_tpu import structured as jstructured  # noqa: E402
from linprog_tpu.batch import (  # noqa: E402
    solve_batch_general as jax_solve_batch_general,
)

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch import structured  # noqa: E402
from linprog_tpu_torch.batch import solve_batch_general  # noqa: E402
from tests.problems import PRIMAL_PROBLEMS  # noqa: E402

P0 = PRIMAL_PROBLEMS[0]
HETEROGENEOUS = [
    # the equality-form textbook problem
    {"c": P0.c, "A": P0.A, "b": P0.b},
    # inequality only: min -x1 - x2 s.t. x1 + x2 <= 4, x1 <= 3
    {"c": np.array([-1.0, -1.0]), "G": np.array([[1.0, 1.0], [1.0, 0.0]]),
     "h": np.array([4.0, 3.0])},
    # equality and inequality rows
    {"c": np.array([-1.0, -2.0, 0.0]), "A": np.array([[1.0, 1.0, 1.0]]),
     "b": np.array([4.0]), "G": np.array([[0.0, 1.0, 0.0]]),
     "h": np.array([2.0])},
    # infeasible: -x1 - x2 = 1, x >= 0
    {"c": np.zeros(2), "A": np.array([[-1.0, -1.0]]), "b": np.array([1.0])},
]


def presolve_batch():
    """The reference's presolve batch: a plain instance, one with an empty
    column and a singleton row, one the presolve finds infeasible and one
    it fixes completely."""
    rng = np.random.default_rng(8)
    problems = []
    G = rng.standard_normal((5, 7))
    x0 = rng.random(7)
    problems.append({"c": 0.2 + rng.random(7) - G.T @ rng.random(5),
                     "G": G, "h": G @ x0 + rng.random(5)})
    G2 = rng.standard_normal((4, 6))
    G2[:, 0] = 0.0
    G2[1, :] = 0.0
    G2[1, 3] = 1.0
    x0 = rng.random(6)
    h2 = G2 @ x0 + rng.random(4)
    c2 = 0.2 + rng.random(6) - G2.T @ rng.random(4)
    c2[0] = abs(c2[0])
    problems.append({"c": c2, "G": G2, "h": h2})
    problems.append({"c": np.ones(2), "A": np.array([[1.0, 0.0],
                                                     [1.0, 0.0]]),
                     "b": np.array([1.0, 2.0])})
    problems.append({"c": np.array([1.0, 2.0]),
                     "A": np.array([[2.0, 0.0], [0.0, 1.0]]),
                     "b": np.array([4.0, 3.0])})
    return problems


def same_batch(ref, port):
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert p.status == r.status and p.optimum == r.optimum
        assert p.basis is None and p.x.shape == r.x.shape
        if r.optimum:
            assert p.cost == pytest.approx(r.cost, rel=1e-5, abs=1e-5)
            np.testing.assert_allclose(p.x, r.x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernels", ["cuda", "torch"])
@pytest.mark.parametrize("presolve", [False, True])
def test_heterogeneous_batch_matches_reference(presolve, kernels):
    ref = jax_solve_batch_general(HETEROGENEOUS, 400, 400, presolve=presolve)
    port = solve_batch_general(HETEROGENEOUS, 400, 400,
                               lt.SolverConfig(kernels=kernels),
                               presolve=presolve, device="cpu")
    same_batch(ref, port)
    assert [p.status for p in port] == [st.OPTIMAL] * 3 + [
        st.PRIMAL_INFEASIBLE]
    assert port[1].cost == pytest.approx(-4.0, abs=1e-4)
    assert port[2].cost == pytest.approx(-6.0, abs=1e-4)
    assert port[2].x.shape == (3,)


@pytest.mark.parametrize("presolve", [False, True])
def test_presolve_batch_matches_reference(presolve):
    """Lanes the presolve decides never reach the device (infeasible:
    x NaN; fixed: zero iterations); the reduced lanes keep their optima."""
    problems = presolve_batch()
    if not presolve:  # the decided lanes are presolve's own
        problems = problems[:2]
    ref = jax_solve_batch_general(problems, 400, 400, presolve=presolve)
    port = solve_batch_general(problems, 400, 400, presolve=presolve,
                               device="cpu")
    same_batch(ref, port)
    assert port[0].optimum and port[1].optimum
    if presolve:
        assert port[2].status == st.PRIMAL_INFEASIBLE
        assert np.isnan(port[2].x).all() and not port[2].optimum
        assert port[3].optimum and port[3].iters == 0
        np.testing.assert_allclose(port[3].x, [2.0, 3.0])


def test_every_instance_decided_by_presolve():
    problems = presolve_batch()[2:]
    port = solve_batch_general(problems, presolve=True, device="cpu")
    ref = jax_solve_batch_general(problems, presolve=True)
    same_batch(ref, port)


def test_default_suite_bit_for_bit():
    suite, ref = structured.default_suite(), jstructured.default_suite()
    assert [p["name"] for p in suite] == [p["name"] for p in ref]
    for p, q in zip(suite, ref):
        for key in ("c", "A", "b", "G", "h", "lb", "ub"):
            if q[key] is None:
                assert p[key] is None
            else:
                assert p[key].dtype == q[key].dtype
                np.testing.assert_array_equal(p[key], q[key])


def highs_optimum(p):
    n = p["c"].shape[0]
    lb = np.zeros(n) if p["lb"] is None else p["lb"]
    ub = np.full(n, np.inf) if p["ub"] is None else p["ub"]
    ref = highs(p["c"], A_eq=p["A"], b_eq=p["b"], A_ub=p["G"], b_ub=p["h"],
                bounds=list(zip([None if np.isneginf(v) else v for v in lb],
                                [None if np.isposinf(v) else v for v in ub])),
                method="highs")
    assert ref.status == 0, p["name"]
    return ref.fun


SUITE = structured.default_suite()


@pytest.mark.parametrize("p", SUITE, ids=[p["name"] for p in SUITE])
def test_suite_instance_through_simplex_solver(p):
    """The reference suite's bar: the objective within 1e-5 relative of
    HiGHS (dantzig, a refactorization every 64 pivots)."""
    cfg = lt.SolverConfig(pricing="dantzig", refactor_every=64)
    res = lt.SimplexSolver(p["c"], A=p["A"], b=p["b"], G=p["G"], h=p["h"],
                           lb=p["lb"], ub=p["ub"], config=cfg,
                           device="cpu").solve(maxiters1=3000,
                                               maxiters2=3000)
    assert res.optimum, p["name"]
    fun = highs_optimum(p)
    assert abs(res.cost - fun) / max(1.0, abs(fun)) < 1e-5


def suite_as_standard_form():
    """Every suite instance in standard form with its bounds as rows (each
    instance's free variables and lower bounds taken out by
    ``SimplexSolver``'s constructor), and the solvers to map x back."""
    problems, solvers = [], []
    for p in SUITE:
        s = lt.SimplexSolver(p["c"], A=p["A"], b=p["b"], G=p["G"], h=p["h"],
                             lb=p["lb"], ub=p["ub"], device="cpu")
        c1, A1, b1 = lt.forms.bounds_to_rows(s.c, s.A, s.b, s.lb, s.ub)
        problems.append({"c": c1, "A": A1, "b": b1})
        solvers.append(s)
    return problems, solvers


@pytest.mark.parametrize("pricing", ["dantzig", "devex"])
def test_suite_as_one_batch(pricing):
    """The 15 instances padded into one batch (kernel 1's plain version):
    every lane OPTIMAL within 1e-5 of HiGHS once x is mapped back."""
    problems, solvers = suite_as_standard_form()
    cfg = lt.SolverConfig(pricing=pricing, refactor_every=64)
    res = solve_batch_general(problems, 3000, 3000, cfg, device="cpu")
    for p, s, r in zip(SUITE, solvers, res):
        assert r.optimum, p["name"]
        x = s._reconstruct_x(r.x[: s.n_aug])
        fun = highs_optimum(p)
        assert abs(float(p["c"] @ x) - fun) / max(1.0, abs(fun)) < 1e-5
