"""linprog_tpu_torch's warm-started simplex entry points against the
reference's: ``solve_batch_from_basis`` and ``reoptimize_batch_new_rhs``.

Both packages get the same numpy instances and the same starting bases.
The reference runs ``kernels="pallas"`` (its whole-segment kernel in
interpret mode; primal and dual), the port ``kernels="cuda"`` on CPU
tensors (the kernel's plain version); one case holds the per-step loops
(``"xla"`` / ``"torch"``) too.  Bland's rule from a textbook start: the
same basis and iteration count per lane, exactly.  Right-hand-side
re-solves: the same status per lane, costs within 1e-5 relative, with and
without the dd polish; a perturbation that makes a lane infeasible reads
DUAL_UNBOUNDED; a singular starting basis gives NUMERICAL_ERROR in both.
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


from linprog_tpu.batch import reoptimize_batch_new_rhs as jax_reoptimize  # noqa: E402
from linprog_tpu.batch import solve_batch_from_basis as jax_from_basis  # noqa: E402
from linprog_tpu.batch import solve_batch_two_phase as jax_two_phase  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402

from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.batch import (  # noqa: E402
    batch_summary,
    reoptimize_batch_new_rhs,
    solve_batch_from_basis,
    solve_batch_two_phase,
)
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from linprog_tpu_torch.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)
from linprog_tpu_torch.ops import solve_kernel  # noqa: E402
from tests.problems import DUAL_PROBLEMS, PRIMAL_PROBLEMS  # noqa: E402


def _rel(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


def _cfg(jcfg):
    return config_from_reference(dataclasses.asdict(jcfg))


def _tile(p, B=4, scales=None):
    c = np.tile(p.c.astype(np.float32), (B, 1))
    A = np.tile(p.A.astype(np.float32), (B, 1, 1))
    b = np.tile(p.b.astype(np.float32), (B, 1))
    if scales is not None:
        b = b * np.asarray(scales, np.float32)[:, None]
    basis = np.tile(p.starting_basis, (B, 1)).astype(np.int32)
    return c, A, b, basis


@pytest.mark.parametrize("kernels", ["pallas", "xla"])
@pytest.mark.parametrize("problem", range(len(PRIMAL_PROBLEMS)))
def test_solve_batch_from_basis_bland_parity(problem, kernels):
    """Bland's rule from the textbook starting basis: the same basis, the
    same iteration count and status per lane, x within 1e-5."""
    p = PRIMAL_PROBLEMS[problem]
    c, A, b, basis = _tile(p)
    jcfg = JaxSolverConfig(kernels=kernels)
    ref = jax_from_basis(jnp.asarray(c), jnp.asarray(A), jnp.asarray(b),
                         jnp.asarray(basis), 100, jcfg)
    res = solve_batch_from_basis(torch.tensor(c), torch.tensor(A),
                                 torch.tensor(b), torch.tensor(basis), 100,
                                 _cfg(jcfg))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert (res.status == st.OPTIMAL).all()
    assert np.abs(res.x.numpy() - np.asarray(ref.x)).max() < 1e-5
    if p.optimal_basis is not None:
        assert set(res.basis[0].tolist()) == set(p.optimal_basis.tolist())
    assert batch_summary(res)["optimal"] == 4


@pytest.mark.parametrize("problem", range(len(DUAL_PROBLEMS)))
def test_solve_batch_from_basis_dual_mode(problem):
    """Dual mode from a dual-feasible textbook start, right-hand sides
    scaled per lane (reduced costs do not depend on b)."""
    c, A, b, basis = _tile(DUAL_PROBLEMS[problem], scales=[1.0, 2.0, 0.5, 1.5])
    jcfg = JaxSolverConfig(kernels="pallas")
    ref = jax_from_basis(jnp.asarray(c), jnp.asarray(A), jnp.asarray(b),
                         jnp.asarray(basis), 100, jcfg, mode="dual")
    res = solve_batch_from_basis(torch.tensor(c), torch.tensor(A),
                                 torch.tensor(b), torch.tensor(basis), 100,
                                 _cfg(jcfg), mode="dual")
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    assert (res.status == st.OPTIMAL).all()
    assert _rel(res.cost.numpy(), np.asarray(ref.cost)).max() < 1e-5


def _base_and_perturbed(B, m, n, seed, pseed, jcfg):
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    cs, As, bs = to_standard_form_batch(c, G, h)
    base = jax_two_phase(jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs),
                         300, 300, jcfg)
    assert (np.asarray(base.status) == st.OPTIMAL).all()
    basis = np.asarray(base.basis)
    assert (basis < cs.shape[1]).all(), "artificials in the basis"
    rng = np.random.default_rng(pseed)
    bs_new = bs * (1.0 + 0.05 * rng.standard_normal(bs.shape).astype(np.float32))
    return cs, As, bs, bs_new, basis


@pytest.mark.parametrize("polish", [0, 4])
def test_reoptimize_new_rhs_matches_reference(polish):
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig",
                           polish_pivots=polish)
    cs, As, bs, bs_new, basis = _base_and_perturbed(8, 12, 16, 13, 0, jcfg)
    ref = jax_reoptimize(jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs_new),
                         jnp.asarray(basis), 200, jcfg)
    t = [torch.tensor(a) for a in (cs, As, bs_new)]
    before = solve_kernel.launches
    warm = reoptimize_batch_new_rhs(*t, torch.tensor(basis), 200, _cfg(jcfg))
    assert solve_kernel.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(warm.status.numpy(), np.asarray(ref.status))
    assert (warm.status == st.OPTIMAL).all()
    assert _rel(warm.cost.numpy(), np.asarray(ref.cost)).max() < 1e-5
    np.testing.assert_array_equal(warm.iters.numpy(), np.asarray(ref.iters))
    assert warm.x.shape == cs.shape and warm.y.shape == bs.shape

    # fresh solves agree, at many more pivots
    fresh = solve_batch_two_phase(t[0], t[1], t[2], 300, 300, _cfg(jcfg))
    assert _rel(warm.cost.numpy(), fresh.cost.numpy()).max() < 2e-4
    assert warm.iters.double().mean() < 0.5 * fresh.iters.double().mean()
    for i in range(8):
        hi = scipy_linprog(cs[i], A_eq=As[i], b_eq=bs_new[i],
                           bounds=(0, None), method="highs")
        assert hi.status == 0
        tol = 2e-5 if polish else 2e-4
        assert abs(float(warm.cost[i]) - hi.fun) / max(1, abs(hi.fun)) < tol


def test_reoptimize_detects_new_infeasibility():
    """x1 + s = 1 with basis {s}; the new rhs -1 makes bfs = -1 with no
    negative entry in the row: DUAL_UNBOUNDED (primal infeasible), beside
    a lane that stays feasible."""
    c = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)
    A = np.array([[[1.0, 1.0]], [[1.0, 1.0]]], np.float32)
    basis = np.array([[1], [1]], np.int32)
    b_new = np.array([[-1.0], [2.0]], np.float32)
    for jcfg in (JaxSolverConfig(kernels="pallas"),
                 JaxSolverConfig(kernels="pallas", pricing="dantzig",
                                 polish_pivots=4)):
        ref = jax_reoptimize(jnp.asarray(c), jnp.asarray(A),
                             jnp.asarray(b_new), jnp.asarray(basis), 50, jcfg)
        res = reoptimize_batch_new_rhs(torch.tensor(c), torch.tensor(A),
                                       torch.tensor(b_new),
                                       torch.tensor(basis), 50, _cfg(jcfg))
        np.testing.assert_array_equal(res.status.numpy(),
                                      np.asarray(ref.status))
        assert res.status.tolist() == [st.DUAL_UNBOUNDED, st.OPTIMAL]
        assert float(res.cost[1]) == 0.0 and float(res.x[1, 1]) == 2.0


def test_reoptimize_from_a_singular_basis_is_a_status():
    """Lane 0 starts from two parallel columns.  Both packages report
    NUMERICAL_ERROR for it with non-finite x (the terminal solve is
    unguarded in the reference and the port follows it), no exception, and
    solve lane 1 as usual."""
    c = np.array([[1.0, 2.0, 0.0, 0.0]] * 2, np.float32)
    A = np.array([[[1.0, 2.0, 1.0, 0.0], [2.0, 4.0, 0.0, 1.0]]] * 2, np.float32)
    b = np.array([[1.0, 1.0]] * 2, np.float32)
    basis = np.array([[0, 1], [2, 3]], np.int32)
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig",
                           polish_pivots=4)
    ref = jax_reoptimize(jnp.asarray(c), jnp.asarray(A), jnp.asarray(b),
                         jnp.asarray(basis), 50, jcfg)
    res = reoptimize_batch_new_rhs(torch.tensor(c), torch.tensor(A),
                                   torch.tensor(b), torch.tensor(basis), 50,
                                   _cfg(jcfg))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert res.status.tolist() == [st.NUMERICAL_ERROR, st.OPTIMAL]
    assert not np.isfinite(res.x[0].numpy()).all()
    assert not np.isfinite(np.asarray(ref.x)[0]).all()
    assert np.isfinite(res.x[1].numpy()).all() and float(res.cost[1]) == 0.0
    sres = solve_batch_from_basis(torch.tensor(c), torch.tensor(A),
                                  torch.tensor(b), torch.tensor(basis), 50,
                                  _cfg(jcfg))
    assert sres.status.tolist() == [st.NUMERICAL_ERROR, st.OPTIMAL]
