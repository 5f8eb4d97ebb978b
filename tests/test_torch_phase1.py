"""linprog_tpu_torch's Phase I (``phase1_problem``, ``drive_out_artificials``,
``solve_phase1``) against the reference's on the same numpy inputs; the
port on the CPU.  Transportation problems carry one redundant balance row:
both packages must keep the same basis, drop the same row and return the
same reduced ``A`` and ``b``.  An infeasible problem raises
``PrimalIsInfeasibleError`` whose Farkas certificate satisfies
``y'A <= tol`` and ``y'b > 0``.
"""

import dataclasses

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


from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu import phase1 as jphase1  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.generators import transportation_lps as jtransport  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import engine, phase1  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from linprog_tpu_torch.generators import transportation_lps  # noqa: E402


def both_phase1(c, A, b, maxiters=300, jcfg=None):
    jcfg = jcfg or JaxSolverConfig()
    ref = jphase1.solve_phase1(c, A, b, maxiters=maxiters, cfg=jcfg)
    port = phase1.solve_phase1(
        c, A, b, maxiters=maxiters,
        cfg=config_from_reference(dataclasses.asdict(jcfg)), device="cpu")
    return ref, port


def same_phase1(ref, port):
    np.testing.assert_array_equal(port.basis, ref.basis)
    np.testing.assert_array_equal(port.dropped_rows, ref.dropped_rows)
    np.testing.assert_array_equal(port.A, np.asarray(ref.A))
    np.testing.assert_array_equal(port.b, np.asarray(ref.b))
    assert port.iters == ref.iters
    assert port.basis.dtype == np.int32


@pytest.mark.parametrize("shape,seed", [((3, 4), 0), ((4, 5), 1),
                                        ((5, 7), 2)])
def test_transportation_redundant_row_dropped_as_reference(shape, seed):
    """``transportation_lps`` (one redundant row): the same Phase-II
    basis, the same dropped row, the same reduced arrays."""
    c, A, b = transportation_lps(1, *shape, seed=seed)
    ref, port = both_phase1(c[0], A[0], b[0])
    same_phase1(ref, port)
    assert port.dropped_rows.size == 1
    assert port.A.shape == (sum(shape) - 1, shape[0] * shape[1])
    # a feasible start for Phase II: B x_B = b with x_B >= 0
    B = port.A[:, port.basis].astype(np.float64)
    assert (np.linalg.solve(B, port.b) >= -1e-5).all()


def test_transportation_generator_bit_for_bit():
    for args in ((2, 3, 4, 0), (4, 8, 8, 7), (1024, 32, 32, 0)):
        for got, want in zip(transportation_lps(*args), jtransport(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_float64_phase1_matches_reference():
    c, A, b = transportation_lps(1, 4, 6, seed=3, dtype=np.float64)
    ref, port = both_phase1(c[0], A[0], b[0],
                            jcfg=JaxSolverConfig(dtype="float64"))
    same_phase1(ref, port)
    assert port.A.dtype == np.float64


def test_drive_out_artificials_batched_matches_vmapped_reference():
    """Every lane of a batch of transportation problems, each with its own
    costs, from the terminal Phase-I state: the loop over basis positions
    with the batch explicit gives the reference's vmapped scan, lane for
    lane."""
    B = 4
    c, A, b = transportation_lps(B, 3, 5, seed=5)
    m, n = A.shape[1:]
    jcfg = JaxSolverConfig()
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    c1, A1, bj = jax.vmap(jphase1.phase1_problem)(c, A, b)
    jstate = jax.vmap(jengine.artificial_state, in_axes=(0, None))(bj, n)
    jstate = jax.vmap(jengine.run_jit, in_axes=(0, 0, 0, 0, None, None,
                                                None, None))(
        c1, A1, bj, jstate, jnp.ones(n + m, bool), 300, jcfg, "primal")
    start = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    ref = jax.vmap(jphase1.drive_out_artificials,
                   in_axes=(0, 0, 0, None, None))(A1, bj, jstate, n, jcfg)

    tc1, tA1, tb = phase1.phase1_problem(None, torch.tensor(A),
                                         torch.tensor(b))
    np.testing.assert_array_equal(tA1.numpy(), np.asarray(A1))
    np.testing.assert_array_equal(tc1.numpy(), np.asarray(c1))
    state = engine.SimplexState(**{k: torch.tensor(v)
                                   for k, v in start.items()})
    assert (state.basis >= n).any()  # artificials left to drive out
    out = phase1.drive_out_artificials(tA1, tb, state, n, cfg)
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_allclose(out.bfs.numpy(), np.asarray(ref.bfs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.inv_B.numpy(), np.asarray(ref.inv_B),
                               rtol=1e-5, atol=1e-5)


def test_infeasible_raises_with_farkas_certificate():
    """``x1 + x2 = 4, 2 x1 + 3 x2 - s = 18, x >= 0`` is infeasible:
    ``PrimalIsInfeasibleError`` in both packages, the certificates equal
    and a Farkas ray: ``y'A <= tol``, ``y'b > 0``."""
    c = np.array([-3.0, 4.0, 0.0, 0.0])
    A = np.array([[1.0, 1.0, 1.0, 0.0], [2.0, 3.0, 0.0, -1.0]])
    b = np.array([4.0, 18.0])
    c32, A32, b32 = lt.forms.preprocess_problem(c, A, b)
    with pytest.raises(lt.PrimalIsInfeasibleError) as port_err:
        phase1.solve_phase1(c32, A32, b32, device="cpu")
    with pytest.raises(Exception) as ref_err:
        jphase1.solve_phase1(c32, A32, b32)
    assert type(ref_err.value).__name__ == "PrimalIsInfeasibleError"
    y = port_err.value.certificate
    np.testing.assert_allclose(y, ref_err.value.certificate, rtol=1e-5,
                               atol=1e-6)
    assert (y @ A32 <= 1e-6).all()
    assert float(y @ b32) > 1e-3


def test_phase1_short_of_convergence_raises_value_error():
    c, A, b = transportation_lps(1, 4, 5, seed=1)
    for solve in (lambda: jphase1.solve_phase1(c[0], A[0], b[0], maxiters=2),
                  lambda: phase1.solve_phase1(c[0], A[0], b[0], maxiters=2,
                                              device="cpu")):
        with pytest.raises(ValueError, match="did not converge"):
            solve()
