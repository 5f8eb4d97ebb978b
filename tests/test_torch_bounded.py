"""linprog_tpu_torch's bounded-variable batch path against the reference
package (``kernels="pallas"``: its bounded kernel in interpret mode) on the
same numpy instances, and against HiGHS."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog as highs


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Clear JAX's caches around a module that compiles many interpret-mode
    Pallas programs (same workaround as tests/test_solve_kernel.py)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


from linprog_tpu.batch import solve_batch_bounded as jax_solve_batch_bounded  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.refine import polish_bounded_batch as jax_polish_bounded_batch  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import bounded as bnd  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import (  # noqa: E402
    bounded_state_from_numpy,
    bounded_state_to_numpy,
    config_from_reference,
)
from linprog_tpu_torch.generators import device_bounded_lps  # noqa: E402
from linprog_tpu_torch.refine import polish_bounded_batch  # noqa: E402

F32 = np.float32


def bounded_lps(B, m, n, seed, ub_hi=2.0):
    """The construction of ``device_bounded_lps`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, m, n)).astype(F32)
    x0 = rng.random((B, n)).astype(F32)
    slack = rng.random((B, m)).astype(F32)
    h = np.einsum("bmn,bn->bm", G, x0) + slack
    Gf = np.where((h < 0)[:, :, None], -G, G)
    A = np.concatenate([Gf, np.broadcast_to(np.eye(m, dtype=F32), (B, m, m))],
                       axis=2)
    c = np.concatenate([rng.uniform(-1.0, 1.0, (B, n)).astype(F32),
                        np.zeros((B, m), F32)], axis=1)
    lb = np.zeros((B, n + m), F32)
    ub = np.concatenate([rng.uniform(0.5, ub_hi, (B, n)).astype(F32),
                         np.full((B, m), np.inf, F32)], axis=1)
    return c, A, np.abs(h).astype(F32), lb, ub


def slack_start(B, m, n):
    basis = np.broadcast_to(np.arange(n, n + m, dtype=np.int32), (B, m)).copy()
    vs = np.concatenate([np.zeros((B, n), np.int8),
                         np.full((B, m), 2, np.int8)], axis=1)
    return basis, vs


def solve_both(prob, basis, vs, maxiters, jcfg):
    ref = jax_solve_batch_bounded(*(jnp.asarray(a) for a in prob),
                                  jnp.asarray(basis), jnp.asarray(vs),
                                  maxiters, jcfg)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    out = lt.solve_batch_bounded(*(torch.tensor(a) for a in prob),
                                 torch.tensor(basis), torch.tensor(vs),
                                 maxiters, cfg)
    return ref, out


def highs_costs(prob):
    c, A, b, lb, ub = prob
    costs = []
    for i in range(c.shape[0]):
        bounds = [(float(lo), float(u) if np.isfinite(u) else None)
                  for lo, u in zip(lb[i], ub[i])]
        ref = highs(c[i].astype(np.float64), A_eq=A[i].astype(np.float64),
                    b_eq=b[i].astype(np.float64), bounds=bounds,
                    method="highs")
        assert ref.status == 0
        costs.append(ref.fun)
    return np.asarray(costs)


@pytest.mark.parametrize("polish", [0, 8], ids=["nopolish", "polish8"])
@pytest.mark.parametrize("B,m,n,seed", [(8, 10, 12, 3), (4, 24, 24, 7)],
                         ids=["m10", "m24"])
def test_solve_batch_bounded_matches_reference_and_highs(B, m, n, seed,
                                                         polish):
    prob = bounded_lps(B, m, n, seed)
    basis, vs = slack_start(B, m, n)
    jcfg = JaxSolverConfig(kernels="pallas", refactor_every=16,
                           polish_pivots=polish)
    ref, out = solve_both(prob, basis, vs, 500, jcfg)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    assert (out.status.numpy() == st.OPTIMAL).all()
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    # x within 2e-4 (the reference's own bound between its two engines)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=2e-4,
                               rtol=2e-4)
    cost, rcost = out.cost.numpy(), np.asarray(ref.cost)
    # costs within 1e-5 relative of each other and of HiGHS (f32 class)
    assert (np.abs(cost - rcost) <= 1e-5 * np.maximum(1.0, np.abs(rcost))).all()
    want = highs_costs(prob)
    gap = np.abs(cost - want) / np.maximum(1.0, np.abs(want))
    assert (gap < 1e-5).all(), gap
    c, A, b, lb, ub = prob
    x = out.x.numpy()
    assert (x >= lb - 1e-5).all() and (x <= ub + 1e-5).all()
    assert np.abs(np.einsum("bmn,bn->bm", A, x) - b).max() < 1e-4


def test_solve_batch_bounded_packed_select_matches_reference():
    prob = bounded_lps(8, 10, 12, seed=4)
    basis, vs = slack_start(8, 10, 12)
    jcfg = JaxSolverConfig(kernels="pallas", refactor_every=16,
                           packed_select=True, pricing="dantzig", unroll=2)
    ref, out = solve_both(prob, basis, vs, 500, jcfg)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-5, atol=1e-5)


def test_solve_batch_bounded_iteration_cap_gives_iter_limit():
    prob = bounded_lps(8, 10, 12, seed=3)
    basis, vs = slack_start(8, 10, 12)
    jcfg = JaxSolverConfig(kernels="pallas", refactor_every=2)
    ref, out = solve_both(prob, basis, vs, 3, jcfg)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    assert (out.status.numpy() == st.ITER_LIMIT).all()
    assert (out.iters.numpy() == 3).all()
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))


def test_solve_batch_bounded_bazaraa_example_5_6():
    """Textbook ground truth through the batch entry."""
    prob = (np.array([[-2.0, -4.0, -1.0, 0.0, 0.0]], F32),
            np.array([[[2.0, 1.0, 1.0, 1.0, 0.0],
                       [1.0, 1.0, -1.0, 0.0, 1.0]]], F32),
            np.array([[10.0, 4.0]], F32),
            np.array([[0.0, 0.0, 1.0, 0.0, 0.0]], F32),
            np.array([[4.0, 6.0, 4.0, 1e6, 1e6]], F32))
    jcfg = JaxSolverConfig(kernels="pallas", refactor_every=16)
    ref, out = solve_both(prob, np.array([[3, 4]], np.int32),
                          np.array([[0, 0, 0, 2, 2]], np.int8), 100, jcfg)
    assert out.status.tolist() == [st.OPTIMAL]
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_allclose(out.x.numpy()[0],
                               [2 / 3, 6.0, 8 / 3, 0.0, 0.0], atol=1e-3)


def test_polish_bounded_batch_matches_reference_from_a_perturbed_basis():
    """From a basis a few pivots short of the optimum (the solve capped
    early), the dd polish takes the same cleanup steps in both packages."""
    B, m, n = 6, 10, 12
    prob = bounded_lps(B, m, n, seed=11)
    c, A, b, lb, ub = (torch.tensor(a) for a in prob)
    basis, vs = slack_start(B, m, n)
    cfg = lt.SolverConfig(refactor_every=16)
    full = lt.solve_batch_bounded(c, A, b, lb, ub, torch.tensor(basis),
                                  torch.tensor(vs), 500, cfg)
    state = bnd.make_bounded_state(A, b, lb, ub, torch.tensor(basis),
                                   torch.tensor(vs))
    cut = int(full.iters.min()) - 2
    assert cut >= 1
    state = bnd.run_bounded_batched(c, A, b, lb, ub, state, cut, cfg)
    s = bounded_state_to_numpy(state)
    act = np.ones(B, bool)
    ref = jax_polish_bounded_batch(
        *(jnp.asarray(a) for a in prob), jnp.asarray(s["basis"]),
        jnp.asarray(s["var_state"]), jnp.asarray(act), max_pivots=16)
    out = polish_bounded_batch(c, A, b, lb, ub, state.basis, state.var_state,
                               torch.tensor(act), max_pivots=16)
    rbasis, rvs, rxB, ry, _ = (np.asarray(a) for a in ref)
    assert (rbasis != s["basis"]).any() or (rvs != s["var_state"]).any()
    np.testing.assert_array_equal(out[0].numpy(), rbasis)
    np.testing.assert_array_equal(out[1].numpy(), rvs)
    # dd-refined values: 1e-5 absolute at these magnitudes (O(1))
    np.testing.assert_allclose(out[2].numpy(), rxB, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[3].numpy(), ry, atol=1e-5, rtol=1e-5)


def test_bounded_state_round_trip_and_helpers():
    B, m, n = 3, 4, 5
    prob = bounded_lps(B, m, n, seed=1)
    c, A, b, lb, ub = (torch.tensor(a) for a in prob)
    basis, vs = slack_start(B, m, n)
    vs[:, 0] = 1  # a structural column at its upper bound
    state = bnd.make_bounded_state(A, b, lb, ub, torch.tensor(basis),
                                   torch.tensor(vs))
    back = bounded_state_to_numpy(bounded_state_from_numpy(
        bounded_state_to_numpy(state)))
    for k, v in bounded_state_to_numpy(state).items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    assert back["var_state"].dtype == np.int8
    x_n = bnd.nonbasic_values(state.var_state, lb, ub).numpy()
    np.testing.assert_array_equal(x_n[:, 0], prob[4][:, 0])
    np.testing.assert_array_equal(x_n[:, 1:], 0.0)
    x = bnd.expand_bounded_bfs(state, lb, ub).numpy()
    # the all-slack basis: x_B = b - A[:, 0] ub_0
    np.testing.assert_allclose(x[:, n:], prob[2] - prob[1][:, :, 0]
                               * prob[4][:, :1], atol=1e-6)
    np.testing.assert_allclose(np.einsum("bmn,bn->bm", prob[1], x), prob[2],
                               atol=1e-5)


def test_device_bounded_lps_has_a_feasible_slack_start():
    gen = torch.Generator().manual_seed(0)
    B, m, n = 4, 6, 8
    c, A, b, lb, ub = device_bounded_lps(gen, B, m, n, "cpu")
    assert A.shape == (B, m, n + m) and c.shape == lb.shape == ub.shape
    assert bool((b >= 0).all()) and bool((c[:, n:] == 0).all())
    assert bool(torch.isinf(ub[:, n:]).all())
    assert bool(((ub[:, :n] >= 0.5) & (ub[:, :n] < 2.0)).all())
    basis, vs = slack_start(B, m, n)
    res = lt.solve_batch_bounded(c, A, b, lb, ub, torch.tensor(basis),
                                 torch.tensor(vs), 500,
                                 lt.SolverConfig(refactor_every=16))
    want = highs_costs(tuple(t.numpy() for t in (c, A, b, lb, ub)))
    gap = np.abs(res.cost.numpy() - want) / np.maximum(1.0, np.abs(want))
    assert (res.status.numpy() == st.OPTIMAL).all() and (gap < 1e-5).all()


def test_singular_starting_basis_is_a_status_not_an_exception():
    prob = bounded_lps(2, 3, 4, seed=2)
    c, A, b, lb, ub = (torch.tensor(a) for a in prob)
    A[1, :, 0] = 0.0  # a zero column in lane 1's basis: exactly singular
    basis = torch.tensor([[4, 5, 6], [0, 1, 6]], dtype=torch.int32)
    vs = torch.zeros((2, 7), dtype=torch.int8)
    vs.scatter_(1, basis.long(), 2)
    res = lt.solve_batch_bounded(c, A, b, lb, ub, basis, vs, 100,
                                 lt.SolverConfig(refactor_every=16))
    assert res.status.tolist() == [st.OPTIMAL, st.NUMERICAL_ERROR]


def test_shapes_off_the_bounded_kernel_are_not_ported():
    """Every shape is in the port now (the name dates from when shapes off
    the v5e's whole-segment gate raised).  ``kernels="cuda"`` raises only
    past the bounded kernel's streaming branch, naming
    ``kernels="torch"`` (zero-stride tensors: nothing is computed before
    the check); a lane past the v5e gate but inside that line has a plan,
    now on the streaming branch that replaced the block per lane;
    ``"torch"`` runs the per-lane engine, as the reference's
    ``"xla"`` vmaps its own (statuses, bases and iterations equal, x within
    2e-4 of the lane's scale)."""
    from linprog_tpu_torch.engine_batched import _mega_kernel_fits
    from linprog_tpu_torch.ops.bounded_kernel import has_plan, segment_plans
    from linprog_tpu_torch.ops.plans import StreamingPlan

    zero = torch.zeros(())
    m, n = 3072, 6144
    assert not has_plan(m, n)
    args = (zero.expand(1, n), zero.expand(1, m, n), zero.expand(1, m),
            zero.expand(1, n), zero.expand(1, n),
            torch.zeros((), dtype=torch.int32).expand(1, m),
            torch.zeros((), dtype=torch.int8).expand(1, n), 10)
    with pytest.raises(NotImplementedError, match="kernels='torch'"):
        lt.solve_batch_bounded(*args)
    assert has_plan(1280, 2560) and not _mega_kernel_fits(1280, 2560, False)
    assert isinstance(segment_plans(16, 1280, 2560)[0], StreamingPlan)

    prob = bounded_lps(4, 8, 10, seed=5)
    basis, vs = slack_start(4, 8, 10)
    jcfg = JaxSolverConfig(kernels="xla", refactor_every=16)
    ref, out = solve_both(prob, basis, vs, 500, jcfg)
    assert (out.status.numpy() == st.OPTIMAL).all()
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    scale = np.maximum(1.0, np.abs(np.asarray(ref.x)).max(axis=1))
    assert (np.abs(out.x.numpy() - np.asarray(ref.x)).max(axis=1)
            <= 2e-4 * scale).all()


def test_unrefactored_vertex_leaves_its_bounds_as_the_reference_does():
    """One long segment with no refactorization (the bench leg's
    ``refactor_every`` exceeds most lanes' iteration counts): the f32 basic
    values drift, so the float64 vertex of the terminal basis may sit a
    little outside a bound.  That is the algorithm's, not the port's: both
    packages end on the same bases and leave the bounds by the same amount
    (within 1e-6 of the lane's scale ``max(1, max|b|)``)."""
    B, m, n = 4, 48, 48
    prob = bounded_lps(B, m, n, seed=11)
    basis, vs = slack_start(B, m, n)
    jcfg = JaxSolverConfig(kernels="pallas", refactor_every=4096,
                           pricing="dantzig", polish_pivots=8)
    ref, out = solve_both(prob, basis, vs, 4000, jcfg)
    assert (out.status.numpy() == st.OPTIMAL).all()
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    _, _, b, lb, ub = prob
    scale = np.maximum(1.0, np.abs(b).max(axis=1)).astype(np.float64)

    def violation(x):
        x = np.asarray(x, np.float64)
        return (np.maximum(lb - x, x - ub).clip(min=0.0).max(axis=1) / scale)

    got, want = violation(out.x.numpy()), violation(ref.x)
    assert (np.abs(got - want) <= 1e-6).all(), (got, want)
    assert (got <= 1e-5).all(), got  # small m: little drift to speak of
