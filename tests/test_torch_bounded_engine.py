"""linprog_tpu_torch's per-lane bounded-variable engine (``bounded_step``,
``run_bounded``, ``refactorize_bounded``, ``solve_bounded_two_phase``)
against the reference package on the same numpy inputs: the reference's
``run_bounded_jit`` and ``solve_bounded_two_phase`` under ``jax.vmap``, as
its own tests run them on the CPU.  Statuses, bases, variable states and
iteration counts must be equal lane for lane on these nondegenerate
instances; values agree within the tolerance each test states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog as highs


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Clear JAX's caches around a module that compiles many programs
    (same workaround as tests/test_solve_kernel.py)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


from linprog_tpu import bounded as jbnd  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import bounded as bnd  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.config import SolverConfig  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from tests.test_torch_bounded import bounded_lps, highs_costs, slack_start  # noqa: E402

F32 = np.float32


def close(got, want, tol):
    """Within ``tol`` of the lane's scale ``max(1, max|want|)`` (inf equal
    to inf)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    B = want.shape[0]
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    want0, got0 = np.where(fin, want, 0.0), np.where(fin, got, 0.0)
    scale = np.maximum(np.abs(want0).reshape(B, -1).max(axis=1), 1.0)
    err = np.abs(got0 - want0).reshape(B, -1).max(axis=1)
    assert (err <= tol * scale).all(), err / scale


def both_states(prob, basis, vs):
    c, A, b, lb, ub = prob
    js = jax.vmap(jbnd.make_bounded_state)(
        *(jnp.asarray(a) for a in (A, b, lb, ub, basis, vs)))
    ts = bnd.make_bounded_state(*(torch.tensor(a) for a in
                                  (A, b, lb, ub, basis, vs)))
    return js, ts


def run_both(prob, basis, vs, maxiters, jcfg, iters0=None):
    js, ts = both_states(prob, basis, vs)
    if iters0 is not None:
        js = js._replace(iters=jnp.asarray(iters0, jnp.int32))
        ts = ts._replace(iters=torch.tensor(iters0, dtype=torch.int32))
    ref = jax.vmap(jbnd.run_bounded_jit,
                   in_axes=(0, 0, 0, 0, 0, 0, None, None))(
        *(jnp.asarray(a) for a in prob), js, maxiters, jcfg)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    out = bnd.run_bounded(*(torch.tensor(a) for a in prob), ts, maxiters,
                          cfg)
    return ref, out


def assert_same_walk(out, ref, tol):
    for name in ("status", "basis", "var_state", "iters"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    close(out.bfs.numpy(), ref.bfs, tol)


@pytest.mark.parametrize("refactor", [0, 8], ids=["r0", "r8"])
@pytest.mark.parametrize("seed", [1, 2])
def test_run_bounded_matches_reference(seed, refactor):
    """The vmapped per-lane bounded engine, from the all-slack start of
    ``bounded_lps`` (8 lanes, m = 10): the same walk on every lane, basic
    values within 1e-4 of scale (5e-4 unrefactored: f32 eta drift in two
    summation orders), every lane OPTIMAL."""
    B, m, n = 8, 10, 12
    prob = bounded_lps(B, m, n, seed=seed)
    basis, vs = slack_start(B, m, n)
    jcfg = JaxSolverConfig(refactor_every=refactor)
    ref, out = run_both(prob, basis, vs, 500, jcfg)
    assert_same_walk(out, ref, 5e-4 if refactor == 0 else 1e-4)
    assert (out.status.numpy() == st.OPTIMAL).all()


def test_refactorization_runs_on_each_lanes_own_cadence(monkeypatch):
    """Counts 0 and 3 at a cadence of 4: the first refresh finds the lanes
    at 4 and 7, as the reference's vmapped loop refreshes them; the walk
    matches the reference's."""
    prob = bounded_lps(2, 10, 12, seed=4)
    basis, vs = slack_start(2, 10, 12)
    seen = []
    refactorize = bnd.refactorize_bounded

    def recording(A, b, lb, ub, s):
        seen.append(s.iters.tolist())
        return refactorize(A, b, lb, ub, s)

    monkeypatch.setattr(bnd, "refactorize_bounded", recording)
    ref, out = run_both(prob, basis, vs, 500,
                        JaxSolverConfig(refactor_every=4), iters0=[0, 3])
    assert seen[0] == [4, 7]
    assert_same_walk(out, ref, 1e-4)


def bazaraa(B=4, big_ub=np.inf):
    """Bazaraa ex. 5.6 on every lane, costs scaled per lane (the optimum
    does not move): x = (2/3, 6, 8/3, 0, 0)."""
    c = np.array([-2.0, -4.0, -1.0, 0.0, 0.0], F32)
    A = np.array([[2.0, 1.0, 1.0, 1.0, 0.0], [1.0, 1.0, -1.0, 0.0, 1.0]], F32)
    b = np.array([10.0, 4.0], F32)
    lb = np.array([0.0, 0.0, 1.0, 0.0, 0.0], F32)
    ub = np.array([4.0, 6.0, 4.0, big_ub, big_ub], F32)
    scales = np.array([1.0, 2.0, 0.5, 3.0], F32)[:B]
    prob = (scales[:, None] * c, np.tile(A, (B, 1, 1)), np.tile(b, (B, 1)),
            np.tile(lb, (B, 1)), np.tile(ub, (B, 1)))
    basis = np.tile(np.array([3, 4], np.int32), (B, 1))
    vs = np.tile(np.array([0, 0, 0, 2, 2], np.int8), (B, 1))
    return prob, basis, vs


BAZARAA_X = np.array([2 / 3, 6.0, 8 / 3, 0.0, 0.0])


@pytest.mark.parametrize("big_ub", [np.inf, 1e6])
def test_bazaraa_on_every_lane(big_ub):
    """The reference's ``test_batched_bounded_variable_engine`` and
    ``test_solve_batch_bounded_matches_single``: every lane OPTIMAL at the
    textbook vertex (1e-3, as those tests hold it), through the engine and
    through ``solve_batch_bounded(kernels="torch")``."""
    prob, basis, vs = bazaraa(big_ub=big_ub)
    ref, out = run_both(prob, basis, vs, 100, JaxSolverConfig())
    assert_same_walk(out, ref, 1e-5)
    lb, ub = (torch.tensor(a) for a in prob[3:])
    x = bnd.expand_bounded_bfs(out, lb, ub).numpy()
    assert (out.status.numpy() == st.OPTIMAL).all()
    np.testing.assert_allclose(x, np.tile(BAZARAA_X, (4, 1)), atol=1e-3)
    res = lt.solve_batch_bounded(*(torch.tensor(a) for a in prob),
                                 torch.tensor(basis), torch.tensor(vs), 100,
                                 SolverConfig(kernels="torch"))
    assert (res.status.numpy() == st.OPTIMAL).all()
    np.testing.assert_allclose(res.x.numpy(), np.tile(BAZARAA_X, (4, 1)),
                               atol=1e-3)


def test_resume_after_iter_limit():
    """One iteration leaves every lane RUNNING; resuming from that state
    reaches the optimum, with the reference's counts."""
    prob, basis, vs = bazaraa()
    js, ts = both_states(prob, basis, vs)
    cfg = SolverConfig(kernels="torch")
    tprob = tuple(torch.tensor(a) for a in prob)
    one = bnd.run_bounded(*tprob, ts, 1, cfg)
    assert (one.status.numpy() == st.RUNNING).all()
    assert (one.iters.numpy() == 1).all()
    done = bnd.run_bounded(*tprob, one, 100, cfg)
    jdone = jax.vmap(jbnd.run_bounded_jit,
                     in_axes=(0, 0, 0, 0, 0, 0, None, None))(
        *(jnp.asarray(a) for a in prob), js, 100, JaxSolverConfig())
    np.testing.assert_array_equal(done.iters.numpy(), np.asarray(jdone.iters))
    x = bnd.expand_bounded_bfs(done, tprob[3], tprob[4]).numpy()
    np.testing.assert_allclose(x, np.tile(BAZARAA_X, (4, 1)), atol=1e-4)


def test_unbounded_flip_and_box_cases():
    """Three hand-built lanes of one size (the reference's engine-level
    cases): (0) ``min -x1, x1 - x2 = 1`` with no upper bounds: no finite
    step of any kind, PRIMAL_UNBOUNDED; (1) ``min -x1, x1 + x2 = 5,
    x1 <= 2``: x1 flips to its upper bound without a basis change, x = (2,
    3); (2) lane 0 with both bounds at M = 1 (the reference's wrapper
    clamps infinite bounds to the BFS bound): x1 = 1.  Statuses, counts
    and values equal to the reference's (1e-5)."""
    c = np.array([[-1.0, 0.0], [-1.0, 0.0], [-1.0, 0.0]], F32)
    A = np.array([[[1.0, -1.0]], [[1.0, 1.0]], [[1.0, -1.0]]], F32)
    b = np.array([[1.0], [5.0], [1.0]], F32)
    lb = np.zeros((3, 2), F32)
    ub = np.array([[np.inf, np.inf], [2.0, np.inf], [1.0, 1.0]], F32)
    basis = np.array([[0], [1], [0]], np.int32)
    vs = np.array([[2, 0], [0, 2], [2, 0]], np.int8)
    prob = (c, A, b, lb, ub)
    ref, out = run_both(prob, basis, vs, 50, JaxSolverConfig())
    assert_same_walk(out, ref, 1e-5)
    assert out.status.tolist() == [st.PRIMAL_UNBOUNDED, st.OPTIMAL,
                                   st.OPTIMAL]
    x = bnd.expand_bounded_bfs(out, torch.tensor(lb), torch.tensor(ub))
    np.testing.assert_allclose(x[1].numpy(), [2.0, 3.0], atol=1e-5)
    assert out.basis[1].tolist() == [1] and out.var_state[1, 0] == bnd.AT_UB
    np.testing.assert_allclose(x[2, 0].item(), 1.0, atol=1e-5)


def test_incremental_bfs_matches_fresh_recompute():
    """After a full run the incrementally kept basic values equal the
    fresh ``inv_B (b - A_N x_N)`` at the terminal state (5e-4, as the
    reference's test holds it), and ``refactorize_bounded`` gives exactly
    that fresh state."""
    prob = bounded_lps(4, 8, 10, seed=9)
    basis, vs = slack_start(4, 8, 10)
    _, ts = both_states(prob, basis, vs)
    tprob = tuple(torch.tensor(a) for a in prob)
    out = bnd.run_bounded(*tprob, ts, 300, SolverConfig(kernels="torch"))
    c, A, b, lb, ub = tprob
    fresh = bnd.refactorize_bounded(A, b, lb, ub, out)
    close(out.bfs.numpy(), fresh.bfs.numpy(), 5e-4)
    want = bnd.compute_bfs(A, b, torch.linalg.inv(
        bnd.basis_matrix(A, out.basis)), out.var_state, lb, ub)
    np.testing.assert_array_equal(fresh.bfs.numpy(), want.numpy())


def test_singular_refactorization_is_numerical_error():
    """A lane whose basis turns singular keeps its factors and stops as
    NUMERICAL_ERROR at the refactorization, as the reference's guard
    does; the other lane is refreshed."""
    prob = bounded_lps(2, 4, 5, seed=3)
    basis, vs = slack_start(2, 4, 5)
    _, ts = both_states(prob, basis, vs)
    c, A, b, lb, ub = (torch.tensor(a) for a in prob)
    A[0, :, 6] = A[0, :, 5]  # two equal basic columns in lane 0
    out = bnd.refactorize_bounded(A, b, lb, ub, ts)
    assert out.status.tolist() == [st.NUMERICAL_ERROR, st.RUNNING]
    assert torch.equal(out.inv_B[0], ts.inv_B[0])
    js = jbnd.BoundedState(*(jnp.asarray(t.numpy()) for t in ts))
    jout = jax.vmap(jbnd.refactorize_bounded)(
        *(jnp.asarray(t.numpy()) for t in (A, b, lb, ub)), js)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(jout.status))


def test_kernel_route_matches_the_per_lane_engine():
    """The reference's ``test_bounded_mega_kernel_matches_vmapped_engine``:
    ``solve_batch_bounded`` on the bounded kernel (its plain version here)
    and on the per-lane engine agree lane for lane on statuses, bases and
    iterations, x within 2e-4 of scale, and both match HiGHS to 1e-5."""
    B, m, n = 8, 10, 12
    prob = bounded_lps(B, m, n, seed=7)
    basis, vs = slack_start(B, m, n)
    tprob = tuple(torch.tensor(a) for a in prob)
    cfg = SolverConfig(refactor_every=16)
    kern = lt.solve_batch_bounded(*tprob, torch.tensor(basis),
                                  torch.tensor(vs), 500, cfg)
    lane = lt.solve_batch_bounded(*tprob, torch.tensor(basis),
                                  torch.tensor(vs), 500,
                                  cfg.replace(kernels="torch"))
    assert (kern.status.numpy() == st.OPTIMAL).all()
    for name in ("status", "basis", "iters"):
        np.testing.assert_array_equal(getattr(kern, name).numpy(),
                                      getattr(lane, name).numpy())
    close(kern.x.numpy(), lane.x.numpy(), 2e-4)
    want = highs_costs(prob)
    gap = np.abs(lane.cost.numpy() - want) / np.maximum(1.0, np.abs(want))
    assert (gap < 1e-5).all(), gap


def two_phase_lps(B=6, m=5, n=12, seed=0):
    """``min c'x, G x = b, 0 <= x <= ub`` with ``b = G x0`` for an ``x0``
    inside the box (rows flipped so ``b >= 0``), a few columns without an
    upper bound; lane 0 made infeasible (all columns boxed, ``b`` far
    outside what the box reaches)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, m, n)).astype(F32)
    ub = rng.uniform(0.5, 2.0, (B, n)).astype(F32)
    x0 = (rng.random((B, n)) * ub).astype(F32)
    ub[1:, :3] = np.inf
    b = np.einsum("bmn,bn->bm", G, x0).astype(F32)
    G = np.where((b < 0)[:, :, None], -G, G)
    b = np.abs(b)
    b[0] *= 100.0
    c = rng.uniform(-1.0, 1.0, (B, n)).astype(F32)
    c[1:, :3] = np.abs(c[1:, :3])  # the unboxed columns do not improve
    return c, G, b, np.zeros((B, n), F32), ub


def test_solve_bounded_two_phase_matches_reference():
    """The two-phase bounded solve, no starting basis: statuses, bases and
    counts equal to the reference's vmapped ``solve_bounded_two_phase``; x
    within 1e-5 of scale; the infeasible lane carries the reference's
    Farkas duals (1e-5); the OPTIMAL lanes match HiGHS to 1e-5."""
    prob = two_phase_lps()
    jcfg = JaxSolverConfig(pricing="dantzig", refactor_every=16)
    ref = jax.vmap(lambda c, A, b, lb, ub: jbnd.solve_bounded_two_phase(
        c, A, b, lb, ub, 200, 200, jcfg))(*(jnp.asarray(a) for a in prob))
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    x, basis, iters, status, y = bnd.solve_bounded_two_phase(
        *(torch.tensor(a) for a in prob), 200, 200, cfg)
    jx, jbasis, jiters, jstatus, jy = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(status.numpy(), jstatus)
    np.testing.assert_array_equal(basis.numpy(), jbasis)
    np.testing.assert_array_equal(iters.numpy(), jiters)
    close(x.numpy(), jx, 1e-5)
    close(y.numpy(), jy, 1e-5)
    assert status[0] == st.PRIMAL_INFEASIBLE
    assert (status[1:].numpy() == st.OPTIMAL).all()
    c, G, b, lb, ub = prob
    for i in range(1, c.shape[0]):
        want = highs(c[i], A_eq=G[i], b_eq=b[i],
                     bounds=[(0, None if np.isinf(u) else u) for u in ub[i]],
                     method="highs")
        got = float(np.dot(c[i].astype(np.float64), x[i].numpy()))
        assert abs(got - want.fun) / max(1.0, abs(want.fun)) < 1e-5
