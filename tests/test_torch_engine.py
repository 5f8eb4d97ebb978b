"""linprog_tpu_torch's per-lane engine (``engine.run`` and its steps), its
routes in ``run_batched`` (dual mode) and the exact router's m >= 3072
branches, against the reference package on the same numpy inputs.

The reference runs as its own tests run it on the CPU: ``engine.run_jit``
under ``jax.vmap`` and ``run_batched`` with ``kernels="pallas"``, which at a
blocked-factor shape in dual mode leaves its kernels for the vmapped
per-lane dual engine.  The port's per-lane engine must walk the same bases:
statuses, bases and iteration counts equal lane for lane on these
nondegenerate instances, basic values and costs within 1e-5 of the lane's
scale (f32 sums in two orders).
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


import linprog_tpu.engine_batched as jeb  # noqa: E402
from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.router import exact_cleanup_config as jax_exact_cleanup_config  # noqa: E402
from linprog_tpu.router import recovery_cleanup_config as jax_recovery_cleanup_config  # noqa: E402

import linprog_tpu_torch.engine_batched as teb  # noqa: E402
from linprog_tpu_torch import engine  # noqa: E402
from linprog_tpu_torch import router  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.calibration import (  # noqa: E402
    get_table,
    reset_table,
    set_table,
)
from linprog_tpu_torch.config import SolverConfig  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from linprog_tpu_torch.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)
from tests.problems import BLAND_PATH_PROBLEMS  # noqa: E402

F32 = np.float32


def primal_setup(B=8, m=12, n=12, seed=1):
    """``min c'x, [G | I] z = h`` from ``random_inequality_lps`` (h > 0),
    started at the slack basis: primal feasible, nondegenerate."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    cs, As, bs = to_standard_form_batch(c, G, h)
    basis = np.broadcast_to(np.arange(n, n + m, dtype=np.int32), (B, m)).copy()
    return cs, As, bs, basis


def dual_setup(B=8, m=12, n=12, seed=2):
    """Positive costs (the slack basis is dual feasible) and a right-hand
    side with negative entries (the slack basis is primal infeasible): the
    dual simplex's start.  Some lanes may be primal infeasible."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, m, n)).astype(F32)
    c = (0.1 + rng.random((B, n))).astype(F32)
    h = rng.standard_normal((B, m)).astype(F32)
    A = np.concatenate([G, np.broadcast_to(np.eye(m, dtype=F32), (B, m, m))],
                       axis=2)
    cs = np.concatenate([c, np.zeros((B, m), F32)], axis=1)
    basis = np.broadcast_to(np.arange(n, n + m, dtype=np.int32), (B, m)).copy()
    return cs, A, h, basis


def run_both(cs, As, bs, basis, jcfg, mode, maxiters=200, iters0=None,
             allowed=None):
    """The reference's vmapped ``run_jit`` and the port's ``engine.run``
    from the same starting bases (and, optionally, starting counts)."""
    B, _, n = As.shape
    allowed = np.ones(n, bool) if allowed is None else allowed
    js = jax.vmap(jengine.make_state)(jnp.asarray(As), jnp.asarray(bs),
                                      jnp.asarray(basis))
    ts = engine.make_state(torch.tensor(As), torch.tensor(bs),
                           torch.tensor(basis))
    if iters0 is not None:
        js = js._replace(iters=jnp.asarray(iters0, jnp.int32))
        ts = ts._replace(iters=torch.tensor(iters0, dtype=torch.int32))
    ref = jax.vmap(jengine.run_jit,
                   in_axes=(0, 0, 0, 0, None, None, None, None))(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), js,
        jnp.asarray(allowed), maxiters, jcfg, mode)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    out = engine.run(torch.tensor(cs), torch.tensor(As), torch.tensor(bs), ts,
                     torch.tensor(allowed), maxiters, cfg, mode)
    return ref, out


def close(got, want, tol=1e-5):
    """Within ``tol`` of the lane's scale ``max(1, max|want|)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    B = want.shape[0]
    scale = np.maximum(np.abs(want).reshape(B, -1).max(axis=1), 1.0)
    err = np.abs(got - want).reshape(B, -1).max(axis=1)
    assert (err <= tol * scale).all(), err / scale


def assert_same_walk(out, ref, tol=1e-3):
    """Equal statuses, bases and counts; basic values within ``tol`` of
    scale.  The default is the drift of an unrefactored f32 eta product
    over some 30 pivots in two summation orders (6e-4 on the worst lane
    here; the reference holds its own vmapped and batched engines to 2e-4
    absolute plus 2e-4 relative)."""
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    close(out.bfs.numpy(), ref.bfs, tol)


def exact_costs(cs, As, bs, basis):
    """float64 objective at each lane's basis (an exact solve)."""
    Bm = np.take_along_axis(As.astype(np.float64),
                            np.asarray(basis)[:, None, :], axis=2)
    xB = np.linalg.solve(Bm, bs.astype(np.float64)[:, :, None])[:, :, 0]
    return np.einsum("bm,bm->b", np.take_along_axis(
        cs.astype(np.float64), np.asarray(basis), axis=1), xB)


@pytest.mark.parametrize("refactor", [0, 8], ids=["r0", "r8"])
@pytest.mark.parametrize("update", ["eta", "naive"])
@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_engine_run_matches_reference(mode, pricing, update, refactor):
    """Same status, basis and iteration count on every lane, basic values
    within 1e-3 of scale unrefactored and 1e-4 otherwise, the float64 cost
    at the terminal basis within 1e-5 relative on the OPTIMAL lanes."""
    setup = primal_setup if mode == "primal" else dual_setup
    cs, As, bs, basis = setup()
    jcfg = JaxSolverConfig(pricing=pricing, update=update,
                           refactor_every=refactor)
    ref, out = run_both(cs, As, bs, basis, jcfg, mode)
    # refactorized every 8 pivots (or inverted at every pivot) the drift
    # stays an order of magnitude smaller
    assert_same_walk(out, ref, 1e-3 if refactor == 0 and update == "eta"
                     else 1e-4)
    if mode == "primal":
        assert (out.status.numpy() == st.OPTIMAL).all()
    else:  # the dual engine repairs or proves infeasible
        assert np.isin(out.status.numpy(),
                       [st.OPTIMAL, st.DUAL_UNBOUNDED]).all()
        assert (out.status.numpy() == st.OPTIMAL).any()
    opt = out.status.numpy() == st.OPTIMAL
    cost = exact_costs(cs, As, bs, out.basis.numpy())
    jcost = exact_costs(cs, As, bs, ref.basis)
    rel = np.abs(cost - jcost) / np.maximum(1.0, np.abs(jcost))
    assert (rel[opt] < 1e-5).all()


def test_refactorization_runs_on_each_lanes_own_cadence(monkeypatch):
    """Lanes that start at different counts refactorize every
    ``refactor_every`` of their OWN pivots (the reference's vmapped
    ``engine.run``), not on the batched loop's minimum over running
    lanes: with counts 0 and 3 and a cadence of 4, the first refresh finds
    the lanes at 4 and 7 (merged, it would find 4 and 4).  The whole run
    matches the reference's walk, counts included."""
    cs, As, bs, basis = primal_setup(B=2, seed=5)
    seen = []
    refactorize = engine.refactorize

    def recording(A, b, s):
        seen.append(s.iters.tolist())
        return refactorize(A, b, s)

    monkeypatch.setattr(engine, "refactorize", recording)
    jcfg = JaxSolverConfig(pricing="bland", refactor_every=4)
    ref, out = run_both(cs, As, bs, basis, jcfg, "primal", iters0=[0, 3])
    assert seen[0] == [4, 7]
    assert_same_walk(out, ref)
    assert (out.status.numpy() == st.OPTIMAL).all()


def test_maxiters_leaves_lanes_running_and_counts_the_optimal_entry():
    """Hitting ``maxiters`` leaves a lane RUNNING; the entry that detects
    optimality counts as an iteration (both as in the reference)."""
    cs, As, bs, basis = primal_setup()
    jcfg = JaxSolverConfig(pricing="dantzig")
    ref, out = run_both(cs, As, bs, basis, jcfg, "primal", maxiters=5)
    assert_same_walk(out, ref)
    assert (out.status.numpy() == st.RUNNING).all()
    assert (out.iters.numpy() == 5).all()
    full, _ = run_both(cs, As, bs, basis, jcfg, "primal")
    ref2, out2 = run_both(cs, As, bs, np.asarray(full.basis), jcfg, "primal")
    assert_same_walk(out2, ref2)
    assert (out2.iters.numpy() == 1).all()  # an optimal start: one entry
    assert (out2.status.numpy() == st.OPTIMAL).all()


def beale_batch(B=3):
    """Beale's LP, on which Dantzig's rule cycles and Bland's terminates
    (float64, as the reference's test runs it)."""
    c = np.array([0, 0, 0, -0.75, 150, -0.02, 6], np.float64)
    A = np.array([[1, 0, 0, 0.25, -60, -1 / 25, 9],
                  [0, 1, 0, 0.5, -90, -1 / 50, 3],
                  [0, 0, 1, 0, 0, 1, 0]], np.float64)
    b = np.array([0, 0, 1], np.float64)
    return (np.tile(c, (B, 1)), np.tile(A, (B, 1, 1)), np.tile(b, (B, 1)),
            np.tile(np.array([0, 1, 2], np.int32), (B, 1)))


@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
def test_beale_bland_terminates_and_dantzig_cycles(pricing):
    """Bland reaches the optimum -0.05 (x6 = 1); Dantzig cycles for all 60
    iterations at cost 0, as the reference's engine does (to 1e-9)."""
    cs, As, bs, basis = beale_batch()
    jcfg = JaxSolverConfig(pricing=pricing, opt_tol=1e-9, pivot_tol=1e-12,
                           dtype="float64")
    B, n = cs.shape
    js = jax.vmap(jengine.make_state)(jnp.asarray(As), jnp.asarray(bs),
                                      jnp.asarray(basis))
    ref = jax.vmap(jengine.run_jit,
                   in_axes=(0, 0, 0, 0, None, None, None, None))(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), js,
        jnp.ones(n, bool), 60, jcfg, "primal")
    cfg = SolverConfig(pricing=pricing, opt_tol=1e-9, pivot_tol=1e-12,
                       kernels="torch")
    tc, tA, tb = (torch.tensor(a) for a in (cs, As, bs))
    out = engine.run(tc, tA, tb, engine.make_state(tA, tb,
                                                   torch.tensor(basis)),
                     torch.ones(n, dtype=torch.bool), 60, cfg)
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    cost = engine.current_cost(tc, out).numpy()
    if pricing == "bland":
        assert (out.status.numpy() == st.OPTIMAL).all()
        np.testing.assert_allclose(cost, -0.05, atol=1e-9)
    else:
        assert (out.status.numpy() == st.RUNNING).all()
        assert (out.iters.numpy() == 60).all()
        np.testing.assert_allclose(cost, 0.0, atol=1e-9)


@pytest.mark.parametrize("problem", BLAND_PATH_PROBLEMS, ids=lambda p: p.name)
def test_explicit_pivots_walk_the_published_bland_path(problem):
    """One engine iteration at a time (``maxiters`` one more each call)
    walks the published Bland basis sequence, as the reference's
    ``solve(maxiters=1)`` does; ``pivot`` applied to the same rows and
    columns gives the same factors."""
    c, A, b = (torch.tensor(a, dtype=torch.float64)[None]
               for a in (problem.c, problem.A, problem.b))
    n = c.shape[1]
    cfg = SolverConfig(pricing="bland", kernels="torch")
    state = engine.make_state(A, b, torch.tensor(problem.basis_seq[:1]))
    allowed = torch.ones(n, dtype=torch.bool)
    for k, expected in enumerate(problem.basis_seq[1:], start=1):
        nxt = engine.run(c, A, b, state, allowed, k, cfg)
        leave = (nxt.basis != state.basis).to(torch.int8).argmax(dim=1)
        piv = engine.pivot(A, b, state, leave,
                           torch.gather(nxt.basis, 1, leave[:, None])[:, 0],
                           cfg)
        np.testing.assert_array_equal(nxt.basis[0].numpy(), expected)
        np.testing.assert_allclose(piv.inv_B.numpy(), nxt.inv_B.numpy(),
                                   atol=1e-12)
        state = nxt
    done = engine.run(c, A, b, state, allowed, len(problem.basis_seq), cfg)
    np.testing.assert_array_equal(done.basis[0].numpy(),
                                  problem.basis_seq[-1])
    assert int(done.status[0]) == st.OPTIMAL


def test_devex_raises_in_both_steps():
    """The per-lane engine has no devex, as the reference's has none."""
    cs, As, bs, basis = primal_setup(B=2)
    tc, tA, tb = (torch.tensor(a) for a in (cs, As, bs))
    state = engine.make_state(tA, tb, torch.tensor(basis))
    allowed = torch.ones(cs.shape[1], dtype=torch.bool)
    cfg = SolverConfig(pricing="devex", kernels="torch")
    with pytest.raises(ValueError, match="devex"):
        engine.primal_step(tc, tA, tb, allowed, state, cfg)
    with pytest.raises(ValueError, match="devex"):
        engine.dual_step(tc, tA, tb, allowed, state, cfg)
    for mode in ("primal", "dual"):
        with pytest.raises(ValueError, match="devex"):
            engine.run(tc, tA, tb, state, allowed, 10, cfg, mode)


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_singular_refactorization_gives_the_references_status(mode):
    """A singular basis refactorizes to NaN factors (``inv_or_nan``; the
    reference's ``jnp.linalg.inv`` gives non-finite ones, never an
    exception).  From those NaN factors no column or row is eligible, so the
    lane stops as OPTIMAL after one entry, with NaN values, in both
    packages; the other lane runs on untouched."""
    cs, As, bs, basis = primal_setup(B=2)
    As = As.copy()
    As[0, :, basis[0, 1]] = As[0, :, basis[0, 0]]  # two equal basic columns
    tA, tb = torch.tensor(As), torch.tensor(bs)
    fresh = engine.refactorize(
        tA, tb, engine.make_state(tA, tb, torch.tensor(basis))._replace(
            status=torch.zeros(2, dtype=torch.int32)))
    assert torch.isnan(fresh.inv_B[0]).all()
    assert torch.isfinite(fresh.inv_B[1]).all()
    jinv = jnp.linalg.inv(jnp.take(jnp.asarray(As[0]), jnp.asarray(basis[0]),
                                   axis=1))
    assert not bool(jnp.isfinite(jinv).all())

    jcfg = JaxSolverConfig(pricing="dantzig")
    js = jengine.SimplexState(*(jnp.asarray(t.numpy()) for t in fresh))
    n = cs.shape[1]
    ref = jax.vmap(jengine.run_jit,
                   in_axes=(0, 0, 0, 0, None, None, None, None))(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), js,
        jnp.ones(n, bool), 200, jcfg, mode)
    out = engine.run(torch.tensor(cs), tA, tb, fresh,
                     torch.ones(n, dtype=torch.bool), 200,
                     config_from_reference(dataclasses.asdict(jcfg)), mode)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    assert int(out.status[0]) == st.OPTIMAL and int(out.iters[0]) == 1
    assert torch.isnan(out.bfs[0]).all()


def test_large_factorizations_run_in_float64(monkeypatch):
    """Past ``engine.F64_PAST`` rows (lowered here) ``inv_or_nan`` and
    ``solve_or_nan`` factor an f32 matrix in float64 and round the result,
    bit for bit; at or below it they stay f32; a singular lane still comes
    back NaN.  With the threshold at 8 the exact pipeline at m = 24 matches
    the reference's statuses and costs (1e-5 relative) and certifies every
    lane."""
    from linprog_tpu.router import solve_batch_exact as jax_solve_batch_exact

    from linprog_tpu_torch import certify_vertex_batch, solve_batch_exact

    rng = np.random.default_rng(4)
    M = torch.tensor(rng.standard_normal((3, 6, 6)).astype(F32))
    M[2, :, 1] = 0.0  # a zero column: LU finds a zero pivot at any width
    rhs = torch.tensor(rng.standard_normal((3, 6)).astype(F32))
    monkeypatch.setattr(engine, "F64_PAST", 6)
    inv32 = torch.linalg.inv_ex(M)[0]
    assert torch.equal(engine.inv_or_nan(M)[:2], inv32[:2])
    monkeypatch.setattr(engine, "F64_PAST", 4)
    inv = engine.inv_or_nan(M)
    x = engine.solve_or_nan(M, rhs)
    assert inv.dtype == x.dtype == torch.float32
    assert torch.equal(inv[:2], torch.linalg.inv(M[:2].double()).float())
    assert torch.equal(x[:2], torch.linalg.solve(
        M[:2].double(), rhs[:2].double()[:, :, None])[:, :, 0].float())
    assert torch.isnan(inv[2]).all() and torch.isnan(x[2]).all()

    monkeypatch.setattr(engine, "F64_PAST", 8)
    c, G, h = random_inequality_lps(8, 24, 24, seed=21)
    jres, _ = jax_solve_batch_exact(jnp.asarray(c), jnp.asarray(G),
                                    jnp.asarray(h))
    tc, tG, th = (torch.tensor(a) for a in (c, G, h))
    res, _ = solve_batch_exact(tc, tG, th)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    jc = np.asarray(jres.cost)
    assert (np.abs(res.cost.numpy() - jc) / np.maximum(1.0, np.abs(jc))
            ).max() < 1e-5
    assert bool(certify_vertex_batch(tc, tG, th, res.basis)["certified"].all())


def test_state_helpers_match_reference():
    """``reduced_costs``, ``current_cost``, the feasibility checks,
    ``artificial_state``, ``eta_update`` and ``tree_select`` lane by lane
    (floats to 1e-5 of scale); ``status.is_terminal`` / ``as_status``."""
    cs, As, bs, basis = primal_setup(B=4, seed=7)
    tc, tA, tb = (torch.tensor(a) for a in (cs, As, bs))
    state = engine.make_state(tA, tb, torch.tensor(basis))
    js = jax.vmap(jengine.make_state)(jnp.asarray(As), jnp.asarray(bs),
                                      jnp.asarray(basis))
    close(engine.reduced_costs(tc, tA, state).numpy(),
          jax.vmap(jengine.reduced_costs)(jnp.asarray(cs), jnp.asarray(As), js))
    close(engine.current_cost(tc, state).numpy()[:, None],
          np.asarray(jax.vmap(jengine.current_cost)(jnp.asarray(cs),
                                                    js))[:, None])
    for fn, jfn, args in (
            (engine.basis_is_primal_feasible, jengine.basis_is_primal_feasible,
             (As, bs)),
            (engine.basis_is_dual_feasible, jengine.basis_is_dual_feasible,
             (cs, As))):
        for k in (0, 5):  # the slack basis, and a shifted one
            bas = (basis + k) % As.shape[2]
            got = fn(*(torch.tensor(a) for a in args), torch.tensor(bas), 1e-6)
            want = jax.vmap(jfn, in_axes=(0, 0, 0, None))(
                *(jnp.asarray(a) for a in args), jnp.asarray(bas), 1e-6)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    art = engine.artificial_state(tb, 7)
    jart = jax.vmap(jengine.artificial_state, in_axes=(0, None))(
        jnp.asarray(bs), 7)
    for a, b in zip(art, jart):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    d = torch.einsum("bmk,bk->bm", state.inv_B, tA[:, :, 0])
    leave = torch.tensor([0, 1, 2, 3])
    inv, bfs = engine.eta_update(state.inv_B, state.bfs, d, leave)
    jinv, jbfs = jax.vmap(jengine.eta_update)(
        js.inv_B, js.bfs, jnp.asarray(d.numpy()), jnp.asarray(leave.numpy()))
    close(inv.numpy(), jinv)
    close(bfs.numpy(), jbfs)
    pick = torch.tensor([True, False, True, False])
    mixed = engine.tree_select(pick, state._replace(iters=state.iters + 3),
                               state)
    assert mixed.iters.tolist() == [3, 0, 3, 0]
    assert st.is_terminal(st.OPTIMAL) and not st.is_terminal(st.RUNNING)
    assert st.is_terminal(mixed.status + 1).all()
    codes = st.as_status([0, 1, 9])
    assert codes.dtype == torch.int32 and codes.tolist() == [0, 1, 9]


@pytest.fixture
def blocked_shape(monkeypatch):
    """Both packages see a blocked-factor shape at m = 12: the whole-segment
    gate is shut and the streaming rule answers ``stream_blocked``.  Counts
    the port's streaming-kernel calls by mode, blocked and packed flags."""
    for eb in (jeb, teb):
        monkeypatch.setattr(eb, "_mega_kernel_fits",
                            lambda m, n, with_at, **kw: False)
        monkeypatch.setattr(eb, "_stream_variant",
                            lambda m, n, **kw: ("stream_blocked", n))
    calls = []
    kernel = teb.solve_segment_stream

    def counting(*a, **k):
        calls.append((k["dual"], k["factor_blocked"], k["packed"]))
        return kernel(*a, **k)

    monkeypatch.setattr(teb, "solve_segment_stream", counting)
    return calls


@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
@pytest.mark.parametrize("kernels", ["cuda", "torch"])
def test_run_batched_dual_at_a_blocked_shape(blocked_shape, kernels, pricing):
    """Dual mode at a ``stream_blocked`` shape: the reference runs its
    vmapped per-lane dual engine; the port runs the streaming kernel
    UNBLOCKED and UNPACKED (exact minima, as that engine selects) under
    ``"cuda"`` (its plain version here) and the per-lane engine under
    ``"torch"``.  Same statuses, costs within 1e-5 relative on
    the OPTIMAL lanes (degenerate lanes may stop at another optimal vertex
    under the kernel; under ``"torch"`` the bases match too)."""
    cs, As, bs, basis = dual_setup(B=8, seed=3)
    n = cs.shape[1]
    jcfg = JaxSolverConfig(kernels="pallas", pricing=pricing,
                           refactor_every=8, packed_select=True)
    js = jax.vmap(jengine.make_state)(jnp.asarray(As), jnp.asarray(bs),
                                      jnp.asarray(basis))
    ref = jeb.run_batched(jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs),
                          js, jnp.ones(n, bool), 200, jcfg, mode="dual")
    cfg = config_from_reference(dataclasses.asdict(jcfg)).replace(
        kernels=kernels)
    tA, tb = torch.tensor(As), torch.tensor(bs)
    out = teb.run_batched(torch.tensor(cs), tA, tb,
                          engine.make_state(tA, tb, torch.tensor(basis)),
                          torch.ones(n, dtype=torch.bool), 200, cfg,
                          mode="dual")
    if kernels == "cuda":  # packed_select=True in the config: dual unpacks
        assert blocked_shape and set(blocked_shape) == {(True, False, False)}
    else:
        assert not blocked_shape
        np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    assert (out.status.numpy() == st.OPTIMAL).sum() >= 4
    opt = out.status.numpy() == st.OPTIMAL
    cost = engine.current_cost(torch.tensor(cs), out).numpy()
    jcost = np.einsum("bm,bm->b", np.take_along_axis(cs, np.asarray(ref.basis),
                                                     axis=1),
                      np.asarray(ref.bfs))
    rel = np.abs(cost - jcost) / np.maximum(1.0, np.abs(jcost))
    assert (rel[opt] < 1e-5).all(), rel


def test_reoptimize_new_rhs_at_a_blocked_shape(blocked_shape):
    """The warm right-hand-side re-solve reaches its dual phase at a
    blocked-factor shape (it used to raise there): the streaming kernel
    runs it unblocked, the primal cleanup blocked, and every lane ends
    OPTIMAL or DUAL_UNBOUNDED at the reference's costs (1e-5 relative)."""
    from linprog_tpu.batch import reoptimize_batch_new_rhs as jax_reopt
    from linprog_tpu.batch import solve_batch_two_phase as jax_two_phase

    from linprog_tpu_torch.batch import reoptimize_batch_new_rhs

    cs, As, bs, _ = primal_setup(B=8, seed=9)
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig",
                           refactor_every=8, packed_select=True)
    base = jax_two_phase(jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs),
                         200, 200, jcfg)
    assert (np.asarray(base.status) == st.OPTIMAL).all()
    rng = np.random.default_rng(0)
    b_new = (bs * (1.0 + 0.05 * rng.standard_normal(bs.shape))).astype(F32)
    ref = jax_reopt(jnp.asarray(cs), jnp.asarray(As), jnp.asarray(b_new),
                    base.basis, 200, jcfg)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    out = reoptimize_batch_new_rhs(torch.tensor(cs), torch.tensor(As),
                                   torch.tensor(b_new),
                                   torch.tensor(np.asarray(base.basis)), 200,
                                   cfg)
    assert ((True, False, False) in blocked_shape
            and (False, True, True) in blocked_shape)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    assert np.isin(out.status.numpy(), [st.OPTIMAL, st.DUAL_UNBOUNDED]).all()
    opt = out.status.numpy() == st.OPTIMAL
    jc = np.asarray(ref.cost)
    rel = np.abs(out.cost.numpy() - jc) / np.maximum(1.0, np.abs(jc))
    assert (rel[opt] < 1e-5).all()


def test_pooled_recovery_at_a_blocked_shape(blocked_shape):
    """Pooled straggler recovery reaches its dual phase at a blocked-factor
    shape too: from the reference's starved IPM (four Newton steps, every
    lane a straggler) both packages repair every lane; the port's dual
    phase runs the streaming kernel unblocked.  Same statuses, costs within
    1e-5 relative of the reference's."""
    import linprog_tpu.ipm as jipm

    import linprog_tpu_torch.ipm as tipm
    from linprog_tpu_torch.convert import batch_result_from_numpy

    c, G, h = random_inequality_lps(8, 20, 20, seed=0)
    raw = jipm.ipm_solve_batch_canonical(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h),
        jipm.IPMConfig(eps_rel=1e-3, maxiters=4))
    assert (np.asarray(raw.status) != st.OPTIMAL).all()
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig",
                           refactor_every=64, polish_pivots=8)
    (ref,) = jipm.recover_stragglers_pooled(
        [tuple(jnp.asarray(a) for a in (c, G, h))], [raw], recover_cfg=jcfg,
        maxiters=400)
    (got,) = tipm.recover_stragglers_pooled(
        [tuple(torch.tensor(a) for a in (c, G, h))],
        [batch_result_from_numpy(raw._asdict())],
        recover_cfg=config_from_reference(dataclasses.asdict(jcfg)),
        maxiters=400)
    assert (True, False, False) in blocked_shape
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert (got.status.numpy() == st.OPTIMAL).all()
    jc = np.asarray(ref.cost)
    rel = np.abs(got.cost.numpy() - jc) / np.maximum(1.0, np.abs(jc))
    assert rel.max() < 1e-5


def test_run_batched_raises_past_every_variant_in_both_modes(monkeypatch):
    """Past every streaming variant ``"cuda"`` raises in dual mode too and
    names ``kernels="torch"``.  Zero-stride tensors: nothing is computed
    before the check."""
    monkeypatch.setattr(teb, "_mega_kernel_fits",
                        lambda m, n, with_at, **kw: False)
    monkeypatch.setattr(teb, "_stream_variant", lambda m, n, **kw: None)
    m, n = 6, 9
    zero = torch.zeros(())
    state = engine.SimplexState(
        basis=torch.zeros((), dtype=torch.int32).expand(1, m),
        inv_B=zero.expand(1, m, m), bfs=zero.expand(1, m),
        iters=torch.zeros(1, dtype=torch.int32),
        status=torch.zeros(1, dtype=torch.int32))
    for mode in ("primal", "dual"):
        with pytest.raises(NotImplementedError, match="kernels='torch'"):
            teb.run_batched(zero.expand(1, n), zero.expand(1, m, n),
                            zero.expand(1, m), state,
                            torch.ones(n, dtype=torch.bool), 10,
                            SolverConfig(), mode=mode)


def test_exact_cleanup_config_at_4096_matches_reference():
    """The blocked-factor regime's cleanup settings, field by field through
    ``config_from_reference``, and the budgets; the recovery's too."""
    for port_fn, ref_fn in ((router.exact_cleanup_config,
                             jax_exact_cleanup_config),
                            (router.recovery_cleanup_config,
                             jax_recovery_cleanup_config)):
        for m in (3072, 4096):
            cfg, budget = port_fn(m)
            jcfg, jbudget = ref_fn(m)
            assert cfg == config_from_reference(dataclasses.asdict(jcfg))
            assert budget == jbudget
    cfg, budget = router.exact_cleanup_config(4096)
    assert (cfg.refactor_every, cfg.unroll, cfg.polish_pivots, budget) == (
        384, 1, 4, 2048)
    assert router.exact_cleanup_config(3071)[0].refactor_every == 128
    assert router.exact_cleanup_config(4096, maxiters=99)[1] == 99


def test_large_m_constant_can_be_lowered(monkeypatch):
    """The blocked regime's settings follow the module constant, so tests
    reach them at a small m."""
    monkeypatch.setattr(router, "_LARGE_M", 16)
    table = dict(get_table())
    table["xover_pallas_max_m"] = 8
    set_table({"default": table})
    try:
        assert router.exact_cleanup_config(24) == router.exact_cleanup_config(
            4096)
        assert router.exact_cleanup_config(12)[0].refactor_every == 128
    finally:
        reset_table()


@pytest.fixture
def large_m_router(monkeypatch):
    """The port's m >= 3072 branches at m = 24: the constant lowered to 16
    (the whole-segment boundary raised to 32, so the retry below it, from
    the alternate guess, does not run first).  Records every
    exact-pipeline call (lanes, guess, budget); a call of the two-phase
    fallback fails the test."""
    import linprog_tpu_torch.batch as tbatch
    import linprog_tpu_torch.crossover as tx

    monkeypatch.setattr(router, "_LARGE_M", 16)
    table = dict(get_table())
    table["xover_pallas_max_m"] = 32  # no alternate-guess retry at m = 24
    calls = []
    pipeline = tx.ipm_crossover_batch_canonical

    def recording(c, G, h, **kw):
        calls.append((G.shape[0], kw["guess"], kw["crossover_maxiters"],
                      kw["cfg"]))
        return pipeline(c, G, h, **kw)

    def no_fallback(*a, **k):
        raise AssertionError("the two-phase fallback ran at m >= 3072")

    monkeypatch.setattr(tx, "ipm_crossover_batch_canonical", recording)
    monkeypatch.setattr(tbatch, "solve_batch_two_phase", no_fallback)
    set_table({"default": table})
    try:
        yield calls
    finally:
        reset_table()


@pytest.mark.parametrize("guess", ["tapia", "magnitude"])
def test_large_m_router_retries_same_guess_at_double_budget(large_m_router,
                                                            guess):
    """A one-pivot budget leaves lanes uncrossed: they are retried in one
    bucket with the SAME guess at twice the budget, no two-phase fallback
    runs, and the lanes that still fail keep their IPM answer and status and
    are counted in ``info["uncrossed"]``."""
    from linprog_tpu_torch import crossover as tx
    from linprog_tpu_torch.router import solve_batch_exact

    B, m = 8, 24
    # seed 51: one lane crosses on the retry and one does not, either guess
    c, G, h = (torch.tensor(a) for a in random_inequality_lps(B, m, m,
                                                              seed=51))
    res, info = solve_batch_exact(c, G, h, maxiters=1, guess=guess)
    first, *rest = large_m_router
    assert first[:3] == (B, guess, 1)
    assert info["fallback"] == 0
    n_bad = B - (info["crossed"] - info["retry_crossed"])
    assert n_bad > 0, "the one-pivot budget crossed every lane"
    assert len(rest) == 1
    lanes, g2, budget2, _ = rest[0]
    assert (g2, budget2) == (guess, 2)
    assert lanes == min(max(8, 1 << (n_bad - 1).bit_length()), B)
    assert info["uncrossed"] == n_bad - info["retry_crossed"]
    assert info["crossed"] + info["uncrossed"] == B

    # replay both passes: the lanes neither crossed keep the first pass's
    # IPM answer and status, bit for bit
    raw, crossed = tx.ipm_crossover_batch_canonical(
        c, G, h, crossover_maxiters=1, cfg=first[3], guess=guess)
    bad = torch.nonzero(~crossed, as_tuple=True)[0]
    idx = router._bucket(bad, B)
    _, crossed2 = tx.ipm_crossover_batch_canonical(
        c[idx], G[idx], h[idx], crossover_maxiters=2, cfg=first[3],
        guess=guess)
    left = sorted(set(bad.tolist()) - set(idx[crossed2].tolist()))
    assert len(left) == info["uncrossed"] > 0
    for name in ("x", "cost", "status", "iters"):
        np.testing.assert_array_equal(getattr(res, name)[left].numpy(),
                                      getattr(raw, name)[left].numpy())
