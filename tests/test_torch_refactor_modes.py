"""Refactorization modes of linprog_tpu_torch's segment driver against the
reference (JAX on the CPU, Pallas in interpret mode; the port's plain
versions on the CPU): Newton-Schulz refinement (``refactor_method="ns"``)
with its polish loop, the full-batch inversion (``compact_refactor=False``),
and the dual repair of a two-phase lane that the f32 factors end at an
infeasible basis (``tests/data/two_phase_lane973.npz``), with the pivot
where the port's path parts from the reference's."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """XLA's CPU backend aborts after ~280 accumulated compilations in one
    process; clearing JAX's caches resets it (tests/test_stream_kernel.py).
    The m = 256 solves here run torch on one thread: with several test
    workers on the host, each worker's default of one thread a core
    oversubscribes the cores and slowed these tests tenfold."""
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


import linprog_tpu.engine_batched as jeb  # noqa: E402
from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.batch import solve_batch_two_phase as jax_two_phase  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.config import tuned_config as jax_tuned_config  # noqa: E402
from linprog_tpu.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)

import linprog_tpu_torch.engine as teng  # noqa: E402
import linprog_tpu_torch.engine_batched as teb  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.batch import solve_batch_two_phase  # noqa: E402
from linprog_tpu_torch.config import SolverConfig, tuned_config  # noqa: E402
from linprog_tpu_torch.convert import simplex_state_from_numpy  # noqa: E402

LANE973 = pathlib.Path(__file__).parent / "data" / "two_phase_lane973.npz"


def _phase1_setup(B=6, m=8, n=10, seed=0):
    """The Phase-I batch of ``tests/test_batched_engine_kernels.py``:
    ``[A | I]`` with unit costs on the artificials, from the artificial
    basis."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    cs, As, bs = to_standard_form_batch(c, G, h)
    ntot = cs.shape[1]
    c1 = np.concatenate([np.zeros((B, ntot), np.float32),
                         np.ones((B, m), np.float32)], axis=1)
    A1 = np.concatenate([As, np.broadcast_to(np.eye(m, dtype=np.float32),
                                             (B, m, m))], axis=2)
    states = jax.vmap(jengine.artificial_state, in_axes=(0, None))(
        jnp.asarray(bs), ntot)
    allowed = np.ones((ntot + m,), bool)
    return c1, A1, bs, states, allowed


def _cost(c, state):
    basis = np.asarray(state.basis)
    return (np.take_along_axis(np.asarray(c), basis, axis=1)
            * np.asarray(state.bfs)).sum(axis=1)


def _port(c, A, b, states, allowed, maxiters, cfg):
    return teb.run_batched(
        torch.tensor(c), torch.tensor(A), torch.tensor(np.asarray(b)),
        simplex_state_from_numpy(
            {k: np.asarray(v) for k, v in states._asdict().items()}),
        torch.tensor(allowed), maxiters, cfg)


def test_newton_schulz_refine_matches_reference():
    """The same drifted factors refined in both packages: within 1e-5 of
    the exact inverse's scale, the same lanes sent to exact inversion (one
    lane perturbed past the Newton-Schulz basin), and bfs to match."""
    rng = np.random.default_rng(4)
    B, m = 5, 12
    A = rng.standard_normal((B, m, 2 * m)).astype(np.float32)
    A[:, :, m:] += 4.0 * np.eye(m, dtype=np.float32)
    b = rng.standard_normal((B, m)).astype(np.float32)
    basis = np.broadcast_to(np.arange(m, 2 * m, dtype=np.int32), (B, m))
    inv = np.linalg.inv(A[:, :, m:]).astype(np.float32)
    drift = (1e-3 * rng.standard_normal(inv.shape)).astype(np.float32)
    drift[2] *= 500.0  # outside the basin: exact inversion for this lane
    inv_d = inv + drift
    X_r, bfs_r = jeb.newton_schulz_refine(jnp.asarray(A), jnp.asarray(b),
                                          jnp.asarray(basis),
                                          jnp.asarray(inv_d), resid_tol=1e-3)
    X_p, bfs_p = teb.newton_schulz_refine(*(torch.tensor(a) for a in (
        A, b, basis, inv_d)), resid_tol=1e-3)
    scale = np.abs(inv).max()
    assert np.abs(X_p.numpy() - np.asarray(X_r)).max() <= 1e-5 * scale
    assert np.abs(X_p.numpy() - inv).max() <= 1e-4 * scale
    np.testing.assert_allclose(bfs_p.numpy(), np.asarray(bfs_r), rtol=1e-4,
                               atol=1e-5)


def test_newton_schulz_products_in_float64_past_the_line(monkeypatch):
    """Past ``engine.F64_PAST`` rows the refinement's products run in
    float64 on f32 data: the result is the float64 refinement rounded."""
    rng = np.random.default_rng(1)
    B, m = 2, 6
    A = torch.tensor(rng.standard_normal((B, m, m)).astype(np.float32)
                     + 3.0 * np.eye(m, dtype=np.float32))
    b = torch.tensor(rng.standard_normal((B, m)).astype(np.float32))
    basis = torch.arange(m, dtype=torch.int32).expand(B, m)
    inv = torch.linalg.inv(A) + 1e-4
    want, _ = teb.newton_schulz_refine(A.double(), b.double(), basis,
                                       inv.double(), resid_tol=1.0)
    monkeypatch.setattr(teng, "F64_PAST", 4)
    got, _ = teb.newton_schulz_refine(A, b, basis, inv, resid_tol=1.0)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want.float(), rtol=0, atol=0)


@pytest.mark.parametrize("pricing", ["dantzig", "bland"])
def test_newton_schulz_refactor_method_matches_reference(pricing):
    """The case of ``tests/test_batched_engine_kernels.py::
    test_newton_schulz_refactor_method`` (Phase I from the artificial
    basis, seed 11, segments of 8, NS between them and the polish loop
    after) in both packages on kernel 1: the same statuses, all OPTIMAL,
    and costs within 1e-4 of the reference's NS run and of the port's exact
    refactorization."""
    c1, A1, b, states, allowed = _phase1_setup(seed=11)
    jcfg = JaxSolverConfig(pricing=pricing, kernels="pallas",
                           refactor_every=8, refactor_method="ns")
    ref = jeb.run_batched(jnp.asarray(c1), jnp.asarray(A1), jnp.asarray(b),
                          states, jnp.asarray(allowed), 300, jcfg)
    cfg = SolverConfig(pricing=pricing, refactor_every=8)
    ns = _port(c1, A1, b, states, allowed, 300,
               cfg.replace(refactor_method="ns"))
    exact = _port(c1, A1, b, states, allowed, 300, cfg)
    np.testing.assert_array_equal(ns.status.numpy(), np.asarray(ref.status))
    assert bool((ns.status == st.OPTIMAL).all())
    np.testing.assert_allclose(_cost(c1, ns), _cost(c1, ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_cost(c1, ns), _cost(c1, exact), rtol=1e-4,
                               atol=1e-4)


def test_newton_schulz_refreshes_the_streaming_kernel(monkeypatch):
    """With the whole-segment gate shut in both packages, NS runs between
    the streaming kernel's segments (no polish there, as in the
    reference): the reference's statuses and costs within 1e-4."""
    for eb in (jeb, teb):
        monkeypatch.setattr(eb, "_mega_kernel_fits",
                            lambda m, n, with_at, **kw: False)
    c1, A1, b, states, allowed = _phase1_setup(seed=11)
    jcfg = JaxSolverConfig(pricing="dantzig", kernels="pallas",
                           refactor_every=8, refactor_method="ns")
    ref = jeb.run_batched(jnp.asarray(c1), jnp.asarray(A1), jnp.asarray(b),
                          states, jnp.asarray(allowed), 300, jcfg)
    calls = []
    ns_refine = teb.newton_schulz_refine
    monkeypatch.setattr(teb, "newton_schulz_refine",
                        lambda *a, **k: calls.append(1) or ns_refine(*a, **k))
    out = _port(c1, A1, b, states, allowed, 300,
                SolverConfig(pricing="dantzig", refactor_every=8,
                             refactor_method="ns"))
    assert calls
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(_cost(c1, out), _cost(c1, ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kernels", ["cuda", "torch"])
def test_full_batch_refactor_gives_the_compact_bits(kernels):
    """``compact_refactor=False`` inverts every lane between segments; each
    running lane gets the bits the compact inversion gives it, so the whole
    run ends in the same state, bit for bit (kernel 1's plain version and
    the per-step loop)."""
    c1, A1, b, states, allowed = _phase1_setup(seed=3)
    cfg = SolverConfig(pricing="dantzig", refactor_every=4, kernels=kernels)
    compact = _port(c1, A1, b, states, allowed, 300, cfg)
    full = _port(c1, A1, b, states, allowed, 300,
                 cfg.replace(compact_refactor=False))
    for name in compact._fields:
        np.testing.assert_array_equal(getattr(full, name).numpy(),
                                      getattr(compact, name).numpy(), name)
    assert int(compact.iters.max()) > 4  # more than one segment ran


@pytest.fixture(scope="module")
def lane973():
    """Lane 973's standard form, solved once in each package under
    ``tuned_config(256)``: the reference's two-phase result, the port's,
    and the arguments the port handed its dual repair (the state its
    segment path ended in)."""
    import linprog_tpu_torch.batch as tbatch

    d = np.load(LANE973)
    c, A, b = d["c"], d["A"], d["b"]
    ref = jax_two_phase(jnp.asarray(c), jnp.asarray(A), jnp.asarray(b), 4000,
                        4000, jax_tuned_config(256))
    handed = []
    repair = tbatch._repair_infeasible
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbatch, "_repair_infeasible",
                   lambda *a: handed.append(a) or repair(*a))
        res = solve_batch_two_phase(torch.tensor(c), torch.tensor(A),
                                    torch.tensor(b), 4000, 4000,
                                    tuned_config(256))
    return d, ref, res, handed[0]


def test_two_phase_lane973_ends_feasible(lane973):
    """Lane 973 of ``chip_smoke.py`` phase 20a (``device_inequality_lps``
    on an H100, B = 1024, m = n = 256, device seed 0), copied off the card
    once into ``tests/data/two_phase_lane973.npz`` (its standard form, the
    card's x and status), solved alone under ``tuned_config(256)``.
    Kernel 1's path (its plain version here, the kernel on the card) ends
    Phase II at a basis that its f32 eta factors call feasible and an
    exact solve does not (x_B -3.08e-4); the reference's path parts from
    it in Phase I (:func:`test_two_phase_lane973_paths_part_at_a_near_tie`)
    and ends feasible.  The port repairs such a lane by dual pivots from
    fresh factors: OPTIMAL, x >= -1e-6, and the reference's cost within
    1e-6 relative."""
    d, ref, res, handed = lane973
    assert int(d["lanes"][0]) == 973 and float(d["x"].min()) < -3e-4
    assert int(ref.status[0]) == st.OPTIMAL
    assert float(np.min(ref.x)) >= -1e-6
    states = handed[3]
    assert int(states.status[0]) == st.OPTIMAL
    assert float(states.bfs.min()) < -3e-4  # what the segments ended at
    assert int(res.status[0]) == st.OPTIMAL
    assert float(res.x.min()) >= -1e-6, float(res.x.min())
    assert abs(float(res.cost[0]) - float(ref.cost[0])) <= 1e-6 * abs(
        float(ref.cost[0]))


def test_dual_repair_reaches_only_infeasible_optimal_lanes(lane973,
                                                           monkeypatch):
    """The repair runs the dual phase on exactly the OPTIMAL lanes whose
    exact solve is infeasible: lane 973's final state beside a feasible
    OPTIMAL state of the same lane (at the repaired basis).  The feasible
    lane comes back as it went in, bit for bit, and lane 973 gets the
    basis it gets alone."""
    import linprog_tpu_torch.batch as tbatch

    _, _, res, (c, A, b, states, allowed, maxiters, cfg) = lane973
    alone = tbatch._repair_infeasible(c, A, b, states, allowed, maxiters, cfg)
    good = teng.make_state(A, b, res.basis, status=st.OPTIMAL)
    pair = type(states)(*(torch.cat([s, g]) for s, g in zip(states, good)))
    seen = []
    run = tbatch._run_chunked

    def recording(c, A, b, states, allowed, maxiters, cfg, mode):
        if mode == "dual":
            seen.append(A.shape[0])
        return run(c, A, b, states, allowed, maxiters, cfg, mode)

    monkeypatch.setattr(tbatch, "_run_chunked", recording)
    out = tbatch._repair_infeasible(torch.cat([c, c]), torch.cat([A, A]),
                                    torch.cat([b, b]), pair, allowed,
                                    maxiters, cfg)
    assert seen == [1]
    for name in out._fields:
        np.testing.assert_array_equal(getattr(out, name)[1:].numpy(),
                                      getattr(good, name).numpy(), name)
        np.testing.assert_array_equal(getattr(out, name)[:1].numpy(),
                                      getattr(alone, name).numpy(), name)
    assert float(out.bfs[0].min()) >= -1e-6


def test_two_phase_lane973_paths_part_at_a_near_tie():
    """Where the two paths part: Phase I's one segment (kernel 1 from the
    slack crash basis, dantzig, packed keys, no refactorization before
    pivot 512) run for 333 pivots by the reference's Pallas kernel
    (interpret mode) and by the port's plain version (also for 332), from
    the same state.  The two 333-pivot bases are the port's 332-pivot
    basis plus one pivot each: both enter column 251, where the ratio test
    meets a near-tie, rows 72 and 85, whose float64 ratios are less than
    2e-4 apart, row 72 first.  The reference (under ``tuned_config``'s
    ``unroll=4``) takes row 72; the port takes row 85.  No rule differs:
    the reference's own kernel unrolled once, which only regroups its loop
    and so the f32 rounding of its eta updates, takes row 85 too and ends
    at the port's 333-pivot basis.  The fault is the f32 drift of a long
    unrefactored segment, which either package carries."""
    from linprog_tpu.engine_batched import _pallas_pack
    from linprog_tpu.ops.solve_kernel import solve_segment as jax_segment

    from linprog_tpu_torch.engine_batched import _segment_pack
    from linprog_tpu_torch.ops.solve_kernel import solve_segment

    d = np.load(LANE973)
    A, b = d["A"], d["b"]
    (_, m, n), cfg = A.shape, tuned_config(256)
    A1 = np.concatenate([A, np.eye(m, dtype=np.float32)[None]], axis=2)
    c1 = np.concatenate([np.zeros((1, n), np.float32),
                         np.ones((1, m), np.float32)], axis=1)
    kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              feas_tol=cfg.feas_tol, stall_limit=cfg.stall_limit,
              packed=cfg.packed_select)
    start = jax.vmap(jengine.slack_crash_state, in_axes=(0, 0, None))(
        jnp.asarray(A1), jnp.asarray(b), n)
    c_row, apen, *carry = _pallas_pack(jnp.asarray(c1), jnp.asarray(A1),
                                       start, jnp.ones((n + m,), bool))
    AT = jnp.swapaxes(jnp.asarray(A1), 1, 2)

    def reference(k, unroll):  # the kernel donates its state: copies
        out = jax_segment(jnp.asarray(A1), AT, jnp.zeros((1, 1, 128),
                                                         jnp.bfloat16),
                          c_row, apen, jnp.full((1, 1, 1), 4000, jnp.int32),
                          *(jnp.array(x, copy=True) for x in carry),
                          seg_len=k, use_at=True, unroll=unroll, **kw)
        return np.asarray(out[3]).reshape(-1)

    pstart = teng.slack_crash_state(torch.tensor(A1), torch.tensor(b), n)
    papen, seg = _segment_pack(torch.tensor(c1), torch.tensor(A1), pstart,
                               torch.ones((n + m,), dtype=torch.bool))

    def port(k):
        out = solve_segment(torch.tensor(A1), torch.tensor(c1), papen, 4000,
                            type(seg)(*(t.clone() for t in seg)),
                            seg_len=k, **kw)
        return out.basis.numpy().reshape(-1)

    p332, p333 = port(332), port(333)
    r333 = reference(333, cfg.unroll)
    assert cfg.unroll == 4
    assert np.flatnonzero(r333 != p332).tolist() == [72]
    assert np.flatnonzero(p333 != p332).tolist() == [85]
    assert r333[72] == p333[85] == 251
    np.testing.assert_array_equal(reference(333, 1), p333)
    # the exact ratios of the two rows: a near-tie, row 72 first
    Bm = A1[0][:, p332].astype(np.float64)
    x64 = np.linalg.solve(Bm, b[0].astype(np.float64))
    d64 = np.linalg.solve(Bm, A1[0][:, 251].astype(np.float64))
    t72, t85 = x64[72] / d64[72], x64[85] / d64[85]
    assert 0 < t72 < t85 < t72 * (1 + 2e-4)
