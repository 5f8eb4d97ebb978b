"""Kernel 3's sectional ("partial") pricing in linprog_tpu_torch, held
against the reference (JAX on the CPU, the Pallas streaming kernel in
interpret mode) on the same seeded numpy inputs; the port runs its plain
version on the CPU (the card tests hold the CUDA kernel to it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """XLA's CPU backend aborts after ~280 accumulated compilations in one
    process; clearing JAX's caches resets it (tests/test_stream_kernel.py)."""
    jax.clear_caches()
    yield


import linprog_tpu.engine_batched as jeb  # noqa: E402
from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.engine_batched import _pallas_pack  # noqa: E402
from linprog_tpu.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)

import linprog_tpu_torch.engine_batched as teb  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.config import SolverConfig  # noqa: E402
from linprog_tpu_torch.convert import (  # noqa: E402
    packed_from_numpy,
    simplex_state_from_numpy,
)
from linprog_tpu_torch.ops.stream_kernel import solve_segment_stream  # noqa: E402
from tests.test_torch_solve_segment import _slack_state  # noqa: E402
from tests.test_torch_stream_kernel import _assert_same, _run_both  # noqa: E402


def _setup_feasible(B=6, m=8, n=16, seed=7):
    """``tests/test_stream_kernel.py``'s ``_setup_feasible``: h > 0, so the
    slack basis is a feasible start with a unique optimum."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    h = np.abs(h) + 0.1
    cs, As, bs = to_standard_form_batch(c, G, h)
    n_std = cs.shape[1]
    basis = np.broadcast_to(np.arange(n, n_std, dtype=np.int32), (B, m))
    states = jax.vmap(jengine.make_state, in_axes=(0, 0, 0))(
        jnp.asarray(As), jnp.asarray(bs), jnp.asarray(basis))
    return cs, As, bs, states, np.ones((n_std,), bool)


def _cost(c, state):
    basis = np.asarray(state.basis)
    return (np.take_along_axis(np.asarray(c), basis, axis=1)
            * np.asarray(state.bfs)).sum(axis=1)


def _port_stream(cs, As, bs, states, allowed, maxiters, cfg, variant, n_blk):
    return teb.run_batched_stream(
        torch.tensor(np.asarray(cs)), torch.tensor(np.asarray(As)),
        torch.tensor(np.asarray(bs)),
        simplex_state_from_numpy(
            {k: np.asarray(v) for k, v in states._asdict().items()}),
        torch.tensor(np.asarray(allowed)), maxiters, cfg, variant=variant,
        n_blk=n_blk)


@pytest.mark.parametrize("variant,n_blk", [("resident", 8), ("stream", 8)])
@pytest.mark.parametrize("pricing", ["dantzig", "bland"])
def test_partial_pricing_matches_reference(pricing, variant, n_blk):
    """The cases of ``tests/test_stream_kernel.py::
    test_partial_pricing_reaches_same_optimum`` (m = 8, n = 16 plus slacks,
    seed 7, n_blk 8, segments of 16): the reference's statuses (all
    OPTIMAL) and iteration counts lane by lane, costs within 1e-4 of its
    own and of full pricing's."""
    cs, As, bs, states, allowed = _setup_feasible()
    cfg = dict(pricing=pricing, refactor_every=16, partial_pricing=True)
    ref = jeb.run_batched_stream(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), states,
        jnp.asarray(allowed), 400, JaxSolverConfig(kernels="pallas", **cfg),
        variant=variant, n_blk=n_blk)
    out = _port_stream(cs, As, bs, states, allowed, 400, SolverConfig(**cfg),
                       variant, n_blk)
    full = _port_stream(cs, As, bs, states, allowed, 400,
                        SolverConfig(pricing=pricing, refactor_every=16),
                        variant, n_blk)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    assert bool((out.status == st.OPTIMAL).all())
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(_cost(cs, out), _cost(cs, ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_cost(cs, out), _cost(cs, full), rtol=1e-4,
                               atol=1e-4)


def test_partial_pricing_detects_unbounded():
    """``min -x, x - s = 1``, n_blk 2: PRIMAL_UNBOUNDED with the basis kept,
    as in the reference."""
    c = np.asarray([[-1.0, 0.0]], np.float32)
    A = np.asarray([[[1.0, -1.0]]], np.float32)
    b = np.asarray([[1.0]], np.float32)
    states = jax.vmap(jengine.make_state, in_axes=(0, 0, 0))(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray([[0]], jnp.int32))
    cfg = dict(refactor_every=0, partial_pricing=True, pricing="dantzig")
    ref = jeb.run_batched_stream(jnp.asarray(c), jnp.asarray(A),
                                 jnp.asarray(b), states,
                                 jnp.ones((2,), bool), 50,
                                 JaxSolverConfig(**cfg), variant="stream",
                                 n_blk=2)
    out = _port_stream(c, A, b, states, np.ones((2,), bool), 50,
                       SolverConfig(**cfg), "stream", 2)
    assert int(out.status[0]) == int(ref.status[0]) == st.PRIMAL_UNBOUNDED
    assert int(out.basis[0, 0]) == 0
    assert int(out.iters[0]) == int(ref.iters[0])


@pytest.mark.parametrize("n_blk,pricing,packed", [
    (4, 0, False), (4, 1, True), (8, 0, True), (8, 1, False)],
    ids=["4-bland-unpacked", "4-dantzig-packed", "8-bland-packed",
         "8-dantzig-unpacked"])
def test_partial_segment_matches_pallas_kernel(n_blk, pricing, packed):
    """One segment of the streaming kernel in sectional mode from the same
    packed state, stall escalation on (stall_limit 2: section-local
    Bland), run to termination: the reference kernel's statuses,
    iterations (empty sections counted), bases and penalties, and its
    factor and basic values to 1e-5 of scale."""
    cs, A, state = _slack_state(6, 8, 16, seed=4 + pricing, dual=False)
    ref, port = _run_both(cs, A, state, seg_len=64, maxiters=64,
                          pricing=pricing, dual=False, packed=packed,
                          stall_limit=2, a_resident=True, n_blk=n_blk,
                          partial=True)
    _assert_same(ref, port)
    assert (port["status"] == st.OPTIMAL).all()


def test_run_batched_takes_partial_pricing_where_the_reference_does(
        monkeypatch):
    """With the whole-segment gate shut, ``run_batched`` takes the resident
    variant, whose n_blk (0) becomes 256 in sectional mode only where 256
    divides n (not at n = 24: the mode stays off, as in the reference); a
    variant with its own n_blk runs it in primal mode and never in dual
    mode."""
    monkeypatch.setattr(teb, "_mega_kernel_fits",
                        lambda m, n, with_at, **kw: False)
    seen = []
    kernel = teb.solve_segment_stream

    def recording(*a, **k):
        seen.append((k["dual"], k["partial"], k["n_blk"]))
        return kernel(*a, **k)

    monkeypatch.setattr(teb, "solve_segment_stream", recording)
    cs, As, bs, states, allowed = _setup_feasible()
    cfg = SolverConfig(pricing="dantzig", refactor_every=16,
                       partial_pricing=True)
    st_t = simplex_state_from_numpy(
        {k: np.asarray(v) for k, v in states._asdict().items()})
    args = (torch.tensor(cs), torch.tensor(As), torch.tensor(bs), st_t,
            torch.tensor(allowed), 400)
    teb.run_batched(*args, cfg)
    assert seen and all(s == (False, False, 0) for s in seen)
    seen.clear()
    teb.run_batched_stream(*args, cfg, variant="stream", n_blk=8)
    assert seen and all(s == (False, True, 8) for s in seen)
    seen.clear()
    teb.run_batched_stream(*args, cfg, mode="dual", variant="stream",
                           n_blk=8)
    assert seen and all(s == (True, False, 8) for s in seen)


def test_partial_wrapper_refuses_what_the_reference_refuses():
    cs, A, state = _slack_state(2, 4, 8, seed=0, dual=False)
    c_t, apen_t, seg = packed_from_numpy(
        [np.array(a) for a in _pallas_pack(cs, A, state,
                                           jnp.ones((12,), bool))])
    At = torch.tensor(np.asarray(A))
    kw = dict(seg_len=4, opt_tol=1e-6, pivot_tol=1e-7, pricing=1,
              partial=True)
    with pytest.raises(ValueError, match="primal mode only"):
        solve_segment_stream(At, c_t, apen_t, 10, seg, dual=True, n_blk=4,
                             **kw)
    with pytest.raises(ValueError, match="plain primal only"):
        solve_segment_stream(At, c_t, apen_t, 10, seg, factor_blocked=True,
                             n_blk=4, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        solve_segment_stream(At, c_t, apen_t, 10, seg, n_blk=5, **kw)
