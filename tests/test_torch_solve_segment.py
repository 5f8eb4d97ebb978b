"""linprog_tpu_torch's segment kernel (plain PyTorch version) against the
reference Pallas kernel in interpret mode, on the same packed state.

Both run f32 on the CPU with different summation orders, so factors and
basic values are compared to 1e-5 relative (of the lane's largest entry);
the discrete outcome -- basis, status, iteration count -- must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """XLA's CPU backend aborts compiling interpret-mode Pallas kernels after
    ~280 accumulated compilations in one process; clearing JAX's caches
    resets it (same workaround as tests/test_solve_kernel.py)."""
    jax.clear_caches()
    yield


from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.engine_batched import (  # noqa: E402
    _pallas_pack,
    batched_primal_step,
)
from linprog_tpu.ops.solve_kernel import solve_segment as jax_solve_segment  # noqa: E402

from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import packed_from_numpy, packed_to_numpy  # noqa: E402
from linprog_tpu_torch.generators import random_inequality_lps  # noqa: E402
from linprog_tpu_torch.ops.solve_kernel import solve_segment  # noqa: E402

OPT_TOL, PIVOT_TOL, FEAS_TOL = 1e-6, 1e-7, 1e-6


def _slack_state(B, m, n, seed, dual, degenerate=True):
    """[G | I] from the slack basis.  Primal mode: Gx <= |h| (feasible
    start).  Dual mode: min |c|'x, Gx <= h (dual-feasible start, infeasible
    rows to repair).  ``degenerate`` zeroes every other rhs (primal) or
    every third cost (dual), so zero-progress pivots occur and the stall
    escalation to Bland's rule fires."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    if dual:
        c = np.abs(c)
        if degenerate:
            c[:, ::3] = 0.0
    else:
        h = np.abs(h)
        if degenerate:
            h[:, ::2] = 0.0
    A = np.concatenate([G, np.broadcast_to(np.eye(m, dtype=np.float32),
                                           (B, m, m))], axis=2)
    cs = np.concatenate([c, np.zeros((B, m), np.float32)], axis=1)
    basis = np.broadcast_to(np.arange(n, n + m, dtype=np.int32), (B, m))
    state = jengine.SimplexState(
        basis=jnp.asarray(basis),
        inv_B=jnp.broadcast_to(jnp.eye(m, dtype=jnp.float32), (B, m, m)),
        bfs=jnp.asarray(h),
        iters=jnp.zeros((B,), jnp.int32),
        status=jnp.zeros((B,), jnp.int32),
    )
    return jnp.asarray(cs), jnp.asarray(A), state


def _run_both(cs, A, state, *, seg_len, maxiters, pricing, dual, packed,
              stall_limit, opt_tol=OPT_TOL):
    B, m, n = A.shape
    allowed = jnp.ones((n,), bool)
    packed_state = _pallas_pack(cs, A, state, allowed)
    # host copies first: the reference kernel donates its state buffers
    packed_np = [np.array(a) for a in packed_state]
    ref = jax_solve_segment(
        A, jnp.swapaxes(A, 1, 2), jnp.zeros((B, 1, 128), jnp.bfloat16),
        packed_state[0], packed_state[1],
        jnp.full((1, 1, 1), maxiters, jnp.int32), *packed_state[2:],
        seg_len=seg_len, pricing=pricing, opt_tol=opt_tol,
        pivot_tol=PIVOT_TOL, dual=dual, feas_tol=FEAS_TOL,
        stall_limit=stall_limit, packed=packed, interpret=True,
    )
    c_t, apen_t, seg = packed_from_numpy(packed_np)
    out = solve_segment(torch.tensor(np.asarray(A)), c_t, apen_t, maxiters,
                        seg, seg_len=seg_len, pricing=pricing,
                        opt_tol=opt_tol, pivot_tol=PIVOT_TOL, dual=dual,
                        feas_tol=FEAS_TOL, stall_limit=stall_limit,
                        packed=packed)
    port = packed_to_numpy(c_t, apen_t, out)
    # reference outputs: (invBT, bfs, cB, basis, pen, gamma, iters, status)
    ref = [np.asarray(a) for a in ref]
    return ref, dict(invBT=port[2], bfs=port[3], cB=port[4], basis=port[5],
                     pen=port[6], gamma=port[7], iters=port[8],
                     status=port[9])


def _assert_same(ref, port):
    invBT, bfs, cB, basis, pen, gamma, iters, status = ref
    np.testing.assert_array_equal(port["status"], status)
    np.testing.assert_array_equal(port["iters"], iters)
    np.testing.assert_array_equal(port["basis"], basis)
    np.testing.assert_array_equal(port["pen"], pen)
    for name, want in (("invBT", invBT), ("bfs", bfs), ("cB", cB),
                       ("gamma", gamma)):
        got = port[name]
        B = want.shape[0]
        scale = np.maximum(np.abs(want).reshape(B, -1).max(axis=1), 1.0)
        err = np.abs(got - want).reshape(B, -1).max(axis=1)
        assert (err <= 1e-5 * scale).all(), (name, err / scale)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("pricing", [0, 1], ids=["bland", "dantzig"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_segment_matches_pallas_kernel(dual, pricing, packed):
    """Primal and dual mode x {bland, dantzig} x packed on/off, with stall
    escalation on (stall_limit 2, low enough that degenerate pivots reach
    it), run to termination in one segment."""
    cs, A, state = _slack_state(6, 10, 12, seed=3 + 2 * dual + pricing, dual=dual)
    ref, port = _run_both(cs, A, state, seg_len=64, maxiters=64,
                          pricing=pricing, dual=dual, packed=packed,
                          stall_limit=2)
    _assert_same(ref, port)
    assert (port["status"] == st.OPTIMAL).all()  # every lane terminated


def test_segment_devex_matches_pallas_kernel():
    """Devex (the plain version; the card tests hold the CUDA kernel to it)
    against the Pallas kernel's devex, on a nondegenerate instance: the weights' products amplify the summation-order
    noise of degenerate paths past the 1e-5 bound."""
    cs, A, state = _slack_state(6, 10, 12, seed=11, dual=False,
                                degenerate=False)
    ref, port = _run_both(cs, A, state, seg_len=64, maxiters=64, pricing=2,
                          dual=False, packed=False, stall_limit=24)
    _assert_same(ref, port)


def test_segment_maxiters_and_seg_len_stop_lanes():
    """A segment stops each lane at seg_len and at maxiters, leaving it
    RUNNING with the iteration count the reference reports."""
    cs, A, state = _slack_state(6, 10, 12, seed=5, dual=False)
    for seg_len, maxiters in ((3, 100), (100, 2)):
        ref, port = _run_both(cs, A, state, seg_len=seg_len,
                              maxiters=maxiters, pricing=1, dual=False,
                              packed=True, stall_limit=24)
        _assert_same(ref, port)
        assert (port["status"] == st.RUNNING).all()
        assert (port["iters"] == min(seg_len, maxiters)).all()


def test_segment_negative_zero_ratio_ties_at_lowest_row():
    """A basic value of -0.0 (a negated zero in the caller's rhs) gives a
    ratio of +0.0, as XLA's ``maximum(-0.0, 0.0)`` does in the reference,
    so the tie at zero goes to the lowest row.  PyTorch's ``clamp_min``
    keeps -0.0, whose packed key (sign bit set) would beat every +0.0."""
    A = np.array([[[1.0, 1.0, 1.0, 0.0],
                   [1.0, 1.0, 0.0, 1.0]]], np.float32)
    cs = np.array([[-1.0, 0.0, 0.0, 0.0]], np.float32)
    state = jengine.SimplexState(
        basis=jnp.asarray([[2, 3]], jnp.int32),
        inv_B=jnp.eye(2, dtype=jnp.float32)[None],
        bfs=jnp.asarray([[0.0, -0.0]], jnp.float32),
        iters=jnp.zeros((1,), jnp.int32),
        status=jnp.zeros((1,), jnp.int32),
    )
    assert np.signbit(np.asarray(state.bfs)[0, 1])
    ref, port = _run_both(jnp.asarray(cs), jnp.asarray(A), state, seg_len=1,
                          maxiters=10, pricing=1, dual=False, packed=True,
                          stall_limit=24)
    _assert_same(ref, port)
    np.testing.assert_array_equal(port["basis"][0, 0], [0, 3])


def test_segment_uses_absolute_opt_tol():
    """The port follows the kernel: optimality is tested against the
    ABSOLUTE opt_tol.  On a lane with max|c| = 100 and a reduced cost of
    -5e-6 the kernel pivots, while the reference's XLA path (tolerance
    scaled by max(1, max|c|) = 100) calls the lane optimal."""
    m = 2
    A = np.array([[[1.0, 1.0, 1.0, 0.0],
                   [1.0, 2.0, 0.0, 1.0]]], np.float32)
    cs = np.array([[-5e-6, 100.0, 0.0, 0.0]], np.float32)
    state = jengine.SimplexState(
        basis=jnp.asarray([[2, 3]], jnp.int32),
        inv_B=jnp.eye(m, dtype=jnp.float32)[None],
        bfs=jnp.asarray([[1.0, 1.0]], jnp.float32),
        iters=jnp.zeros((1,), jnp.int32),
        status=jnp.zeros((1,), jnp.int32),
    )
    ref, port = _run_both(jnp.asarray(cs), jnp.asarray(A), state, seg_len=1,
                          maxiters=10, pricing=1, dual=False, packed=True,
                          stall_limit=24)
    _assert_same(ref, port)
    assert port["iters"][0, 0, 0] == 1
    assert port["basis"][0, 0, 0] == 0  # column 0 entered at row 0

    xla = batched_primal_step(
        jnp.asarray(cs), jnp.asarray(A), jnp.asarray([[1.0, 1.0]]),
        jnp.ones((4,), bool), state,
        JaxSolverConfig(kernels="xla", pricing="dantzig"), 10,
    )
    assert int(xla.status[0]) == st.OPTIMAL  # the scaled rule stops here
