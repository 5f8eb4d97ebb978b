"""linprog_tpu_torch's streaming segment kernel (plain PyTorch version)
against the reference Pallas kernel in interpret mode, on the same packed
state, and the large-m dispatch of ``run_batched`` in both packages.

The reference kernel reads Aᵀ, the port A.  Both run f32 on the CPU with
different summation orders, so factors and basic values are compared to
1e-5 relative (of the lane's largest entry); the discrete outcome -- basis,
status, iteration count -- must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """XLA's CPU backend aborts compiling interpret-mode Pallas kernels after
    ~280 accumulated compilations in one process; clearing JAX's caches
    resets it (same workaround as tests/test_stream_kernel.py)."""
    jax.clear_caches()
    yield


import linprog_tpu.engine_batched as jeb  # noqa: E402
import linprog_tpu.ops.stream_kernel as jsk  # noqa: E402
from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.engine_batched import _pallas_pack  # noqa: E402

import linprog_tpu_torch.engine_batched as teb  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import (  # noqa: E402
    config_from_reference,
    packed_from_numpy,
    packed_to_numpy,
    simplex_state_from_numpy,
)
from linprog_tpu_torch.ops.stream_kernel import (  # noqa: E402
    _factor_rb,
    solve_segment_stream,
)
from tests.test_torch_solve_segment import _slack_state  # noqa: E402

OPT_TOL, PIVOT_TOL, FEAS_TOL = 1e-6, 1e-7, 1e-6


def _run_both(cs, A, state, *, seg_len, maxiters, pricing, dual, packed,
              stall_limit, a_resident=True, n_blk=8, factor_blocked=False,
              partial=False):
    B, m, n = A.shape
    packed_state = _pallas_pack(cs, A, state, jnp.ones((n,), bool))
    # host copies first: the reference kernel donates its state buffers
    packed_np = [np.array(a) for a in packed_state]
    c_row, apen, invBT, bfs, cB, basis, pen, _, iters, status = packed_state
    kw = dict(seg_len=seg_len, pricing=pricing, opt_tol=OPT_TOL,
              pivot_tol=PIVOT_TOL, dual=dual, feas_tol=FEAS_TOL,
              a_resident=a_resident, n_blk=n_blk, stall_limit=stall_limit,
              packed=packed, factor_blocked=factor_blocked, partial=partial)
    ref = jsk.solve_segment_stream(
        jnp.swapaxes(A, 1, 2), c_row, apen,
        jnp.full((1, 1, 1), maxiters, jnp.int32), invBT, bfs, cB, basis, pen,
        iters, status, **kw)
    c_t, apen_t, seg = packed_from_numpy(packed_np)
    out = solve_segment_stream(torch.tensor(np.asarray(A)), c_t, apen_t,
                               maxiters, seg, **kw)
    port = packed_to_numpy(c_t, apen_t, out)
    # reference outputs: (invBT, bfs, cB, basis, pen, iters, status)
    ref = [np.asarray(a) for a in ref]
    return ref, dict(invBT=port[2], bfs=port[3], cB=port[4], basis=port[5],
                     pen=port[6], iters=port[8], status=port[9])


def _assert_same(ref, port):
    invBT, bfs, cB, basis, pen, iters, status = ref
    np.testing.assert_array_equal(port["status"], status)
    np.testing.assert_array_equal(port["iters"], iters)
    np.testing.assert_array_equal(port["basis"], basis)
    np.testing.assert_array_equal(port["pen"], pen)
    for name, want in (("invBT", invBT), ("bfs", bfs), ("cB", cB)):
        got = port[name]
        B = want.shape[0]
        scale = np.maximum(np.abs(want).reshape(B, -1).max(axis=1), 1.0)
        err = np.abs(got - want).reshape(B, -1).max(axis=1)
        assert (err <= 1e-5 * scale).all(), (name, err / scale)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("pricing", [0, 1], ids=["bland", "dantzig"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("a_resident", [True, False],
                         ids=["resident", "stream"])
def test_stream_segment_matches_pallas_kernel(a_resident, dual, pricing,
                                              packed):
    """Resident and streaming (n_blk 8) modes x primal and dual x {bland,
    dantzig} x packed on/off, with stall escalation on (stall_limit 2, low
    enough that degenerate pivots reach it), run to termination in one
    segment.  Seeds are ones where every lane terminates within the
    segment and the paths agree to 1e-5 (on other seeds a lane can cycle in
    one unrefactored degenerate segment, in the reference too)."""
    seed = {(False, 0): 4, (False, 1): 0, (True, 0): 6, (True, 1): 7}
    cs, A, state = _slack_state(6, 8, 16, seed=seed[dual, pricing],
                                dual=dual)
    ref, port = _run_both(cs, A, state, seg_len=64, maxiters=64,
                          pricing=pricing, dual=dual, packed=packed,
                          stall_limit=2, a_resident=a_resident)
    _assert_same(ref, port)
    assert (port["status"] == st.OPTIMAL).all()  # every lane terminated


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("pricing", [0, 1], ids=["bland", "dantzig"])
def test_blocked_factor_matches_pallas_kernel(pricing, packed):
    """The blocked-factor mode accumulates d = B^-1 a over row blocks of
    the factor; at m = 8 the block is 4 rows, so both versions sum in two
    blocks."""
    assert _factor_rb(8) == 4
    cs, A, state = _slack_state(6, 8, 16, seed=5 + pricing, dual=False)
    ref, port = _run_both(cs, A, state, seg_len=64, maxiters=64,
                          pricing=pricing, dual=False, packed=packed,
                          stall_limit=2, a_resident=False,
                          factor_blocked=True)
    _assert_same(ref, port)
    assert (port["status"] == st.OPTIMAL).all()


def test_row_blocked_eta_update_matches_pallas_kernel(monkeypatch):
    """The reference's row-blocked eta update (large m: 512-row blocks;
    here 8 + 4 rows at m = 12) gives the same pivots as the port's one-shot
    update."""
    monkeypatch.setattr(jsk, "_ETA_BLOCK_ABOVE_M", 4)
    jax.clear_caches()  # the threshold is read at trace time
    cs, A, state = _slack_state(4, 12, 12, seed=2, dual=False)
    ref, port = _run_both(cs, A, state, seg_len=64, maxiters=64, pricing=1,
                          dual=False, packed=True, stall_limit=2,
                          a_resident=False)
    jax.clear_caches()
    _assert_same(ref, port)


def test_stream_negative_zero_ratio_ties_at_lowest_row():
    """A basic value of -0.0 ratios to +0.0, as XLA's ``maximum(-0.0,
    0.0)`` does in the reference, so the tie at zero goes to row 0."""
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


def test_stream_wrapper_refuses_what_the_kernel_does_not_take():
    cs, A, state = _slack_state(2, 4, 4, seed=0, dual=False)
    c_t, apen_t, seg = packed_from_numpy(
        [np.array(a) for a in _pallas_pack(cs, A, state, jnp.ones((8,), bool))])
    At = torch.tensor(np.asarray(A))
    kw = dict(seg_len=4, opt_tol=OPT_TOL, pivot_tol=PIVOT_TOL)
    with pytest.raises(ValueError, match="devex"):
        solve_segment_stream(At, c_t, apen_t, 10, seg, pricing=2, **kw)
    with pytest.raises(ValueError, match="primal only"):
        solve_segment_stream(At, c_t, apen_t, 10, seg, pricing=1, dual=True,
                             factor_blocked=True, **kw)
    with pytest.raises(ValueError, match="c has shape"):
        solve_segment_stream(At, c_t[:, :5], apen_t, 10, seg, pricing=1, **kw)


def test_run_batched_dispatches_stream_kernel_in_both(monkeypatch):
    """With the whole-segment gate shut in both packages, ``run_batched``
    takes the streaming kernel in both (resident variant at this size) and
    both give the same bases, statuses and basic values."""
    calls = {"ref": 0, "port": 0}
    ref_kernel, port_kernel = jsk.solve_segment_stream, teb.solve_segment_stream

    def ref_counting(*a, **k):
        calls["ref"] += 1
        return ref_kernel(*a, **k)

    def port_counting(*a, **k):
        calls["port"] += 1
        return port_kernel(*a, **k)

    for eb in (jeb, teb):
        monkeypatch.setattr(eb, "_mega_kernel_fits", lambda m, n, with_at, **kw: False)
    monkeypatch.setattr(jsk, "solve_segment_stream", ref_counting)
    monkeypatch.setattr(teb, "solve_segment_stream", port_counting)

    cs, A, state = _slack_state(6, 8, 16, seed=23, dual=False,
                                degenerate=False)
    assert jeb._stream_variant(8, 24) == teb._stream_variant(8, 24) == ("resident", 0)
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig",
                           refactor_every=4, packed_select=True)
    allowed = jnp.ones((24,), bool)
    b = state.bfs
    state_np = {k: np.array(v) for k, v in state._asdict().items()}
    ref = jeb.run_batched(cs, A, b, state, allowed, 200, jcfg)
    out = teb.run_batched(torch.tensor(np.asarray(cs)),
                          torch.tensor(np.asarray(A)),
                          torch.tensor(np.asarray(b)),
                          simplex_state_from_numpy(state_np),
                          torch.ones(24, dtype=torch.bool), 200,
                          config_from_reference(dataclasses.asdict(jcfg)))
    assert calls["ref"] > 0 and calls["port"] > 1  # several segments
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    assert (out.status.numpy() == st.OPTIMAL).all()
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_allclose(out.bfs.numpy(), np.asarray(ref.bfs),
                               rtol=1e-5, atol=1e-5)
