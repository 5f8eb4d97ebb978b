"""linprog_tpu_torch's bounded-variable segment kernel (plain PyTorch
version) against the reference Pallas kernel in interpret mode, on the same
packed state.

Both run f32 on the CPU with different summation orders, so factors and
basic values are compared to 1e-5 relative (of the lane's largest finite
entry); the discrete outcome -- basis, variable states, status, iteration
count -- must be equal.
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
    jax.clear_caches()


from linprog_tpu.ops.bounded_kernel import (  # noqa: E402
    solve_bounded_segment as jax_solve_bounded_segment,
)

from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import bounded_packed_from_numpy  # noqa: E402
from linprog_tpu_torch.ops import bounded_kernel as bk  # noqa: E402
from linprog_tpu_torch.ops.bounded_kernel import solve_bounded_segment  # noqa: E402

OPT_TOL, PIVOT_TOL = 1e-6, 1e-7
F32 = np.float32
FIELDS = ("invBT", "bfs", "cB", "basis", "vstate", "lbB", "ubB", "iters",
          "status")


def bounded_lps(B, m, n, seed, ub_hi=2.0):
    """The construction of ``device_bounded_lps`` from a numpy seed:
    ``[G' | I] z = b`` with ``b >= 0``, structural columns boxed in
    ``[0, ub)``, slacks unbounded above."""
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


def packed_start(c, A, bfs, lb, ub, basis, vstate):
    """The reference kernel's 9-tuple state for a basis whose inverse is
    the identity (unit basis columns)."""
    B, m, n = A.shape
    basis = np.broadcast_to(np.asarray(basis, np.int32), (B, m))
    vstate = np.broadcast_to(np.asarray(vstate, F32), (B, n))
    take = lambda v: np.take_along_axis(v, basis, axis=1)[:, None, :]  # noqa: E731
    return (np.broadcast_to(np.eye(m, dtype=F32), (B, m, m)).copy(),
            np.asarray(bfs, F32)[:, None, :].copy(), take(c).copy(),
            basis[:, None, :].copy(), vstate[:, None, :].copy(),
            take(lb).copy(), take(ub).copy(),
            np.zeros((B, 1, 1), np.int32), np.zeros((B, 1, 1), np.int32))


def slack_start(c, A, b, lb, ub):
    B, m, ntot = A.shape
    n = ntot - m
    return packed_start(c, A, b, lb, ub, np.arange(n, ntot),
                        np.r_[np.zeros(n), np.full(m, 2.0)])


def run_both(c, A, lb, ub, packed_np, *, seg_len, maxiters, packed,
             use_at=False):
    B, m, n = A.shape
    packed_np = [np.array(a) for a in packed_np]  # the reference donates
    AT = (jnp.swapaxes(jnp.asarray(A), 1, 2) if use_at
          else jnp.zeros((B, 1, 128), jnp.float32))
    invBT, bfs, cB, basis, vstate, lbB, ubB, iters, status = (
        jnp.asarray(a) for a in packed_np)
    ref = jax_solve_bounded_segment(
        jnp.asarray(A), AT, jnp.asarray(c)[:, None, :],
        jnp.asarray(lb)[:, None, :], jnp.asarray(ub)[:, None, :],
        jnp.full((1, 1, 1), maxiters, jnp.int32), invBT, bfs, cB, basis,
        vstate, lbB, ubB, iters, status, seg_len=seg_len, opt_tol=OPT_TOL,
        pivot_tol=PIVOT_TOL, use_at=use_at, packed=packed)
    ref = dict(zip(FIELDS, (np.asarray(a) for a in ref)))
    seg = bounded_packed_from_numpy(packed_np)
    out = solve_bounded_segment(
        torch.tensor(A), torch.tensor(c), torch.tensor(lb), torch.tensor(ub),
        maxiters, seg, seg_len=seg_len, opt_tol=OPT_TOL, pivot_tol=PIVOT_TOL,
        packed=packed)
    return ref, {k: v.numpy() for k, v in out._asdict().items()}


def assert_same(ref, port):
    B = ref["invBT"].shape[0]
    for name in ("status", "iters", "basis", "vstate"):
        np.testing.assert_array_equal(
            port[name].reshape(B, -1), ref[name].reshape(B, -1).astype(
                port[name].dtype), err_msg=name)
    for name in ("invBT", "bfs", "cB", "lbB", "ubB"):
        want = ref[name].reshape(B, -1)
        got = port[name].reshape(B, -1)
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.where(fin, 0.0, got),
                                      np.where(fin, 0.0, want), err_msg=name)
        scale = np.maximum(np.abs(np.where(fin, want, 0.0)).max(axis=1), 1.0)
        with np.errstate(invalid="ignore"):  # inf - inf off the mask
            err = np.abs(np.where(fin, got - want, 0.0)).max(axis=1)
        # 1e-5 of the lane's scale: f32 sums in two orders
        assert (err <= 1e-5 * scale).all(), (name, err / scale)


@pytest.mark.parametrize("seg_len", [1, 5, 200], ids=["one", "five", "whole"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_segment_matches_pallas_kernel(packed, seg_len):
    """B = 8, m = 10, n = 22 (12 structural + 10 slack) from the all-slack
    start: one iteration, five, and a whole solve in one segment."""
    c, A, b, lb, ub = bounded_lps(8, 10, 12, seed=3)
    ref, port = run_both(c, A, lb, ub, slack_start(c, A, b, lb, ub),
                         seg_len=seg_len, maxiters=500, packed=packed)
    assert_same(ref, port)
    if seg_len == 200:
        assert (port["status"] == st.OPTIMAL).all()
        assert (port["vstate"] == bk.AT_UB).any()  # bound flips happened
    else:
        assert (port["iters"] == seg_len).all()


def test_bounded_segment_reads_a_transposed_copy_the_same():
    """The reference's resident-A^T mode gives what its matmul-fetch mode
    gives; the port, which takes A only, matches it too."""
    c, A, b, lb, ub = bounded_lps(8, 10, 12, seed=4)
    ref, port = run_both(c, A, lb, ub, slack_start(c, A, b, lb, ub),
                         seg_len=200, maxiters=500, packed=True, use_at=True)
    assert_same(ref, port)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_segment_maxiters_cuts_a_segment_short(packed):
    c, A, b, lb, ub = bounded_lps(8, 10, 12, seed=5)
    ref, port = run_both(c, A, lb, ub, slack_start(c, A, b, lb, ub),
                         seg_len=100, maxiters=3, packed=packed)
    assert_same(ref, port)
    assert (port["status"] == st.RUNNING).all()
    assert (port["iters"] == 3).all()


def test_bounded_segment_leaves_a_finished_lane_untouched():
    c, A, b, lb, ub = bounded_lps(8, 10, 12, seed=6)
    start = list(slack_start(c, A, b, lb, ub))
    start[8][2] = st.OPTIMAL
    ref, port = run_both(c, A, lb, ub, start, seg_len=2, maxiters=500,
                         packed=True)
    assert_same(ref, port)
    for name, before in zip(FIELDS, start):
        np.testing.assert_array_equal(port[name][2].ravel(),
                                      before[2].ravel().astype(
                                          port[name].dtype), err_msg=name)
    assert port["iters"][2] == 0 and (port["iters"][[0, 1, 3]] == 2).all()


def _hand(c, A, b, lb, ub, basis, vstate, **kw):
    arr = lambda v: np.asarray(v, F32)[None]  # noqa: E731
    c, A, b, lb, ub = arr(c), arr(A), arr(b), arr(lb), arr(ub)
    start = packed_start(c, A, b, lb, ub, basis, vstate)
    return run_both(c, A, lb, ub, start, **kw)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_segment_pure_bound_flip(packed):
    """min -x0, x0 + x1 = 5, 0 <= x0 <= 2: x0 crosses to its upper bound
    (gamma3 = 2 <= delta = 5): no basis change, one iteration counted, and
    the next iteration finds the lane optimal."""
    kw = dict(maxiters=10, packed=packed)
    prob = ([-1.0, 0.0], [[1.0, 1.0]], [5.0], [0.0, 0.0], [2.0, np.inf],
            [1], [0.0, 2.0])
    ref, port = _hand(*prob, seg_len=1, **kw)
    assert_same(ref, port)
    assert port["basis"].tolist() == [[1]]
    assert port["vstate"].tolist() == [[bk.AT_UB, bk.BASIC]]
    assert port["bfs"].tolist() == [[3.0]]
    assert port["iters"].tolist() == [1] and port["status"].tolist() == [0]
    ref, port = _hand(*prob, seg_len=5, **kw)
    assert_same(ref, port)
    assert port["iters"].tolist() == [2]
    assert port["status"].tolist() == [st.OPTIMAL]


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_segment_leaving_variable_lands_on_its_upper_bound(packed):
    """min -x0, -x0 + x1 = 1, x0 <= 10, x1 <= 3: x1 rises with x0 and
    leaves at its UPPER bound (gamma2 = 2 < gamma3 = 10)."""
    ref, port = _hand([-1.0, 0.0], [[-1.0, 1.0]], [1.0], [0.0, 0.0],
                      [10.0, 3.0], [1], [0.0, 2.0], seg_len=1, maxiters=10,
                      packed=packed)
    assert_same(ref, port)
    assert port["basis"].tolist() == [[0]]
    assert port["vstate"].tolist() == [[bk.BASIC, bk.AT_UB]]
    assert port["bfs"].tolist() == [[2.0]]
    assert port["ubB"].tolist() == [[10.0]]


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_segment_unbounded_lane(packed):
    """min -x0, x0 - x1 = 1, no finite upper bounds: no finite step of any
    kind exists (delta and gamma3 both infinite)."""
    ref, port = _hand([-1.0, 0.0], [[1.0, -1.0]], [1.0], [0.0, 0.0],
                      [np.inf, np.inf], [0], [2.0, 0.0], seg_len=4,
                      maxiters=10, packed=packed)
    assert_same(ref, port)
    assert port["status"].tolist() == [st.PRIMAL_UNBOUNDED]
    assert port["iters"].tolist() == [1]
    assert port["basis"].tolist() == [[0]]


def test_bounded_segment_negative_zero_room_ties_at_lowest_row():
    """A basic value of -0.0 has a room of +0.0 above its lower bound, as
    XLA's ``maximum(-0.0, 0.0)`` gives in the reference, so the tie at zero
    goes to the lowest row.  PyTorch's ``clamp_min`` keeps -0.0, whose
    packed key (sign bit set) would beat every +0.0."""
    bfs = np.array([0.0, -0.0], F32)
    assert np.signbit(bfs[1])
    ref, port = _hand([-1.0, 0.0, 0.0, 0.0],
                      [[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 1.0]], bfs,
                      [0.0] * 4, [5.0, 5.0, np.inf, np.inf], [2, 3],
                      [0.0, 0.0, 2.0, 2.0], seg_len=1, maxiters=10,
                      packed=True)
    assert_same(ref, port)
    assert port["basis"].tolist() == [[0, 3]]


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_segment_tie_between_the_two_ratio_minima(packed):
    """Row 0 drops to its lower bound and row 1 hits its upper bound at the
    same step length.  Unpacked mode compares the values (``g1 < g2`` is
    false: row 1 leaves to its upper bound); packed mode compares the keys,
    index bits included (row 0's key is the smaller: it leaves to its lower
    bound).  The port follows each."""
    ref, port = _hand([-1.0, 0.0, 0.0],
                      [[1.0, 1.0, 0.0], [-1.0, 0.0, 1.0]], [1.0, 1.0],
                      [0.0] * 3, [10.0, np.inf, 2.0], [1, 2],
                      [0.0, 2.0, 2.0], seg_len=1, maxiters=10, packed=packed)
    assert_same(ref, port)
    if packed:
        assert port["basis"].tolist() == [[0, 2]]
        assert port["vstate"].tolist() == [[bk.BASIC, bk.AT_LB, bk.BASIC]]
    else:
        assert port["basis"].tolist() == [[1, 0]]
        assert port["vstate"].tolist() == [[bk.BASIC, bk.BASIC, bk.AT_UB]]


def test_bounded_segment_wrapper_validates():
    c, A, b, lb, ub = bounded_lps(2, 3, 4, seed=0)
    seg = bounded_packed_from_numpy(slack_start(c, A, b, lb, ub))
    t = torch.tensor
    kw = dict(seg_len=1, opt_tol=OPT_TOL, pivot_tol=PIVOT_TOL)
    with pytest.raises(TypeError, match="vstate"):
        solve_bounded_segment(t(A), t(c), t(lb), t(ub), 5,
                              seg._replace(vstate=seg.vstate.float()), **kw)
    with pytest.raises(ValueError, match="ub has shape"):
        solve_bounded_segment(t(A), t(c), t(lb), t(ub)[:, :3], 5, seg, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        solve_bounded_segment(t(A), t(c), t(lb), t(ub), 5, seg._replace(
            bfs=torch.ones((2, 6))[:, ::2]), **kw)
