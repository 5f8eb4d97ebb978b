"""Kernel 1's split-bf16 pricing and ablation switch in linprog_tpu_torch,
held against the reference (JAX on the CPU, the Pallas kernel in interpret
mode) on the same seeded numpy inputs; the port runs its plain version on
the CPU (the card tests hold the CUDA kernel to it)."""

import dataclasses

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


from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.engine_batched import _pallas_pack  # noqa: E402
from linprog_tpu.engine_batched import run_batched_pallas  # noqa: E402
from linprog_tpu.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)
from linprog_tpu.ops.solve_kernel import solve_segment as jax_solve_segment  # noqa: E402

import linprog_tpu_torch.engine_batched as teb  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.config import SolverConfig  # noqa: E402
from linprog_tpu_torch.convert import (  # noqa: E402
    config_from_reference,
    packed_from_numpy,
    packed_to_numpy,
    simplex_state_from_numpy,
)
from linprog_tpu_torch.ops.solve_kernel import (  # noqa: E402
    bf16_halves,
    solve_segment,
    split_price,
)
from tests.test_torch_solve_segment import _slack_state  # noqa: E402

OPT_TOL, PIVOT_TOL, FEAS_TOL = 1e-6, 1e-7, 1e-6


def _setup(B=6, m=12, n=20, seed=5):
    """``tests/test_split_pricing.py``'s instances: the standard form of
    ``random_inequality_lps`` from the slack basis."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
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


def _port(cs, As, bs, states, allowed, cfg):
    return teb.run_batched(
        torch.tensor(cs), torch.tensor(As), torch.tensor(bs),
        simplex_state_from_numpy(
            {k: np.asarray(v) for k, v in states._asdict().items()}),
        torch.tensor(allowed), 200, cfg)


@pytest.mark.parametrize("pricing", ["dantzig", "bland"])
def test_split_pricing_matches_reference(pricing):
    """``split_pricing=True`` through ``run_batched`` (kernel 1's plain
    version) on ``tests/test_split_pricing.py``'s setup (B = 6, m = 12,
    n = 20, seed 5, segments of 16): the reference's split run's statuses
    (all OPTIMAL), costs within 1e-4 of it and of the port's unsplit run,
    and the split mode really taken (the wrapper's ``split`` argument)."""
    cs, As, bs, states, allowed = _setup()
    jcfg = JaxSolverConfig(pricing=pricing, kernels="pallas",
                           refactor_every=16, split_pricing=True)
    ref = run_batched_pallas(jnp.asarray(cs), jnp.asarray(As),
                             jnp.asarray(bs), states, jnp.asarray(allowed),
                             200, jcfg)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    assert cfg.split_pricing and cfg.kernels == "cuda"
    seen = []
    kernel = teb.solve_segment

    def recording(*a, **k):
        seen.append(k["split"])
        return kernel(*a, **k)

    teb_solve, teb.solve_segment = teb.solve_segment, recording
    try:
        split = _port(cs, As, bs, states, allowed, cfg)
    finally:
        teb.solve_segment = teb_solve
    plain = _port(cs, As, bs, states, allowed,
                  cfg.replace(split_pricing=False))
    assert seen and all(seen)
    np.testing.assert_array_equal(split.status.numpy(),
                                  np.asarray(ref.status))
    assert bool((split.status == st.OPTIMAL).all())
    np.testing.assert_allclose(_cost(cs, split), _cost(cs, ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_cost(cs, split), _cost(cs, plain),
                               rtol=1e-4, atol=1e-4)


def test_split_pricing_is_not_taken_in_dual_mode_or_under_devex():
    """The driver takes split pricing where the reference does: in dual
    mode and under devex it runs unsplit, and the wrapper raises as the
    reference's does when asked for split there."""
    cs, As, bs, states, allowed = _setup()
    seen = []
    kernel = teb.solve_segment

    def recording(*a, **k):
        seen.append(k["split"])
        return kernel(*a, **k)

    teb_solve, teb.solve_segment = teb.solve_segment, recording
    try:
        _port(cs, As, bs, states, allowed,
              SolverConfig(pricing="devex", refactor_every=16,
                           split_pricing=True))
    finally:
        teb.solve_segment = teb_solve
    assert seen and not any(seen)
    c, A, state = _slack_state(2, 4, 4, seed=0, dual=True)
    c_t, apen_t, seg = packed_from_numpy(
        [np.array(a) for a in _pallas_pack(c, A, state,
                                           jnp.ones((8,), bool))])
    At = torch.tensor(np.asarray(A))
    kw = dict(seg_len=4, opt_tol=OPT_TOL, pivot_tol=PIVOT_TOL, split=True)
    with pytest.raises(ValueError, match="split pricing requires"):
        solve_segment(At, c_t, apen_t, 10, seg, pricing=1, dual=True, **kw)
    with pytest.raises(ValueError, match="split pricing requires"):
        solve_segment(At, c_t, apen_t, 10, seg, pricing=2, **kw)
    with pytest.raises(ValueError, match="ablation"):
        solve_segment(At, c_t, apen_t, 10, seg, pricing=1, seg_len=4,
                      opt_tol=OPT_TOL, pivot_tol=PIVOT_TOL, ablate=8)


def test_split_price_equals_the_three_term_formula_in_float64():
    """The plain version's split product equals a float64 evaluation of
    ``(yh Ah + yh Al) + yl Ah`` on the same bf16 halves to 1e-6 relative,
    the halves are the reference's (``astype(bfloat16)``, nearest even), and
    the dropped lo * lo term keeps it within 2^-14 of ``y A``."""
    rng = np.random.default_rng(3)
    y = rng.standard_normal((4, 24)).astype(np.float32)
    A = rng.standard_normal((4, 24, 40)).astype(np.float32)
    yt, At = torch.tensor(y), torch.tensor(A)
    got = split_price(yt, At).numpy()
    yh, yl = (t.double() for t in bf16_halves(yt))
    Ah, Al = (t.double() for t in bf16_halves(At))
    prod = lambda u, M: torch.einsum("bj,bjk->bk", u, M)  # noqa: E731
    want = ((prod(yh, Ah) + prod(yh, Al)) + prod(yl, Ah)).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    ref_h = np.asarray(jnp.asarray(A).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(Ah.numpy(), ref_h)
    np.testing.assert_array_equal(
        Al.numpy(), np.asarray((jnp.asarray(A) - ref_h).astype(jnp.bfloat16)
                               .astype(jnp.float32)))
    exact = np.einsum("bj,bjk->bk", y.astype(np.float64), A.astype(np.float64))
    assert (np.abs(got - exact) <= 2.0 ** -14 * np.abs(A).max()
            * np.abs(y).sum(axis=1, keepdims=True)).all()


def _run_segment_both(split, ablate, pricing=1, packed=True, seg_len=64,
                      seed=3):
    """One segment of the reference's Pallas kernel and of the port's
    plain version from the same packed state."""
    cs, A, state = _slack_state(6, 10, 12, seed=seed, dual=False)
    B, m, n = A.shape
    packed_state = _pallas_pack(cs, A, state, jnp.ones((n,), bool))
    packed_np = [np.array(a) for a in packed_state]
    if split:
        Ah = A.astype(jnp.bfloat16)
        Al = (A - Ah.astype(jnp.float32)).astype(jnp.bfloat16)
        A_in, Ahl = jnp.zeros((B, 1, 128)), jnp.concatenate([Ah, Al], axis=2)
    else:
        A_in, Ahl = A, jnp.zeros((B, 1, 128), jnp.bfloat16)
    kw = dict(seg_len=seg_len, pricing=pricing, opt_tol=OPT_TOL,
              pivot_tol=PIVOT_TOL, feas_tol=FEAS_TOL, stall_limit=2,
              packed=packed)
    ref = jax_solve_segment(
        A_in, jnp.swapaxes(A, 1, 2), Ahl, packed_state[0], packed_state[1],
        jnp.full((1, 1, 1), 64, jnp.int32), *packed_state[2:], split=split,
        ablate=ablate, interpret=True, **kw)
    c_t, apen_t, seg = packed_from_numpy(packed_np)
    out = solve_segment(torch.tensor(np.asarray(A)), c_t, apen_t, 64, seg,
                        split=split, ablate=ablate, **kw)
    port = packed_to_numpy(c_t, apen_t, out)
    return [np.asarray(a) for a in ref], port


@pytest.mark.parametrize("pricing", [0, 1], ids=["bland", "dantzig"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_split_segment_matches_pallas_kernel(pricing, packed):
    """One segment in split mode, stall escalation on: the reference
    kernel's statuses, iterations, bases and penalties, and its factor and
    basic values to 1e-5 of scale."""
    ref, port = _run_segment_both(True, 0, pricing=pricing, packed=packed)
    invBT, bfs, cB, basis, pen, _, iters, status = ref
    np.testing.assert_array_equal(port[9], status)
    np.testing.assert_array_equal(port[8], iters)
    np.testing.assert_array_equal(port[5], basis)
    np.testing.assert_array_equal(port[6], pen)
    for got, want in ((port[2], invBT), (port[3], bfs)):
        B = want.shape[0]
        scale = np.maximum(np.abs(want).reshape(B, -1).max(axis=1), 1.0)
        assert (np.abs(got - want).reshape(B, -1).max(axis=1)
                <= 1e-5 * scale).all()
    assert (port[9] == st.OPTIMAL).all()


@pytest.mark.parametrize("ablate", range(8))
def test_ablation_modes_match_pallas_kernel(ablate):
    """Each ablation mode of the reference kernel (0: none), four
    iterations from the same state: the same bases, penalties, statuses
    and iterations as the reference's mode (what each mode drops is
    dropped in both); at 0 the same state as a call without the switch."""
    ref, port = _run_segment_both(False, ablate, seg_len=4)
    _, _, _, basis, pen, _, iters, status = ref
    np.testing.assert_array_equal(port[9], status)
    np.testing.assert_array_equal(port[8], iters)
    np.testing.assert_array_equal(port[5], basis)
    np.testing.assert_array_equal(port[6], pen)
    if ablate == 0:
        cs, A, state = _slack_state(6, 10, 12, seed=3, dual=False)
        c_t, apen_t, seg = packed_from_numpy([np.array(a) for a in _pallas_pack(
            cs, A, state, jnp.ones((A.shape[2],), bool))])
        out = solve_segment(torch.tensor(np.asarray(A)), c_t, apen_t, 64, seg,
                            seg_len=4, pricing=1, opt_tol=OPT_TOL,
                            pivot_tol=PIVOT_TOL, feas_tol=FEAS_TOL,
                            stall_limit=2, packed=True)
        for a, b in zip(packed_to_numpy(c_t, apen_t, out), port):
            np.testing.assert_array_equal(a, b)
