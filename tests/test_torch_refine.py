"""linprog_tpu_torch's double-word arithmetic (refine.py) and status
mapping against the reference, on the same host inputs.

The dd routines are chains of exact split products and compensated sums,
each step its own eager op, as in the reference; only the within-chunk
partial sums of ``dd_rowmat`` go through a matmul whose order may differ.
So results agree to a few f32 ulps of the result's scale (on this CPU they
agree bit for bit), and the residual routines are accurate to ~eps of the
residual itself, far below eps of the operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Same XLA CPU compile-count workaround as tests/test_solve_kernel.py."""
    jax.clear_caches()
    yield


from linprog_tpu import refine as jrefine  # noqa: E402
from linprog_tpu import status as jstatus  # noqa: E402

from linprog_tpu_torch import refine  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def _inputs(seed=0, B=4, m=20, n=12):
    """m = 20 is not a multiple of the chunk (8), so padding is exercised;
    the residual right-hand sides are the f32-rounded exact products, so
    the residuals are pure rounding (~1e-7 against operands ~10)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, m)).astype(np.float32)
    M = rng.normal(size=(B, m, n)).astype(np.float32)
    x = rng.normal(size=(B, n)).astype(np.float32)
    u = rng.normal(size=(B, m)).astype(np.float32)
    y64, M64, x64 = (a.astype(np.float64) for a in (y, M, x))
    yM = np.einsum("bm,bmn->bn", y64, M64)
    Mx = np.einsum("bmk,bk->bm", M64, x64)
    bv, hb = yM.astype(np.float32), Mx.astype(np.float32)
    return {
        "dd_rowmat": ((y, M), yM),
        "dd_rowmat_dd": ((y, M), yM),
        "dd_residual_rowmat": ((bv, y, M), bv - yM),
        "dd_residual": ((hb, M, x), hb - Mx),
        "dd_matvec": ((M, x), Mx),
        "dd_dot": ((y, u), (y64 * u).sum(axis=1)),
    }


@pytest.mark.parametrize("name", ["dd_rowmat", "dd_rowmat_dd",
                                  "dd_residual_rowmat", "dd_residual",
                                  "dd_matvec", "dd_dot"])
def test_dd_routine_matches_reference(name):
    args, exact = _inputs()[name]
    ref = np.asarray(getattr(jrefine, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(refine, name)(*(torch.tensor(a) for a in args)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=4 * EPS32 * scale)
    err = np.abs(got.astype(np.float64) - exact).max()
    if name.startswith("dd_residual"):
        assert err <= 1e-3 * scale  # residual ~1e-7: error ~1e-10, not ~1e-6
    else:
        assert err <= 4 * EPS32 * scale


def test_refine_duals_and_bfs_match_reference():
    """Refined duals and basic values of a random basis, from a perturbed
    factor (as the engine's drifted eta product would be): both packages
    reach the f64 solution to ~1e-6 relative and agree with each other."""
    rng = np.random.default_rng(3)
    B, m = 4, 16
    Bm = (rng.normal(size=(B, m, m)) + 4 * np.eye(m)).astype(np.float32)
    inv = np.linalg.inv(Bm.astype(np.float64))
    inv_B = (inv * (1 + 1e-4 * rng.normal(size=inv.shape))).astype(np.float32)
    cB = rng.normal(size=(B, m)).astype(np.float32)
    b = rng.normal(size=(B, m)).astype(np.float32)
    xB0 = np.einsum("bmk,bk->bm", inv_B, b).astype(np.float32)
    y_ex = np.einsum("bm,bmk->bk", cB.astype(np.float64), inv)
    x_ex = np.einsum("bmk,bk->bm", inv, b.astype(np.float64))

    y = refine.refine_duals(torch.tensor(cB), torch.tensor(Bm),
                            torch.tensor(inv_B)).numpy()
    jy = np.asarray(jrefine.refine_duals(jnp.asarray(cB), jnp.asarray(Bm),
                                         jnp.asarray(inv_B)))
    x = refine.refine_bfs(torch.tensor(Bm), torch.tensor(b),
                          torch.tensor(inv_B), torch.tensor(xB0)).numpy()
    jx = np.asarray(jrefine.refine_bfs(jnp.asarray(Bm), jnp.asarray(b),
                                       jnp.asarray(inv_B), jnp.asarray(xB0)))
    for got, ref, exact in ((y, jy, y_ex), (x, jx, x_ex)):
        scale = np.abs(exact).max()
        assert np.abs(got - exact).max() <= 1e-6 * scale
        assert np.abs(got - ref).max() <= 1e-6 * scale


@pytest.mark.parametrize("code", sorted(st.STATUS_NAMES))
def test_raise_for_status_matches_reference(code):
    """Each status code maps to the same exception class (by name) as in
    the reference, or to none."""
    assert st.status_name(code) == jstatus.STATUS_NAMES[code]

    def outcome(fn):
        try:
            return fn(code)
        except Exception as exc:  # the mapped exception is the outcome
            return type(exc).__name__

    assert outcome(st.raise_for_status) == outcome(jstatus.raise_for_status)


def test_solve_dd_is_accurate_where_a_plain_f32_solve_is_not():
    """On systems with cond ~1e4 a plain f32 solve through the inverse is
    off by ~1e-4 relative (cond x eps), past the certificate's 1e-5; one
    dd-refinement round past the whole-segment regime brings it to ~1e-6
    of the float64 answer.  Inside the regime it is the plain solve."""
    from linprog_tpu_torch import calibration

    assert refine.dd_steps(512) == 0 and refine.dd_steps(513) == 1
    rng = np.random.default_rng(3)
    B, m = 4, 64
    Q1, _ = np.linalg.qr(rng.normal(size=(B, m, m)))
    Q2, _ = np.linalg.qr(rng.normal(size=(B, m, m)))
    M = ((Q1 * np.logspace(0, -4, m)[None, None, :]) @ Q2).astype(np.float32)
    rhs = rng.normal(size=(B, m)).astype(np.float32)
    want = np.linalg.solve(M.astype(np.float64),
                           rhs.astype(np.float64)[..., None])[..., 0]
    Mt, rt = torch.tensor(M), torch.tensor(rhs)
    inv = torch.linalg.inv(Mt)
    plain = torch.einsum("bmk,bk->bm", inv, rt).numpy()
    np.testing.assert_array_equal(refine.solve_dd(Mt, rt, inv).numpy(), plain)
    table = calibration.get_table()
    table["xover_pallas_max_m"] = 8  # m = 64 is now past the boundary
    calibration.set_table({"default": table})
    try:
        dd = refine.solve_dd(Mt, rt).numpy()
        dd_inv = refine.solve_dd(Mt, rt, inv).numpy()
    finally:
        calibration.reset_table()

    def rel(x):
        return (np.abs(x - want).max(axis=1) / np.abs(want).max(axis=1)).max()

    assert rel(plain) > 1e-5
    assert rel(dd) < 1e-6 and rel(dd_inv) < 1e-6
