"""linprog_tpu_torch's Ruiz equilibration and the scaled two-phase solve
against the reference's, on the same host instances.

``ruiz_equilibrate``: scales, scaled matrix and vectors within 1e-6
relative of the reference's (the same elementwise operations in f32; only
``sqrt`` and the reciprocal may differ in the last bit).  The scaled
two-phase pipeline (``SolverConfig(scaling=True)``; the reference on its
Pallas kernel in interpret mode, the port on its kernel's plain version):
the same status per lane and costs within 1e-5 relative of the reference's;
on the badly scaled instance of tests/test_presolve.py both packages stay
within 5e-3 of HiGHS on the undistorted problem (the reference test's own
bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog as scipy_linprog


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Same XLA CPU compile-count workaround as tests/test_solve_kernel.py."""
    jax.clear_caches()
    yield
    jax.clear_caches()


from linprog_tpu.batch import solve_batch_two_phase as jax_two_phase  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.presolve import ruiz_equilibrate as jax_ruiz  # noqa: E402
from linprog_tpu.presolve import unscale_duals as jax_unscale_duals  # noqa: E402
from linprog_tpu.presolve import unscale_solution as jax_unscale_solution  # noqa: E402

from linprog_tpu_torch import SolverConfig, solve_batch_two_phase  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from linprog_tpu_torch.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)
from linprog_tpu_torch.presolve import (  # noqa: E402
    Scaling,
    ruiz_equilibrate,
    unscale_duals,
    unscale_solution,
)

JCFG = JaxSolverConfig(pricing="dantzig", kernels="pallas", scaling=True)


def _rel(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


def _badly_scaled(batched):
    rng = np.random.default_rng(0)
    shape = (3, 8, 12) if batched else (8, 12)
    A = rng.normal(size=shape)
    A *= 10.0 ** rng.uniform(-3, 3, size=shape[:-1] + (1,))
    A *= 10.0 ** rng.uniform(-3, 3, size=shape[:-2] + (1, shape[-1]))
    c = rng.normal(size=shape[:-2] + shape[-1:])
    b = rng.normal(size=shape[:-1])
    return tuple(a.astype(np.float32) for a in (c, A, b))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("iters", [6, 10])
def test_ruiz_equilibrate_matches_reference(batched, iters):
    c, A, b = _badly_scaled(batched)
    ref = jax_ruiz(c, A, b, iters=iters)
    got = ruiz_equilibrate(torch.tensor(c), torch.tensor(A), torch.tensor(b),
                           iters=iters)
    for g, r in zip(got[:3] + tuple(got[3]), ref[:3] + tuple(ref[3])):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=0.0)
    A_s, sc = got[1].numpy(), got[3]
    if iters == 10:  # row and column inf-norms near 1
        assert np.allclose(np.abs(A_s).max(axis=-1), 1.0, atol=0.1)
        assert np.allclose(np.abs(A_s).max(axis=-2), 1.0, atol=0.1)
    # the scaling is exactly diag(r) A diag(s)
    recon = sc.row.numpy()[..., :, None] * A * sc.col.numpy()[..., None, :]
    np.testing.assert_allclose(A_s, recon, rtol=1e-5)


def test_unscale_matches_reference():
    rng = np.random.default_rng(1)
    x, y = rng.random((3, 5)).astype(np.float32), rng.random((3, 4)).astype(np.float32)
    row, col = rng.random((3, 4)).astype(np.float32), rng.random((3, 5)).astype(np.float32)
    sc = Scaling(row=torch.tensor(row), col=torch.tensor(col))

    class JSc:
        pass

    jsc = JSc()
    jsc.row, jsc.col = jnp.asarray(row), jnp.asarray(col)
    np.testing.assert_array_equal(unscale_solution(torch.tensor(x), sc).numpy(),
                                  np.asarray(jax_unscale_solution(jnp.asarray(x), jsc)))
    np.testing.assert_array_equal(unscale_duals(torch.tensor(y), sc).numpy(),
                                  np.asarray(jax_unscale_duals(jnp.asarray(y), jsc)))


def test_config_from_reference_carries_scaling():
    cfg = config_from_reference(dataclasses.asdict(JCFG))
    assert cfg == SolverConfig(pricing="dantzig", scaling=True)
    assert not SolverConfig().scaling


@pytest.mark.parametrize("polish", [0, 4])
def test_scaled_two_phase_matches_reference(polish):
    """Statuses equal, costs within 1e-5 relative, strong duality in the
    original scaling (|b'y - cost| <= 2e-3, the reference test's bar)."""
    c, G, h = random_inequality_lps(8, 10, 14, seed=4)
    cs, As, bs = to_standard_form_batch(c, G, h)
    jcfg = JCFG.replace(polish_pivots=polish)
    ref = jax_two_phase(jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs),
                        300, 300, jcfg)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    res = solve_batch_two_phase(torch.tensor(cs), torch.tensor(As),
                                torch.tensor(bs), 300, 300, cfg)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert (res.status.numpy() == st.OPTIMAL).all()
    assert _rel(res.cost.numpy(), np.asarray(ref.cost)).max() < 1e-5
    assert res.x.shape == (8, cs.shape[1]) and res.y.shape == (8, 10)
    assert np.abs((bs * res.y.numpy()).sum(axis=1) - res.cost.numpy()).max() < 2e-3
    # the same optimum as without scaling
    plain = solve_batch_two_phase(torch.tensor(cs), torch.tensor(As),
                                  torch.tensor(bs), 300, 300,
                                  cfg.replace(scaling=False))
    assert _rel(res.cost.numpy(), plain.cost.numpy()).max() < 2e-4


def test_scaling_rescues_badly_scaled_instances():
    """Rows distorted by factors up to 1e4: with scaling both packages stay
    OPTIMAL on every lane and within 5e-3 of HiGHS on the undistorted
    problem, and agree with each other to 1e-5 relative."""
    rng = np.random.default_rng(7)
    B, m, n = 4, 10, 14
    c, G, h = random_inequality_lps(B, m, n, seed=7, dtype=np.float64)
    row_f = 10.0 ** rng.uniform(0, 4, size=(B, m))
    G2, h2 = G * row_f[:, :, None], h * row_f
    cs, As, bs = to_standard_form_batch(
        c.astype(np.float32), G2.astype(np.float32), h2.astype(np.float32))
    ref = jax_two_phase(jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs),
                        500, 500, JCFG)
    res = solve_batch_two_phase(torch.tensor(cs), torch.tensor(As),
                                torch.tensor(bs), 500, 500,
                                config_from_reference(dataclasses.asdict(JCFG)))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert (res.status.numpy() == st.OPTIMAL).all()
    assert _rel(res.cost.numpy(), np.asarray(ref.cost)).max() < 1e-5
    for i in range(B):
        hi = scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                           method="highs")
        assert hi.status == 0
        assert abs(float(res.cost[i]) - hi.fun) / max(1.0, abs(hi.fun)) < 5e-3
