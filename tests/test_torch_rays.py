"""linprog_tpu_torch's certificates for unbounded and infeasible lanes
against the reference's: improving rays (``unbounded_rays``,
``unbounded_rays_from_result``) and the Farkas vector that
``solve_batch_two_phase`` leaves in ``y``.

Hand-built lanes and random instances made unbounded by one column, the
same numpy arrays through both packages (the reference on
``kernels="pallas"`` in interpret mode, the port on its plain versions):
the same status per lane, rays and Farkas vectors within 1e-6 of the
reference's, and each certificate against its defining inequalities
(``A d = 0, d >= 0, c'd < 0``; ``y'A <= 0, y'b > 0``) to 1e-5.
"""

import dataclasses

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
    jax.clear_caches()


from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.batch import solve_batch_two_phase as jax_two_phase  # noqa: E402
from linprog_tpu.batch import unbounded_rays as jax_rays  # noqa: E402
from linprog_tpu.batch import unbounded_rays_from_result as jax_rays_from_result  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402

from linprog_tpu_torch import engine, solve_batch_two_phase  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.batch import (  # noqa: E402
    batch_summary,
    unbounded_rays,
    unbounded_rays_from_result,
)
from linprog_tpu_torch.convert import (  # noqa: E402
    batch_result_from_numpy,
    config_from_reference,
)
from linprog_tpu_torch.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)

JCFG = JaxSolverConfig(kernels="pallas", pricing="dantzig")
CFG = config_from_reference(dataclasses.asdict(JCFG))

# lane 0: min -x1 - x2, x1 - x2 = 1, x3 = 1: unbounded along (1, 1, 0)
# lane 1: -x1 - x2 = 1: infeasible, Farkas vector (1, 0)
# lane 2: min x1 + 2 x2, x1 + x2 = 1, x3 = 1: optimal at (1, 0, 1)
HAND_A = np.array([[[1.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
                   [[-1.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
                   [[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)
HAND_B = np.ones((3, 2), np.float32)
HAND_C = np.array([[-1.0, -1.0, 0.0], [0.0, 0.0, 0.0], [1.0, 2.0, 0.0]],
                  np.float32)


def _solve_both(c, A, b, iters=200):
    ref = jax_two_phase(jnp.asarray(c), jnp.asarray(A), jnp.asarray(b),
                        iters, iters, JCFG)
    res = solve_batch_two_phase(torch.tensor(c), torch.tensor(A),
                                torch.tensor(b), iters, iters, CFG)
    return ref, res


def _check_ray(c, A, d, tol=1e-5):
    assert (d >= 0).all()
    assert np.abs(A @ d).max() <= tol * max(1.0, np.abs(d).max())
    assert float(c @ d) < -tol


def test_hand_built_lanes_rays_and_farkas_vectors():
    ref, res = _solve_both(HAND_C, HAND_A, HAND_B)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert res.status.tolist() == [st.PRIMAL_UNBOUNDED, st.PRIMAL_INFEASIBLE,
                                   st.OPTIMAL]
    summ = batch_summary(res)
    assert (summ["unbounded"], summ["infeasible"], summ["optimal"]) == (1, 1, 1)

    jrays = np.asarray(jax_rays_from_result(jnp.asarray(HAND_C),
                                            jnp.asarray(HAND_A), ref, JCFG))
    rays = unbounded_rays_from_result(torch.tensor(HAND_C),
                                      torch.tensor(HAND_A), res, CFG).numpy()
    assert rays.shape == (3, 3)
    assert np.abs(rays - jrays).max() <= 1e-6
    _check_ray(HAND_C[0], HAND_A[0], rays[0])
    np.testing.assert_array_equal(rays[0], [1.0, 1.0, 0.0])
    assert not rays[1:].any()  # zero where the lane is not unbounded

    y, jy = res.y.numpy(), np.asarray(ref.y)
    assert np.abs(y[1] - jy[1]).max() <= 1e-6
    assert (y[1] @ HAND_A[1] <= 1e-5).all() and y[1] @ HAND_B[1] > 1e-5
    assert np.abs(y[2] - jy[2]).max() <= 1e-6  # the optimal lane's duals
    assert abs(y[2] @ HAND_B[2] - float(res.cost[2])) <= 1e-6


def test_rays_on_the_reference_result_match():
    """The port's ray function on the REFERENCE's terminal bases (carried
    across with ``batch_result_from_numpy``) gives the reference's rays."""
    ref, _ = _solve_both(HAND_C, HAND_A, HAND_B)
    carried = batch_result_from_numpy(ref._asdict())
    rays = unbounded_rays_from_result(torch.tensor(HAND_C),
                                      torch.tensor(HAND_A), carried, CFG)
    jrays = jax_rays_from_result(jnp.asarray(HAND_C), jnp.asarray(HAND_A),
                                 ref, JCFG)
    assert np.abs(rays.numpy() - np.asarray(jrays)).max() <= 1e-6


def _unbounded_instances(B=6, m=8, n=10, seed=5):
    """Random feasible LPs; on the even lanes column 0 never increases a
    row and has a negative cost, so x_0 can grow for ever."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    G[::2, :, 0] = -np.abs(G[::2, :, 0])
    c[::2, 0] = -1.0
    return to_standard_form_batch(c, G, h)


def test_random_unbounded_lanes_match_reference():
    cs, As, bs = _unbounded_instances()
    ref, res = _solve_both(cs, As, bs, iters=300)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    status = res.status.numpy()
    assert (status[::2] == st.PRIMAL_UNBOUNDED).all()
    assert (status[1::2] == st.OPTIMAL).all()
    jrays = np.asarray(jax_rays_from_result(jnp.asarray(cs), jnp.asarray(As),
                                            ref, JCFG))
    rays = unbounded_rays_from_result(torch.tensor(cs), torch.tensor(As), res,
                                      CFG).numpy()
    scale = np.maximum(1.0, np.abs(jrays).max(axis=1, keepdims=True))
    assert (np.abs(rays - jrays) / scale).max() <= 1e-6
    for i in range(0, 6, 2):
        _check_ray(cs[i], As[i], rays[i])
    assert not rays[1::2].any()


def test_unbounded_rays_on_engine_states():
    """``unbounded_rays`` on explicit states (the arrays an engine ran on),
    with and without ``allowed``: equal to the reference's per lane."""
    cs, As, bs = _unbounded_instances(B=4, m=6, n=7, seed=9)
    _, res = _solve_both(cs, As, bs, iters=300)
    B, m, n = As.shape
    A1 = np.concatenate([As, np.broadcast_to(np.eye(m, dtype=np.float32),
                                             (B, m, m))], axis=2)
    c2 = np.concatenate([cs, np.zeros((B, m), np.float32)], axis=1)
    basis = res.basis.numpy()
    zeros = np.zeros((B, m), np.float32)
    jstates = jax.vmap(jengine.make_state)(jnp.asarray(A1), jnp.asarray(zeros),
                                           jnp.asarray(basis))
    jstates = jstates._replace(status=jnp.asarray(res.status.numpy()))
    states = engine.make_state(torch.tensor(A1), torch.tensor(zeros),
                               torch.tensor(basis))
    states = states._replace(status=res.status)
    for allowed in (None, np.arange(n + m) < n):
        jr = jax_rays(jnp.asarray(c2), jnp.asarray(A1), jstates, JCFG,
                      allowed=None if allowed is None else jnp.asarray(allowed))
        r = unbounded_rays(torch.tensor(c2), torch.tensor(A1), states, CFG,
                           allowed=None if allowed is None
                           else torch.tensor(allowed))
        assert r.shape == (B, n + m)
        scale = np.maximum(1.0, np.abs(np.asarray(jr)).max(axis=1,
                                                           keepdims=True))
        assert (np.abs(r.numpy() - np.asarray(jr)) / scale).max() <= 1e-6
    assert r[::2].abs().sum() > 0 and not r[1::2].any()
    assert not r[:, n:].any()  # no ray coordinate on an artificial column


def test_infeasible_random_lanes_carry_farkas_vectors():
    """Rows x_0 + s = 1 and -x_0 + s' = -2 (flipped to x_0 - s' = 2 by the
    standard form) contradict each other: PRIMAL_INFEASIBLE with a Farkas
    vector, equal to the reference's within 1e-6."""
    c, G, h = random_inequality_lps(4, 6, 6, seed=2)
    G[:2, 0], G[:2, 1] = 0.0, 0.0
    G[:2, 0, 0], h[:2, 0] = 1.0, 1.0
    G[:2, 1, 0], h[:2, 1] = -1.0, -2.0
    cs, As, bs = to_standard_form_batch(c, G, h)
    ref, res = _solve_both(cs, As, bs, iters=300)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert res.status.tolist()[:2] == [st.PRIMAL_INFEASIBLE] * 2
    assert (res.status[2:] == st.OPTIMAL).all()
    y, jy = res.y.numpy(), np.asarray(ref.y)
    for i in range(2):
        assert np.abs(y[i] - jy[i]).max() <= 1e-6
        assert (y[i] @ As[i] <= 1e-5).all() and y[i] @ bs[i] > 1e-5
