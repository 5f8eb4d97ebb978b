"""linprog_tpu_torch's standard-form IPM and warm-started IPM re-solve
against the reference's, on the same host instances.

float64 (``IPMConfig(eps_rel=1e-7, maxiters=60, dtype="float64")``, the
reference tests' setting): the same status and the same Newton-step count
per lane, ``x`` and ``y`` within 1e-8 relative of the lane's scale, for
``ipm_solve_batch_standard`` (the explicit operator ``_DenseOp``), for
``ipm_solve_batch_canonical(return_state=True)`` and for
``reoptimize_ipm_batch_canonical`` from the REFERENCE's terminal state
carried across by ``convert.ipm_state_from_numpy``.  ``warm_start_point`` in
f32: within 1e-6 relative.  A warm start takes fewer Newton steps than a
cold one on average (tests/test_ipm.py's bar) and lands on HiGHS's optimum
(1e-6).
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


from linprog_tpu.ipm import IPMConfig as JaxIPMConfig  # noqa: E402
from linprog_tpu.ipm import IPMState as JaxIPMState  # noqa: E402
from linprog_tpu.ipm import ipm_solve_batch_canonical as jax_canonical  # noqa: E402
from linprog_tpu.ipm import ipm_solve_batch_standard as jax_standard  # noqa: E402
from linprog_tpu.ipm import reoptimize_ipm_batch_canonical as jax_reoptimize  # noqa: E402
from linprog_tpu.ipm import warm_start_point as jax_warm_start_point  # noqa: E402

import linprog_tpu_torch.ipm as tipm  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import (  # noqa: E402
    config_from_reference,
    ipm_state_from_numpy,
    ipm_state_to_numpy,
)
from linprog_tpu_torch.generators import random_inequality_lps  # noqa: E402
from linprog_tpu_torch.ipm import (  # noqa: E402
    IPMState,
    ipm_solve_batch_canonical,
    ipm_solve_batch_standard,
    ipm_state_to_result,
    reoptimize_ipm_batch_canonical,
    warm_start_point,
)
from linprog_tpu_torch.ops import cholinv_kernel  # noqa: E402

JCFG = JaxIPMConfig(eps_rel=1e-7, maxiters=60, dtype="float64")
CFG = config_from_reference(dataclasses.asdict(JCFG))
B, M, N = 8, 24, 24


def _t64(*arrays):
    return tuple(torch.tensor(a, dtype=torch.float64) for a in arrays)


def _close(got, want, tol):
    """Within ``tol`` of the lane's scale max(1, max|want|)."""
    want = np.asarray(want)
    scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    assert (np.abs(got - want) / scale).max() <= tol


def _same_state(state, ref, tol=1e-8):
    got = ipm_state_to_numpy(state)
    np.testing.assert_array_equal(got["status"], np.asarray(ref.status))
    np.testing.assert_array_equal(got["iters"], np.asarray(ref.iters))
    for k in ("x", "y", "s"):
        _close(got[k], getattr(ref, k), tol)


@pytest.fixture(scope="module")
def instance():
    return random_inequality_lps(B, M, N, seed=13, dtype=np.float64)


@pytest.fixture(scope="module")
def perturbed(instance):
    c, G, h = instance
    rng = np.random.default_rng(0)
    return h * (1.0 + 0.05 * rng.standard_normal(h.shape))


@pytest.fixture(scope="module")
def reference_base(instance):
    c, G, h = instance
    return jax_canonical(jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), JCFG,
                         return_state=True)


def test_standard_form_ipm_matches_reference(instance):
    """The explicit operator on [G | I]: equal to the reference's, and to
    the port's own implicit-slack path on the same problem."""
    c, G, h = instance
    A = np.concatenate([G, np.broadcast_to(np.eye(M), (B, M, M))], axis=2)
    cs = np.concatenate([c, np.zeros((B, M))], axis=1)
    ref = jax_standard(jnp.asarray(cs), jnp.asarray(A), jnp.asarray(h), JCFG)
    state = ipm_solve_batch_standard(*_t64(cs, A, h), CFG)
    assert isinstance(state, IPMState) and state.x.dtype == torch.float64
    _same_state(state, ref)
    assert (state.status == st.OPTIMAL).all()
    res = ipm_state_to_result(torch.tensor(cs), state)
    assert (res.basis == -1).all() and res.x.shape == (B, N + M)
    _, cstate = ipm_solve_batch_canonical(*_t64(c, G, h), CFG,
                                          return_state=True)
    np.testing.assert_array_equal(cstate.iters.numpy(), state.iters.numpy())
    _close(cstate.x.numpy(), state.x.numpy(), 1e-8)


def test_standard_form_ipm_needs_no_sign_fix(instance):
    """Rows with b < 0 go through unflipped: the reference's answer within
    1e-8, and the duals of the negated rows are the negated duals of the
    original problem (they stay in the caller's row space)."""
    c, G, h = instance
    A = np.concatenate([G, np.broadcast_to(np.eye(M), (B, M, M))], axis=2)
    cs = np.concatenate([c, np.zeros((B, M))], axis=1)
    plain = ipm_solve_batch_standard(*_t64(cs, A, h), CFG)
    sign = np.where(np.arange(M) < 5, -1.0, 1.0)
    A2, h2 = A * sign[None, :, None], h * sign
    assert (h2 < 0).any()
    ref = jax_standard(jnp.asarray(cs), jnp.asarray(A2), jnp.asarray(h2), JCFG)
    state = ipm_solve_batch_standard(*_t64(cs, A2, h2), CFG)
    _same_state(state, ref)
    assert (state.status == st.OPTIMAL).all()
    _close(state.y.numpy() * sign, plain.y.numpy(), 1e-8)
    _close(state.x.numpy(), plain.x.numpy(), 1e-8)


def test_standard_form_ipm_certificates():
    """An infeasible and an unbounded lane get the reference's statuses
    (Farkas vector in y, improving ray in x)."""
    # lane 0: x1 + x2 = -1, x >= 0 (infeasible); lane 1: min -x1 - x2 s.t.
    # x1 - x2 = 0 (unbounded); lane 2: min x1 + x2 s.t. x1 + x2 = 1
    A = np.array([[[1.0, 1.0]], [[1.0, -1.0]], [[1.0, 1.0]]])
    b = np.array([[-1.0], [0.0], [1.0]])
    c = np.array([[0.0, 0.0], [-1.0, -1.0], [1.0, 1.0]])
    ref = jax_standard(jnp.asarray(c), jnp.asarray(A), jnp.asarray(b), JCFG)
    state = ipm_solve_batch_standard(*_t64(c, A, b), CFG)
    np.testing.assert_array_equal(state.status.numpy(), np.asarray(ref.status))
    assert state.status.tolist() == [st.PRIMAL_INFEASIBLE,
                                     st.PRIMAL_UNBOUNDED, st.OPTIMAL]
    _close(state.y.numpy()[0], np.asarray(ref.y)[0], 1e-6)
    _close(state.x.numpy()[1], np.asarray(ref.x)[1], 1e-6)


def test_return_state_matches_reference(instance, reference_base):
    c, G, h = instance
    jres, jstate = reference_base
    res, state = ipm_solve_batch_canonical(*_t64(c, G, h), CFG,
                                           return_state=True)
    _same_state(state, jstate)
    _close(res.cost.numpy()[:, None], np.asarray(jres.cost)[:, None], 1e-8)
    assert (res.status == st.OPTIMAL).all()


def test_warm_resolve_matches_reference(instance, perturbed, reference_base):
    """From the reference's terminal state, carried across with its ``s``:
    the same Newton-step counts, x and y within 1e-8; chained once more
    from each package's own warm state."""
    c, G, _ = instance
    _, jstate = reference_base
    jwarm, jwstate = jax_reoptimize(jnp.asarray(c), jnp.asarray(G),
                                    jnp.asarray(perturbed), jstate, JCFG,
                                    return_state=True)
    prev = ipm_state_from_numpy(jstate._asdict(), dtype=torch.float64)
    np.testing.assert_array_equal(prev.s.numpy(), np.asarray(jstate.s))
    warm, wstate = reoptimize_ipm_batch_canonical(
        *_t64(c, G, perturbed), prev, CFG, return_state=True)
    _same_state(wstate, jwstate)
    assert (warm.status == st.OPTIMAL).all()
    _close(warm.cost.numpy()[:, None], np.asarray(jwarm.cost)[:, None], 1e-8)

    h3 = perturbed * 1.02
    jwarm2 = jax_reoptimize(jnp.asarray(c), jnp.asarray(G), jnp.asarray(h3),
                            jwstate, JCFG)
    warm2 = reoptimize_ipm_batch_canonical(*_t64(c, G, h3), wstate, CFG)
    np.testing.assert_array_equal(warm2.status.numpy(),
                                  np.asarray(jwarm2.status))
    np.testing.assert_array_equal(warm2.iters.numpy(), np.asarray(jwarm2.iters))
    _close(warm2.x.numpy(), np.asarray(jwarm2.x), 1e-8)


def test_warm_start_cuts_newton_steps(instance, perturbed):
    """The port alone: warm takes fewer steps than cold on average and no
    lane more than one step more; warm costs match HiGHS to 1e-6."""
    c, G, h = instance
    _, state = ipm_solve_batch_canonical(*_t64(c, G, h), CFG,
                                         return_state=True)
    warm = reoptimize_ipm_batch_canonical(*_t64(c, G, perturbed), state, CFG)
    cold = ipm_solve_batch_canonical(*_t64(c, G, perturbed), CFG)
    assert (warm.status == st.OPTIMAL).all()
    wi, ci = warm.iters.double(), cold.iters.double()
    assert wi.mean() < ci.mean(), (wi, ci)
    assert (wi <= ci + 1).all()
    for i in range(B):
        hi = scipy_linprog(c[i], A_ub=G[i], b_ub=perturbed[i],
                           method="highs")
        assert hi.status == 0
        assert float(warm.cost[i]) == pytest.approx(hi.fun, rel=1e-6, abs=1e-6)


def test_warm_start_skips_the_starting_point(instance, perturbed, monkeypatch):
    c, G, h = instance
    _, state = ipm_solve_batch_canonical(*_t64(c, G, h), CFG,
                                         return_state=True)

    def no_starting_point(*args):
        raise AssertionError("a warm start must not factor a starting point")

    monkeypatch.setattr(tipm, "_starting_point", no_starting_point)
    warm = reoptimize_ipm_batch_canonical(*_t64(c, G, perturbed), state, CFG)
    assert (warm.status == st.OPTIMAL).all()
    with pytest.raises(AssertionError, match="warm start"):
        ipm_solve_batch_canonical(*_t64(c, G, perturbed), CFG)


@pytest.mark.parametrize("warm_frac", [1e-2, 1e-1])
def test_warm_start_point_matches_reference(warm_frac):
    """f32, within 1e-6 relative; small entries move to the mu0 shell, large
    ones and y stay."""
    rng = np.random.default_rng(5)
    x = rng.random((6, 20)).astype(np.float32) ** 8
    s = rng.random((6, 20)).astype(np.float32) ** 8
    x[0, :3] = 0.0
    s[1] = 0.0  # mean below the 1e-8 floor
    y = rng.normal(size=(6, 7)).astype(np.float32)
    zeros = np.zeros(6, np.int32)
    ref = jax_warm_start_point(
        JaxIPMState(x=jnp.asarray(x), y=jnp.asarray(y), s=jnp.asarray(s),
                    iters=jnp.asarray(zeros), status=jnp.asarray(zeros)),
        warm_frac)
    got = warm_start_point(
        ipm_state_from_numpy(dict(x=x, y=y, s=s, iters=zeros, status=zeros)),
        warm_frac)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0.0)
    assert (got[0] > 0).all() and (got[2] > 0).all()
    np.testing.assert_array_equal(got[1].numpy(), y)
    big = x > 0.5
    np.testing.assert_array_equal(got[0].numpy()[big], x[big])


def test_f32_standard_and_warm_paths_take_the_panel_kernel(monkeypatch):
    """In f32 the normal factor of both new paths goes through
    ``panel_cholinv`` (its plain version here: the tensors are on the CPU,
    and the launch counter does not move)."""
    calls = []
    real = tipm.panel_cholinv

    def counting(M):
        calls.append(tuple(M.shape))
        return real(M)

    monkeypatch.setattr(tipm, "panel_cholinv", counting)
    c, G, h = (torch.tensor(a) for a in random_inequality_lps(4, 16, 16, seed=1))
    before = cholinv_kernel.launches
    res, state = ipm_solve_batch_canonical(c, G, h, return_state=True)
    n_cold = len(calls)
    assert n_cold > 0 and set(calls) == {(4, 16, 16)}
    reoptimize_ipm_batch_canonical(c, G, h * 1.02, state)
    n_warm = len(calls) - n_cold
    assert 0 < n_warm < n_cold  # fewer factorizations than the cold solve
    A = torch.cat([G, torch.eye(16).expand(4, 16, 16)], dim=2)
    cs = torch.cat([c, torch.zeros(4, 16)], dim=1)
    std = ipm_solve_batch_standard(cs, A, h)
    assert len(calls) > n_cold + n_warm
    np.testing.assert_array_equal(std.status.numpy(), res.status.numpy())
    assert cholinv_kernel.launches == before
