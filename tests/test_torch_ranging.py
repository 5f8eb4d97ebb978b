"""linprog_tpu_torch's sensitivity ranging (``ranging``, ``ranging_batch``,
the solver classes' ``ranging()``) against the reference's, in float64,
from the same state (the reference's carried across with
``convert.simplex_state_from_numpy``): every interval to 1e-9, infinite
endpoints equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Clear JAX's caches around a module that compiles many programs
    (same workaround as tests/test_solve_kernel.py)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


import linprog_tpu as jlt  # noqa: E402
from linprog_tpu import engine as jengine  # noqa: E402
from linprog_tpu.batch import solve_batch_two_phase  # noqa: E402
from linprog_tpu.ranging import ranging as jax_ranging  # noqa: E402
from linprog_tpu.ranging import (  # noqa: E402
    ranging_batch as jax_ranging_batch,
)

import linprog_tpu_torch as lt  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import simplex_state_from_numpy  # noqa: E402
from linprog_tpu_torch.generators import (  # noqa: E402
    random_inequality_lps,
    to_standard_form_batch,
)
from tests.problems import PRIMAL_PROBLEMS  # noqa: E402


def optimal_states(B, m, n, seed):
    """Standard-form float64 lanes, solved by the reference; its batched
    state at the optimal bases (host arrays) and the problem."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed, dtype=np.float64)
    cs, As, bs = to_standard_form_batch(c, G, h)
    res = solve_batch_two_phase(cs, As, bs, 200, 200)
    assert (np.asarray(res.status) == st.OPTIMAL).all()
    states = jax.vmap(jengine.make_state)(jnp.asarray(As), jnp.asarray(bs),
                                          jnp.asarray(res.basis))
    return (cs, As, bs), states


def same_intervals(got, want, tol=1e-9):
    """Each field equal within ``tol`` of ``max(1, |want|)``; infinite
    endpoints at the same places with the same sign."""
    for name, g, w in zip(want._fields, got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, name)
        np.testing.assert_array_equal(g[~fin], w[~fin], name)
        err = np.abs(g[fin] - w[fin]) / np.maximum(np.abs(w[fin]), 1.0)
        assert (err <= tol).all(), (name, err.max())


@pytest.mark.parametrize("seed", [3, 5])
def test_ranging_single_matches_reference_float64(seed):
    (cs, As, bs), states = optimal_states(1, 6, 8, seed)
    one = jax.tree.map(lambda t: t[0], states)
    want = jax_ranging(jnp.asarray(cs[0]), jnp.asarray(As[0]),
                       jnp.asarray(bs[0]), one)
    state = simplex_state_from_numpy(
        {k: np.asarray(v) for k, v in one._asdict().items()},
        dtype=torch.float64)
    assert state.inv_B.dtype == torch.float64 and state.basis.dim() == 1
    got = lt.ranging(torch.tensor(cs[0]), torch.tensor(As[0]),
                     torch.tensor(bs[0]), state)
    same_intervals(got, want)
    c, b = cs[0], bs[0]
    assert (got.cost_lo.numpy() <= c + 1e-9).all()
    assert (c <= got.cost_hi.numpy() + 1e-9).all()
    assert (got.rhs_lo.numpy() <= b + 1e-9).all()
    assert np.isfinite(got.cost_lo.numpy()).sum() >= 3


def test_ranging_batch_matches_reference_float64():
    (cs, As, bs), states = optimal_states(6, 6, 8, seed=9)
    want = jax_ranging_batch(jnp.asarray(cs), jnp.asarray(As),
                             jnp.asarray(bs), states)
    port_states = simplex_state_from_numpy(
        {k: np.asarray(v) for k, v in states._asdict().items()},
        dtype=torch.float64)
    got = lt.ranging_batch(torch.tensor(cs), torch.tensor(As),
                           torch.tensor(bs), port_states)
    same_intervals(got, want)
    # the batch is the single-instance ranging lane by lane (to rounding)
    for i in range(6):
        one = lt.ranging(torch.tensor(cs[i]), torch.tensor(As[i]),
                         torch.tensor(bs[i]),
                         type(port_states)(*(t[i] for t in port_states)))
        same_intervals(one, type(want)(*(np.asarray(f[i]) for f in want)),
                       tol=1e-12)


def test_ranging_from_states_the_port_builds():
    """The port's own ``make_state`` at the reference's optimal bases gives
    the same intervals to 1e-9 (an independent float64 inversion)."""
    (cs, As, bs), states = optimal_states(4, 5, 7, seed=2)
    want = jax_ranging_batch(jnp.asarray(cs), jnp.asarray(As),
                             jnp.asarray(bs), states)
    A = torch.tensor(As)
    own = lt.engine.make_state(A, torch.tensor(bs),
                               torch.tensor(np.asarray(states.basis)))
    got = lt.ranging_batch(torch.tensor(cs), A, torch.tensor(bs), own)
    same_intervals(got, want)


def test_solver_class_ranging_matches_reference():
    """``PrimalRevisedSimplexSolver.ranging()`` after ``solve()`` in both
    packages (f32: 1e-5)."""
    p = PRIMAL_PROBLEMS[0]
    ref = jlt.PrimalRevisedSimplexSolver(p.c, p.A, p.b, p.starting_basis)
    port = lt.PrimalRevisedSimplexSolver(p.c, p.A, p.b, p.starting_basis,
                                         device="cpu")
    assert ref.solve().optimum and port.solve().optimum
    same_intervals(port.ranging(), ref.ranging(), tol=1e-5)
    r = port.ranging()
    c = np.asarray(p.c, np.float64)
    assert (r.cost_lo.numpy() <= c + 1e-6).all()
    assert (c <= r.cost_hi.numpy() + 1e-6).all()


def test_f32_ranging_reads_rounding_noise_as_far_endpoints():
    """A limit of the ranging in f32 (its 1e-9 sign tests are the
    reference's constants): at the exact pipeline's bases of eight lanes
    of ``device_inequality_lps`` (m = n = 32), f32 rounding noise in
    entries of ``inv_B`` that are zero in float64 passes the sign test,
    so some right-hand-side endpoints that float64 finds unbounded come
    out finite in f32, beyond 1e4 of the data's scale; every endpoint
    finite in both agrees to 1e-3."""
    from linprog_tpu_torch.engine import make_state
    from linprog_tpu_torch.generators import device_inequality_lps

    B, m = 8, 32
    gen = torch.Generator().manual_seed(0)
    c, G, h = device_inequality_lps(gen, B, m, m, "cpu")
    res, _ = lt.solve_batch_exact(c, G, h)
    assert (res.status == st.OPTIMAL).all()
    A = torch.cat([G, torch.eye(m).expand(B, m, m)], dim=2)
    cs = torch.cat([c, torch.zeros(B, m)], dim=1)
    f32 = lt.ranging_batch(cs, A, h, make_state(A, h, res.basis))
    A64, h64 = A.double(), h.double()
    f64 = lt.ranging_batch(cs.double(), A64, h64,
                           make_state(A64, h64, res.basis))
    far = 0
    for name, got, want in zip(f64._fields, f32, f64):
        got = got.double()
        value = (cs if name.startswith("cost") else h).double()
        differ = torch.isfinite(got) != torch.isfinite(want)
        assert torch.isfinite(got)[differ].all(), name
        dist = (got - value).abs() / value.abs().clamp_min(1.0)
        assert (dist[differ] > 1e4).all(), name
        far += int(differ.sum())
        both = torch.isfinite(got) & torch.isfinite(want)
        err = (got - want).abs() / want.abs().clamp_min(1.0)
        assert (err[both] <= 1e-3).all(), name
    assert far > 0
