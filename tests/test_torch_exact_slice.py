"""The port's exact pipeline end to end against the reference on the same
host instances: two-phase simplex, IPM -> crossover -> fallback, and the
dd-KKT certificate.

The reference runs with its tuned configuration, whose segment kernel is
the Pallas kernel in interpret mode on the CPU; the port runs the plain
versions of its kernels.  Statuses must match lane for lane and objectives
agree to 1e-5 relative (both land on exact vertices; only f32 rounding of
the reported objective differs).
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


import linprog_tpu.engine_batched as jeb  # noqa: E402
from linprog_tpu import calibration as jax_calibration  # noqa: E402
from linprog_tpu.batch import solve_batch_two_phase as jax_two_phase  # noqa: E402
from linprog_tpu.certify import certify_vertex_batch as jax_certify  # noqa: E402
from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.config import tuned_config as jax_tuned_config  # noqa: E402
from linprog_tpu.generators import to_standard_form_batch  # noqa: E402
from linprog_tpu.router import solve_batch_exact as jax_solve_batch_exact  # noqa: E402

from linprog_tpu_torch import (  # noqa: E402
    certificate_summary,
    certify_vertex_batch,
    solve_batch_exact,
    solve_batch_two_phase,
    tuned_config,
)
import linprog_tpu_torch.engine_batched as teb  # noqa: E402
from linprog_tpu_torch import calibration as torch_calibration  # noqa: E402
from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from linprog_tpu_torch.generators import (  # noqa: E402
    device_standard_form_batch,
    random_inequality_lps,
)

B, M, N = 8, 24, 24


def _rel(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


@pytest.fixture(scope="module")
def instance():
    return random_inequality_lps(B, M, N, seed=21)


@pytest.fixture(scope="module")
def exact_both(instance):
    c, G, h = instance
    jres, jinfo = jax_solve_batch_exact(jnp.asarray(c), jnp.asarray(G),
                                        jnp.asarray(h))
    res, info = solve_batch_exact(torch.tensor(c), torch.tensor(G),
                                  torch.tensor(h))
    return jres, jinfo, res, info


def test_solve_batch_exact_matches_reference(exact_both):
    jres, jinfo, res, info = exact_both
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert (res.status.numpy() == st.OPTIMAL).all()
    assert _rel(res.cost.numpy(), np.asarray(jres.cost)).max() < 1e-5
    assert res.x.shape == (B, N)
    assert info["crossed"] >= jinfo["crossed"]


def test_certificates_match_reference(exact_both, instance):
    """Certified counts at least the reference's; and the port's certificate
    on the REFERENCE's bases gives the reference certificate's flags."""
    c, G, h = instance
    jres, _, res, _ = exact_both
    jcert = jax_certify(jnp.asarray(c), jnp.asarray(G), jnp.asarray(h),
                        jres.basis)
    tc, tG, th = torch.tensor(c), torch.tensor(G), torch.tensor(h)
    cert = certify_vertex_batch(tc, tG, th, res.basis)
    assert int(cert["certified"].sum()) >= int(np.asarray(jcert["certified"]).sum())
    summ = certificate_summary(cert)
    assert summ["certified"] == B and summ["max_primal_residual"] < 1e-6

    cert_on_ref = certify_vertex_batch(
        tc, tG, th, torch.tensor(np.asarray(jres.basis))
    )
    np.testing.assert_array_equal(cert_on_ref["certified"].numpy(),
                                  np.asarray(jcert["certified"]))
    for key in ("primal_residual", "gap"):
        assert np.abs(cert_on_ref[key].numpy()
                      - np.asarray(jcert[key])).max() < 1e-6


def test_corrupted_basis_fails(exact_both, instance):
    """Swapping one basic column for a non-basic one must fail the
    certificate (primal or dual feasibility breaks)."""
    c, G, h = instance
    _, _, res, _ = exact_both
    basis = res.basis.numpy().copy()
    for i in range(B):
        present = set(basis[i].tolist())
        basis[i, 0] = next(j for j in range(N + M) if j not in present)
    cert = certify_vertex_batch(torch.tensor(c), torch.tensor(G),
                                torch.tensor(h), torch.tensor(basis))
    assert int(cert["certified"].sum()) <= 1


def test_two_phase_matches_reference(instance):
    c, G, h = instance
    cs, As, bs = to_standard_form_batch(c, G, h)
    jcfg = jax_tuned_config(M)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    assert cfg == tuned_config(M)
    jres = jax_two_phase(jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs),
                         4 * M, 4 * M, jcfg)
    tcs, tAs, tbs = device_standard_form_batch(
        torch.tensor(c), torch.tensor(G), torch.tensor(h))
    np.testing.assert_array_equal(tAs.numpy(), As)
    res = solve_batch_two_phase(tcs, tAs, tbs, 4 * M, 4 * M, cfg)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert (res.status.numpy() == st.OPTIMAL).all()
    assert _rel(res.cost.numpy(), np.asarray(jres.cost)).max() < 1e-5


def test_forced_fallback_matches_reference():
    """A 1-pivot crossover budget with the magnitude guess leaves lanes
    uncrossed; the gathered two-phase fallback must repair them to the
    same vertices as the reference's.  Which lanes miss the tiny budget
    depends on the IPM's f32 iterate, so the port must cross at least as
    many lanes as the reference, not the same ones."""
    c, G, h = random_inequality_lps(8, 32, 32, seed=8)
    jcfg = JaxSolverConfig(kernels="pallas", pricing="dantzig",
                           refactor_every=128, polish_pivots=4)
    jres, jinfo = jax_solve_batch_exact(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), cfg=jcfg,
        maxiters=1, guess="magnitude")
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    res, info = solve_batch_exact(torch.tensor(c), torch.tensor(G),
                                  torch.tensor(h), cfg=cfg, maxiters=1,
                                  guess="magnitude")
    assert info["fallback"] > 0
    assert info["crossed"] >= jinfo["crossed"]
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert (res.status.numpy() == st.OPTIMAL).all()
    assert _rel(res.cost.numpy(), np.asarray(jres.cost)).max() < 1e-5
    cert = certify_vertex_batch(torch.tensor(c), torch.tensor(G),
                                torch.tensor(h), res.basis)
    assert bool(cert["certified"].all())


@pytest.fixture
def large_m_route(monkeypatch):
    """Both packages take their large-m route at m = 24: the whole-segment
    boundary ``xover_pallas_max_m`` shrinks to 8 (so the alternate-guess
    retry runs) and the whole-segment gate is shut (so every simplex
    segment runs on the streaming kernel).  Counts the port's streaming
    kernel calls."""
    jt = dict(jax_calibration.get_table("default"))
    tt = torch_calibration.get_table()
    jt["xover_pallas_max_m"] = tt["xover_pallas_max_m"] = 8
    for eb in (jeb, teb):
        monkeypatch.setattr(eb, "_mega_kernel_fits",
                            lambda m, n, with_at, **kw: False)
    calls = []
    kernel = teb.solve_segment_stream

    def counting(*a, **k):
        calls.append(k["dual"])
        return kernel(*a, **k)

    monkeypatch.setattr(teb, "solve_segment_stream", counting)
    jax_calibration.set_table({"default": jt})
    torch_calibration.set_table({"default": tt})
    try:
        yield calls
    finally:
        jax_calibration.reset_table()
        torch_calibration.reset_table()


@pytest.mark.parametrize("guess,seed", [("tapia", 58), ("magnitude", 44)])
def test_large_m_route_matches_reference(large_m_route, guess, seed):
    """A one-pivot crossover budget leaves lanes uncrossed; the retry from
    the alternate guess crosses some and the two-phase fallback repairs the
    rest.  Both packages count the same crossed, retried and fallback
    lanes, reach the same statuses, agree with each other and with HiGHS to
    1e-5 relative, and certify the same number of lanes.  (The seeds are
    ones where the two IPMs take the same steps on every lane: where an
    f32 IPM straggles at the KKT floor the two packages guess different
    bases, and a one-pivot budget then crosses different lanes.)"""
    from scipy.optimize import linprog

    c, G, h = random_inequality_lps(B, M, N, seed=seed)
    jres, jinfo = jax_solve_batch_exact(jnp.asarray(c), jnp.asarray(G),
                                        jnp.asarray(h), maxiters=1,
                                        guess=guess)
    tc, tG, th = torch.tensor(c), torch.tensor(G), torch.tensor(h)
    res, info = solve_batch_exact(tc, tG, th, maxiters=1, guess=guess)
    assert info == jinfo
    assert info["retry_crossed"] > 0 and info["fallback"] > 0
    assert True in large_m_route and False in large_m_route  # dual, primal
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert (res.status.numpy() == st.OPTIMAL).all()
    assert _rel(res.cost.numpy(), np.asarray(jres.cost)).max() < 1e-5
    highs = np.array([linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                              method="highs").fun for i in range(B)])
    assert _rel(res.cost.numpy(), highs).max() < 1e-5
    cert = certify_vertex_batch(tc, tG, th, res.basis)
    jcert = jax_certify(jnp.asarray(c), jnp.asarray(G), jnp.asarray(h),
                        jres.basis)
    assert int(cert["certified"].sum()) == int(np.asarray(jcert["certified"]).sum())


def test_crossover_from_an_optimal_vertex_verifies_it(instance):
    """The fallback's repair pass: a crossover started at a two-phase
    vertex verifies every lane (dd-refined) and keeps its objective."""
    from linprog_tpu_torch import crossover_batch_canonical

    c, G, h = (torch.tensor(a) for a in instance)
    cfg = tuned_config(M)
    cs, As, bs = device_standard_form_batch(c, G, h)
    two = solve_batch_two_phase(cs, As, bs, 4 * M, 4 * M, cfg)
    res, crossed = crossover_batch_canonical(c, G, h, two.x[:, :N], cfg=cfg)
    assert bool(crossed.all())
    assert _rel(res.cost.numpy(), two.cost.numpy()).max() < 1e-6
    assert int(res.iters.max()) <= 2 * M  # a repair, not a fresh solve
