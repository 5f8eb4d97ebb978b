"""The reference's last IPM and crossover modes in linprog_tpu_torch, held
against the reference on the same seeded numpy inputs (JAX on the CPU, the
port's plain versions on the CPU): Gondzio's centrality correctors
(``IPMConfig.gondzio``), the squared-factor Newton solve
(``newton_solver="minv"``), and the crossover's ``guess="slack"``
ranking."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """XLA's CPU backend aborts after ~280 accumulated compilations in one
    process; clearing JAX's caches resets it (tests/test_stream_kernel.py).
    torch runs on one thread here: with several test workers on the host,
    a thread a core in each worker oversubscribes the cores."""
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


from linprog_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from linprog_tpu.crossover import (  # noqa: E402
    ipm_crossover_batch_canonical as jax_ipm_crossover,
)
from linprog_tpu.generators import random_inequality_lps  # noqa: E402
from linprog_tpu.ipm import IPMConfig as JaxIPMConfig  # noqa: E402
from linprog_tpu.ipm import ipm_solve_batch_canonical as jax_ipm  # noqa: E402

from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.certify import certify_vertex_batch  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference  # noqa: E402
from linprog_tpu_torch.crossover import ipm_crossover_batch_canonical  # noqa: E402
from linprog_tpu_torch.ipm import IPMConfig, ipm_solve_batch_canonical  # noqa: E402

# tests/test_ipm.py's float64 configuration
CFG = dict(eps_rel=1e-7, maxiters=60, dtype="float64")


def _both(c, G, h, **kw):
    """The reference's and the port's canonical IPM on the same arrays."""
    ref = jax_ipm(jnp.asarray(c), jnp.asarray(G), jnp.asarray(h),
                  JaxIPMConfig(**kw))
    res = ipm_solve_batch_canonical(*(torch.tensor(a) for a in (c, G, h)),
                                    IPMConfig(**kw))
    return ref, res


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))


def test_gondzio_correctors_match_the_reference():
    """The instance of ``tests/test_ipm.py::
    test_gondzio_correctors_converge_to_same_accuracy`` (B = 8, m = n = 24,
    seed 3, float64, eps 1e-7) with ``gondzio=2``: the reference's statuses
    (all OPTIMAL), Newton steps within 1, costs within 1e-6 and x within
    1e-5 of the lane's scale (f32 class: the two packages round the normal
    products apart); and no more Newton steps than the port without
    correctors, plus one."""
    c, G, h = random_inequality_lps(8, 24, 24, seed=3, dtype=np.float64)
    ref, res = _both(c, G, h, gondzio=2, **CFG)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert bool((res.status == st.OPTIMAL).all())
    assert np.abs(res.iters.numpy() - np.asarray(ref.iters)).max() <= 1
    assert _rel(res.cost.numpy(), ref.cost).max() < 1e-6
    x_ref = np.asarray(ref.x)
    scale = np.maximum(np.abs(x_ref).max(axis=1, keepdims=True), 1.0)
    assert (np.abs(res.x.numpy() - x_ref) <= 1e-5 * scale).all()
    base = ipm_solve_batch_canonical(*(torch.tensor(a) for a in (c, G, h)),
                                     IPMConfig(**CFG))
    assert bool((res.iters <= base.iters + 1).all())
    assert _rel(res.cost.numpy(), base.cost.numpy()).max() < 1e-6


def test_minv_solver_agrees_with_w2_in_float64():
    """``newton_solver="minv"`` (M^-1 = W'W formed once an iteration) in
    float64 on the same instance: within 1e-9 of ``"w2"`` in cost in both
    packages, and the reference's statuses and Newton steps within 1."""
    c, G, h = random_inequality_lps(8, 24, 24, seed=3, dtype=np.float64)
    ref_w2, res_w2 = _both(c, G, h, **CFG)
    ref_mi, res_mi = _both(c, G, h, newton_solver="minv", **CFG)
    assert _rel(np.asarray(ref_mi.cost), ref_w2.cost).max() < 1e-9
    assert _rel(res_mi.cost.numpy(), res_w2.cost.numpy()).max() < 1e-9
    np.testing.assert_array_equal(res_mi.status.numpy(),
                                  np.asarray(ref_mi.status))
    assert bool((res_mi.status == st.OPTIMAL).all())
    assert np.abs(res_mi.iters.numpy() - np.asarray(ref_mi.iters)).max() <= 1
    with pytest.raises(ValueError, match="newton_solver"):
        IPMConfig(newton_solver="chol")


def test_gondzio_in_f32_strands_lanes_in_the_reference_too():
    """In f32 at eps 1e-3 Gondzio's correctors end fewer lanes OPTIMAL than
    the plain predictor-corrector, in the reference as in the port
    (B = 96, m = n = 48, seed 1: the reference 96 -> 94, the port 94 -> 92;
    on the card at B = 1024, m = 256 the port 972 -> 958).  Which lanes
    strand at the f32 KKT floor differs between the packages, so only the
    direction is pinned."""
    c, G, h = random_inequality_lps(96, 48, 48, seed=1)
    ref_base, res_base = _both(c, G, h)
    ref_gz, res_gz = _both(c, G, h, gondzio=2)
    n_opt = lambda s: int((np.asarray(s) == st.OPTIMAL).sum())  # noqa: E731
    assert n_opt(ref_gz.status) < n_opt(ref_base.status)
    assert n_opt(res_gz.status.numpy()) < n_opt(res_base.status.numpy())


def test_ipm_modes_carry_over_from_the_reference_config():
    cfg = config_from_reference(dataclasses.asdict(
        JaxIPMConfig(gondzio=3, newton_solver="minv", dtype="float64")))
    assert (cfg.gondzio, cfg.newton_solver, cfg.dtype) == (3, "minv",
                                                           "float64")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slack_guess_crosses_and_certifies(seed):
    """``guess="slack"`` on ``random_inequality_lps(8, 16, 16, seed)``: the
    port crosses at least as many lanes as the reference with the same
    settings, and every lane it reports crossed is dd-KKT certified."""
    c, G, h = random_inequality_lps(8, 16, 16, seed=seed)
    jcfg = JaxSolverConfig(pricing="dantzig", refactor_every=128,
                           polish_pivots=8)
    _, ref_crossed = jax_ipm_crossover(jnp.asarray(c), jnp.asarray(G),
                                       jnp.asarray(h), cfg=jcfg,
                                       guess="slack")
    ct, Gt, ht = (torch.tensor(a) for a in (c, G, h))
    res, crossed = ipm_crossover_batch_canonical(
        ct, Gt, ht, cfg=config_from_reference(dataclasses.asdict(jcfg)),
        guess="slack")
    assert int(crossed.sum()) >= int(np.asarray(ref_crossed).sum())
    cert = certify_vertex_batch(ct, Gt, ht, res.basis)
    assert bool(cert["certified"][crossed].all())
    assert bool((res.status[crossed] == st.OPTIMAL).all())
    with pytest.raises(ValueError, match="basis guess"):
        ipm_crossover_batch_canonical(ct, Gt, ht, guess="lowest")
