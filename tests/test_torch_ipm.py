"""linprog_tpu_torch's canonical IPM against the reference's, on the same
host instances.

Checks: statuses equal, Newton-step counts within +-1, costs within 1e-4
relative.  The packages sum in different orders, and near the f32 KKT floor
(the IPM's eps_rel is 1e-3) the last Newton steps amplify that noise: on
some instances a lane straggles in one package and not the other, and
interior costs differ by up to ~6e-4, the size of either package's own
error against the exact optimum.  So the f32 case uses an instance whose
lanes converge clear of the floor, and the float64 case holds the parity
on an instance (seed 0) where f32 lanes straggle differently.
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


from linprog_tpu.ipm import IPMConfig as JaxIPMConfig  # noqa: E402
from linprog_tpu.ipm import _ipm_canonical_jit  # noqa: E402
from linprog_tpu.ipm import ipm_solve_batch_canonical as jax_ipm_canonical  # noqa: E402

from linprog_tpu_torch import status as st  # noqa: E402
from linprog_tpu_torch.convert import config_from_reference, ipm_state_to_numpy  # noqa: E402
from linprog_tpu_torch.generators import random_inequality_lps  # noqa: E402
from linprog_tpu_torch.ipm import (  # noqa: E402
    IPMConfig,
    ipm_canonical_state,
    ipm_solve_batch_canonical,
)


def _rel(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


@pytest.mark.parametrize("dtype,seed", [("float32", 1), ("float64", 0)])
def test_ipm_core_matches_reference(dtype, seed):
    c, G, h = random_inequality_lps(8, 16, 16, seed=seed)
    B, m, n = G.shape
    cs = np.concatenate([c, np.zeros((B, m), np.float32)], axis=1)
    jcfg = JaxIPMConfig(dtype=dtype)
    ref = _ipm_canonical_jit(jnp.asarray(cs), jnp.asarray(G), jnp.asarray(h),
                             jcfg)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    assert cfg == IPMConfig(dtype=dtype)
    port = ipm_state_to_numpy(ipm_canonical_state(
        torch.tensor(cs), torch.tensor(G), torch.tensor(h), cfg))
    np.testing.assert_array_equal(port["status"], np.asarray(ref.status))
    assert (port["status"] == st.OPTIMAL).all()
    assert np.abs(port["iters"] - np.asarray(ref.iters)).max() <= 1
    cost = (cs * port["x"]).sum(axis=1)
    cost_ref = (cs * np.asarray(ref.x)).sum(axis=1)
    assert _rel(cost, cost_ref).max() < 1e-4


def test_ipm_solve_batch_canonical_result():
    """The public entry: slack-extended result, basis -1, same statuses and
    costs as the reference."""
    c, G, h = random_inequality_lps(8, 16, 16, seed=1)
    ref = jax_ipm_canonical(jnp.asarray(c), jnp.asarray(G), jnp.asarray(h))
    res = ipm_solve_batch_canonical(torch.tensor(c), torch.tensor(G),
                                    torch.tensor(h))
    assert res.x.shape == (8, 32) and (res.basis == -1).all()
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert _rel(res.cost.numpy(), np.asarray(ref.cost)).max() < 1e-4


def test_long_normal_products_accumulate_in_float64(monkeypatch):
    """Past ``engine.F64_PAST`` summed columns (lowered to 8 here) the normal
    matrix is the f32 rounding of its float64 product, bit for bit; at or
    below it the f32 product.  With the lowered threshold the IPM still
    matches the reference as ``test_ipm_core_matches_reference`` holds it
    (statuses, iterations within one, costs within 1e-4 relative)."""
    import linprog_tpu_torch.engine as tengine
    import linprog_tpu_torch.ipm as tipm

    rng = np.random.default_rng(3)
    G = torch.tensor(rng.standard_normal((2, 5, 12)).astype(np.float32))
    d = torch.tensor(rng.random((2, 17)).astype(np.float32) * 1e3)
    G64, d64 = G.double(), d.double()
    want = (torch.matmul(G64 * d64[:, None, :12], G64.transpose(1, 2)).float()
            + torch.diag_embed(d[:, 12:]))
    plain = (torch.matmul(G * d[:, None, :12], G.transpose(1, 2))
             + torch.diag_embed(d[:, 12:]))
    monkeypatch.setattr(tengine, "F64_PAST", 12)
    assert torch.equal(tipm._SlackOp(G).normal(d), plain)
    monkeypatch.setattr(tengine, "F64_PAST", 8)
    assert torch.equal(tipm._SlackOp(G).normal(d), want)
    A = torch.cat([G, torch.eye(5).expand(2, 5, 5)], dim=2)
    Ad = tipm._DenseOp(A).normal(d)
    assert torch.equal(Ad, torch.matmul(A.double() * d64[:, None, :],
                                        A.double().transpose(1, 2)).float())

    c, Gn, h = random_inequality_lps(8, 16, 16, seed=1)
    cs = np.concatenate([c, np.zeros((8, 16), np.float32)], axis=1)
    ref = _ipm_canonical_jit(jnp.asarray(cs), jnp.asarray(Gn), jnp.asarray(h),
                             JaxIPMConfig())
    port = ipm_state_to_numpy(ipm_canonical_state(
        torch.tensor(cs), torch.tensor(Gn), torch.tensor(h), IPMConfig()))
    np.testing.assert_array_equal(port["status"], np.asarray(ref.status))
    assert np.abs(port["iters"] - np.asarray(ref.iters)).max() <= 1
    cost = (cs * port["x"]).sum(axis=1)
    assert _rel(cost, (cs * np.asarray(ref.x)).sum(axis=1)).max() < 1e-4
