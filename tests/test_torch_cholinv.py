"""linprog_tpu_torch's panel inverse-Cholesky (plain PyTorch version) and
block recursion against the reference and numpy.

Tolerances: the elimination is the same in both packages up to the pivot's
rounding (1/sqrt vs rsqrt) and summation order, so results agree to 1e-5
relative of the largest entry at these well-conditioned sizes.
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


from linprog_tpu.ipm import block_cholesky_inverse as jax_block_cholinv  # noqa: E402
from linprog_tpu.ops.cholinv_kernel import panel_cholinv as jax_panel_cholinv  # noqa: E402

from linprog_tpu_torch.ipm import block_cholesky_inverse  # noqa: E402
from linprog_tpu_torch.ops.cholinv_kernel import panel_cholinv  # noqa: E402


def _spd(B, mb, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, mb, mb)).astype(np.float32)
    return X @ np.swapaxes(X, 1, 2) + mb * np.eye(mb, dtype=np.float32)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("mb", [1, 5, 8, 16, 31, 32, 33, 64])
def test_panel_matches_pallas_and_numpy(mb):
    """The plain version against the Pallas kernel (interpret mode) and
    numpy, at the sizes the IPM hands it (32), at odd sizes the
    warp-per-matrix CUDA kernel must mask (1, 5, 31) and on both sides of
    its boundary with the block-per-matrix kernel (32, 33, 64)."""
    M = _spd(16, mb, seed=mb)
    W = panel_cholinv(torch.tensor(M)).numpy()
    W_ref = np.asarray(jax_panel_cholinv(jnp.asarray(M), interpret=True))
    assert _rel(W, W_ref) < 1e-5
    L = np.linalg.cholesky(M.astype(np.float64))
    W_np = np.stack([np.linalg.inv(L[i]) for i in range(M.shape[0])])
    assert _rel(W, W_np) < 1e-5
    assert np.allclose(np.tril(W), W)  # L^{-1} is lower triangular


def test_panel_non_spd_is_nonfinite():
    M = _spd(4, 16)
    M[1] = -M[1]  # negative definite lane
    W = panel_cholinv(torch.tensor(M)).numpy()
    assert np.isfinite(W[0]).all() and np.isfinite(W[2:]).all()
    assert not np.isfinite(W[1]).all()


@pytest.mark.parametrize("m", [64, 128])
def test_block_cholesky_inverse_matches_reference(m):
    """The port's recursion (f32 base case: the panel kernel's plain
    version) against the reference's (lax cholesky base case on CPU)."""
    M = _spd(4, m, seed=m)
    W = block_cholesky_inverse(torch.tensor(M)).numpy()
    W_ref = np.asarray(jax_block_cholinv(jnp.asarray(M)))
    assert _rel(W, W_ref) < 1e-5
    Minv = np.linalg.inv(M.astype(np.float64))
    WtW = np.einsum("bji,bjk->bik", W.astype(np.float64), W)
    assert _rel(WtW, Minv) < 1e-5


def test_block_cholesky_inverse_float64():
    """f64 takes the Cholesky + triangular-solve base case."""
    M = _spd(3, 64, seed=1).astype(np.float64)
    W = block_cholesky_inverse(torch.tensor(M)).numpy()
    W_ref = np.asarray(jax_block_cholinv(jnp.asarray(M)))
    assert _rel(W, W_ref) < 1e-12
