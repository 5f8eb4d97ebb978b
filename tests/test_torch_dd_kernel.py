"""The order of operations that the double-word kernel
(``linprog_tpu_torch/csrc/dd_residual.cu``) must follow, pinned on the
CPU.

A scalar float32 model in NumPy computes one output at a time in the
kernel's order: per chunk of 8 rows (the last padded with zero rows) the
Dekker splits, the TwoProd error and the TwoSum step row by row, then the
compensated sum over ``[bvec, -s_0 .. -s_{K-1}, -e_0 .. -e_{K-1}]`` (the
residual) or ``[s, e]``.  The eager primitives of ``refine.py`` (the plain
version the kernel replaces on a card) must equal the model bit for bit,
at small shapes with padding, a transposed M and non-finite entries.  NaN
payloads are not compared (the host keeps an operand's, the card gives
the canonical one); where each NaN lies is.  The card's own test holds
the kernel against the plain version on CUDA tensors
(``tests/test_torch_cuda_kernels.py``).  Here CPU tensors must take the
plain version, with the kernel's launch counter at 0.
"""

import numpy as np
import pytest
import torch

from linprog_tpu_torch import observability as obs
from linprog_tpu_torch import refine
from linprog_tpu_torch.batch import solve_batch_bounded, solve_batch_two_phase
from linprog_tpu_torch.config import SolverConfig
from linprog_tpu_torch.generators import (
    device_bounded_lps,
    device_standard_form_batch,
    random_inequality_lps,
)
from linprog_tpu_torch.ops import dd_kernel

F = np.float32


def _split(x):
    t = x * F(4097.0)
    hi = t - (t - x)
    return hi, x - hi


def _kahan(terms):
    s, comp = terms[0], F(0.0)
    for x in terms[1:]:
        t = s + x
        z = t - s
        comp = comp + ((s - (t - z)) + (x - z))
        s = t
    return s + comp


def _model(bvec, y, M, chunk=8):
    """``bvec - y @ M`` (or ``y @ M`` with ``bvec`` None), one output at a
    time in the kernel's order, every step a float32 scalar operation."""
    B, m, n = M.shape
    K = -(-m // chunk)
    out = np.empty((B, n), np.float32)
    with np.errstate(all="ignore"):
        for b in range(B):
            for j in range(n):
                S, E = [], []
                for k in range(K):
                    s = e = F(0.0)
                    for c in range(chunk):
                        i = k * chunk + c
                        yi = y[b, i] if i < m else F(0.0)
                        a = M[b, i, j] if i < m else F(0.0)
                        yh, yl = _split(yi)
                        ah, al = _split(a)
                        p = yi * a
                        pe = yh * ah - p
                        pe = pe + yh * al
                        pe = pe + yl * ah
                        pe = pe + yl * al
                        t = s + p
                        z = t - s
                        err = (s - (t - z)) + (p - z)
                        s = t
                        e = e + (pe + err)
                    S.append(s)
                    E.append(e)
                if bvec is None:
                    out[b, j] = _kahan(S + E)
                else:
                    out[b, j] = _kahan([bvec[b, j]] + [-v for v in S]
                                       + [-v for v in E])
    return out


def _kahan_model(P):
    B, K, n = P.shape
    out = np.empty((B, n), np.float32)
    with np.errstate(all="ignore"):
        for b in range(B):
            for j in range(n):
                out[b, j] = _kahan(list(P[b, :, j]))
    return out


def _assert_same_bits(got, want):
    got = np.asarray(got, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  want.view(np.int32)[~nan])


def _case(seed, B, m, n, nonfinite):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, m)).astype(np.float32)
    M = (rng.normal(size=(B, m, n))
         * 10.0 ** rng.integers(-3, 4, size=(B, m, n))).astype(np.float32)
    bvec = np.einsum("bm,bmn->bn", y.astype(np.float64),
                     M.astype(np.float64)).astype(np.float32)
    y[0, m // 2] = 0.0
    bvec[0, 0] = -0.0  # a signed zero into the chain
    if nonfinite:
        y[0, 1] = np.inf  # lane 0: an inf in y
        M[1, 0, 2] = np.nan  # lane 1: a NaN in M
        M[1, m - 1, n - 1] = -np.inf
        y[2, :] = 0.0  # lane 2: a zero row, bvec's signed zeros pass
        bvec[2, :2] = (-0.0, 0.0)
    return bvec, y, M


SHAPES = [(3, 24, 7), (3, 21, 9), (3, 5, 4), (3, 37, 33)]


@pytest.mark.parametrize("nonfinite", [False, True],
                         ids=["finite", "nonfinite"])
@pytest.mark.parametrize("B,m,n", SHAPES)
def test_plain_residual_follows_the_kernels_order(B, m, n, nonfinite):
    """m = 24 fills its chunks; 21, 5 and 37 end on padded rows; 33
    columns span two of the kernel's column tiles."""
    bvec, y, M = _case(B * m + n, B, m, n, nonfinite)
    want = _model(bvec, y, M)
    got = refine.dd_residual_rowmat(*(torch.tensor(a) for a in (bvec, y, M)))
    _assert_same_bits(got.numpy(), want)


@pytest.mark.parametrize("nonfinite", [False, True],
                         ids=["finite", "nonfinite"])
@pytest.mark.parametrize("B,m,n", SHAPES)
def test_plain_dd_product_follows_the_kernels_order(B, m, n, nonfinite):
    _, y, M = _case(B * m + n + 1, B, m, n, nonfinite)
    want = _model(None, y, M)
    got = refine.dd_rowmat_dd(torch.tensor(y), torch.tensor(M))
    _assert_same_bits(got.numpy(), want)


@pytest.mark.parametrize("nonfinite", [False, True],
                         ids=["finite", "nonfinite"])
def test_plain_transposed_residual_and_matvec_follow_the_kernels_order(
        nonfinite):
    """``dd_residual(b, M, x)`` and ``dd_matvec(M, x)`` run the primitive
    over ``M.transpose(1, 2)``, a view whose row stride is 1: what the
    kernel reads through its tile."""
    bvec, x, MT = _case(7, 3, 19, 6, nonfinite)  # MT[b, i, j] = M[b, j, i]
    M = np.ascontiguousarray(MT.transpose(0, 2, 1))
    Mt = torch.tensor(M)
    assert Mt.transpose(1, 2).stride()[1] == 1
    got = refine.dd_residual(torch.tensor(bvec), Mt, torch.tensor(x))
    _assert_same_bits(got.numpy(), _model(bvec, x, MT))
    got = refine.dd_matvec(Mt, torch.tensor(x))
    _assert_same_bits(got.numpy(), _model(None, x, MT))


@pytest.mark.parametrize("K", [1, 2, 9, 65])
def test_plain_kahan_sum_follows_the_kernels_order(K):
    """The sum-only entry point: ``_kahan_sum_chunks`` over ``P[B, K, n]``,
    with an inf, a NaN and signed zeros among the partials."""
    rng = np.random.default_rng(K)
    P = (rng.normal(size=(3, K, 5))
         * 10.0 ** rng.integers(-6, 7, size=(3, K, 5))).astype(np.float32)
    P[0, 0, 0] = -0.0
    P[1, K - 1, 1] = np.inf
    P[2, 0, 2] = np.nan
    got = refine._kahan_sum_chunks(torch.tensor(P))
    _assert_same_bits(got.numpy(), _kahan_model(P))


def test_kernel_entry_points_refuse_cpu_tensors():
    y, M = torch.ones((2, 8)), torch.ones((2, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        dd_kernel.chunk_products_sum(None, y, M)
    with pytest.raises(ValueError, match="CUDA"):
        dd_kernel.kahan_sum(M)


def _two_phase():
    c, G, h = (torch.tensor(a) for a in random_inequality_lps(8, 16, 16,
                                                              seed=3))
    cfg = SolverConfig(pricing="dantzig", refactor_every=16, polish_pivots=4)
    return solve_batch_two_phase(*device_standard_form_batch(c, G, h),
                                 200, 200, cfg)


def _bounded():
    gen = torch.Generator().manual_seed(5)
    prob = device_bounded_lps(gen, 8, 12, 12, "cpu")
    basis = torch.arange(12, 24, dtype=torch.int32).expand(8, 12).clone()
    vs = torch.cat([torch.zeros((8, 12), dtype=torch.int8),
                    torch.full((8, 12), 2, dtype=torch.int8)], dim=1)
    cfg = SolverConfig(pricing="dantzig", refactor_every=16, polish_pivots=8)
    return solve_batch_bounded(*prob, basis, vs, 400, cfg)


@pytest.mark.parametrize("entry,polish", [(_two_phase, "polish"),
                                          (_bounded, "bounded_polish")],
                         ids=["two_phase", "bounded"])
def test_cpu_tensors_take_the_plain_path(entry, polish):
    """The entry points on CPU tensors run the eager chain: no launch of
    the kernel, and no ``dd_launches`` on their polish span."""
    before = dd_kernel.launches
    obs.stop()
    rec = obs.start()
    try:
        entry()
    finally:
        obs.stop()
    assert dd_kernel.launches == before
    spans = [s for call in rec.calls() for s in call if s.name == polish]
    assert len(spans) == 1
    assert spans[0].counts["dd_launches"] == 0


@pytest.mark.parametrize("entry,polish", [(_two_phase, "polish"),
                                          (_bounded, "bounded_polish")],
                         ids=["two_phase", "bounded"])
def test_polish_span_notes_the_kernels_launches(entry, polish,
                                                monkeypatch):
    """Where the tensors go to the kernel, the polish span's
    ``dd_launches`` is the number of entry-point calls made inside it, and
    the answer is the plain version's.  On the CPU, stand-ins for the two
    entry points count a launch each and run the eager chain."""
    want = entry()

    def products_sum(bvec, y, M, chunk=8):
        dd_kernel.launches += 1
        s, e = refine._dd_chunk_products(y, M, chunk)
        parts = [s, e] if bvec is None else [bvec[:, None, :], -s, -e]
        return refine._kahan_sum_chunks(torch.cat(parts, dim=1))

    def kahan_sum(P):
        dd_kernel.launches += 1
        return refine._kahan_sum_chunks(P)

    monkeypatch.setattr(refine, "_on_card", lambda *ts: True)
    monkeypatch.setattr(dd_kernel, "chunk_products_sum", products_sum)
    monkeypatch.setattr(dd_kernel, "kahan_sum", kahan_sum)
    monkeypatch.setattr(dd_kernel, "launches", 0)
    obs.stop()
    rec = obs.start()
    try:
        got = entry()
    finally:
        obs.stop()
    for f in ("x", "basis", "status", "iters", "cost"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    spans = [s for call in rec.calls() for s in call if s.name == polish]
    assert len(spans) == 1
    inside = spans[0].counts["dd_launches"]
    assert 0 < inside <= dd_kernel.launches
