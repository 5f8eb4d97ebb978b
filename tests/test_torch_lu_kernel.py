"""The batched LU kernel (``linprog_tpu_torch/csrc/batched_lu.cu``) and its
routing.

On the CPU: the plain version (``ops.lu_kernel._plain``, the kernel's
elimination in torch ops) against ``torch.linalg``: its pivot rows are
LAPACK's, its inverse and solve agree to float32 rounding, zero pivots give
NaN lanes; the routing rule sends CPU tensors, float64 and m past the range
to ``torch.linalg`` bit for bit; the entry points' spans note the kernel's
launches and the library's calls.

On a card (marked ``card``; they skip without one): the kernel against
``torch.linalg`` in float64 at the paths' shapes and on the cells' own
basis matrices, its NaN lanes, and a lane's bits alone, elsewhere in the
batch and in a second run.  This file imports neither JAX nor the
reference package; on a machine with a card run

    python -m pytest --noconftest -q tests/test_torch_lu_kernel.py
"""

import pytest
import torch

from linprog_tpu_torch import engine
from linprog_tpu_torch import observability as obs
from linprog_tpu_torch.batch import solve_batch_bounded, solve_batch_two_phase
from linprog_tpu_torch.config import SolverConfig
from linprog_tpu_torch.engine import basis_matrix
from linprog_tpu_torch.generators import (
    device_bounded_lps,
    device_inequality_lps,
    device_standard_form_batch,
    random_inequality_lps,
)
from linprog_tpu_torch.ops import lu_kernel


def _lapack_rows(M):
    """The row of ``M`` at each position after ``lu_factor``'s
    interchanges, ``[B, m]``."""
    _, piv = torch.linalg.lu_factor(M)
    B, m, _ = M.shape
    perm = torch.arange(m).expand(B, m).clone()
    for b in range(B):
        for k in range(m):
            j = int(piv[b, k]) - 1
            perm[b, [k, j]] = perm[b, [j, k]]
    return perm


def _randn(B, m, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((B, m, m), generator=gen, dtype=dtype)


# ---- CPU: the plain version --------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 7, 16, 33, 64])
def test_plain_pivot_rows_are_lapacks(m):
    M = _randn(6, m, seed=m)
    assert torch.equal(lu_kernel.pivot_rows(M), _lapack_rows(M))


def test_plain_ties_go_to_the_lowest_logical_row():
    """Column 0 takes row 2, which LAPACK swaps with row 0; column 1 then
    ties |5| between rows 0 and 1, and the lower LOGICAL position is row
    1's (row 0 now sits at position 2)."""
    M = torch.tensor([[[1.0, 5.0, 0.0], [1.0, -5.0, 1.0], [3.0, 0.0, 0.0]],
                      [[2.0, 1.0, 0.0], [-2.0, 3.0, 0.0], [1.0, 1.0, 1.0]]])
    rows = lu_kernel.pivot_rows(M)
    assert rows.tolist() == [[2, 1, 0], [0, 1, 2]]
    assert torch.equal(rows, _lapack_rows(M))


@pytest.mark.parametrize("m", [1, 3, 16, 50, 130])
def test_plain_inverse_and_solve_match_linalg(m):
    M = _randn(5, m, seed=100 + m)
    rhs = torch.randn((5, m), generator=torch.Generator().manual_seed(m))
    want = torch.linalg.inv(M.double())
    got = lu_kernel.inverse(M)
    assert got.dtype == torch.float32 and got.shape == (5, m, m)
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got.double() - want).abs() / scale).max() < 2e-4
    xw = torch.linalg.solve(M.double(), rhs.double()[:, :, None])[..., 0]
    x = lu_kernel.solve(M, rhs)
    assert x.shape == (5, m)
    assert ((x.double() - xw).abs().amax(dim=1)
            / xw.abs().amax(dim=1)).max() < 2e-4
    # a transposed view solves the transposed system
    xt = lu_kernel.solve(M.transpose(1, 2), rhs)
    xtw = torch.linalg.solve(M.double().transpose(1, 2),
                             rhs.double()[:, :, None])[..., 0]
    assert ((xt.double() - xtw).abs().amax(dim=1)
            / xtw.abs().amax(dim=1)).max() < 2e-4


@pytest.mark.parametrize("kind", ["zero_column", "equal_rows", "zero"])
def test_plain_zero_pivot_lanes_are_nan(kind):
    M = _randn(4, 6, seed=9)
    if kind == "zero_column":
        M[1, :, 2] = 0.0
    elif kind == "equal_rows":
        M[1, 4] = M[1, 0]
    else:
        M[1] = 0.0
    rhs = torch.ones((4, 6))
    for out in (lu_kernel.inverse(M), lu_kernel.solve(M, rhs)):
        flat = out.reshape(4, -1)
        if kind != "equal_rows":  # rounding may leave that pivot nonzero
            assert torch.isnan(flat[1]).all()
        assert torch.isfinite(flat[[0, 2, 3]]).all()
    assert torch.isnan(lu_kernel.inverse(M[1:2] * 0.0)).all()


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_plain_non_finite_input_stays_non_finite(bad):
    M = _randn(3, 8, seed=4)
    M[2, 5, 3] = bad
    inv = lu_kernel.inverse(M)
    x = lu_kernel.solve(M, torch.ones((3, 8)))
    assert not torch.isfinite(inv[2]).all() and not torch.isfinite(x[2]).all()
    assert torch.isfinite(inv[:2]).all() and torch.isfinite(x[:2]).all()


def test_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        lu_kernel.inverse(torch.zeros((2, 3, 4)))
    with pytest.raises(ValueError):
        lu_kernel.solve(torch.zeros((2, 3, 3)), torch.zeros((2, 4)))


# ---- CPU: the routing rule and the counters ----------------------------------

@pytest.mark.parametrize("device,dtype,m,taken", [
    ("cuda", torch.float32, 1, True),
    ("cuda", torch.float32, 250, True),
    ("cuda", torch.float32, 256, True),
    ("cuda", torch.float32, 257, False),
    ("cuda", torch.float32, 1024, False),
    ("cuda", torch.float32, 0, False),
    ("cuda", torch.float64, 256, False),
    ("cpu", torch.float32, 256, False),
    ("cpu", torch.float64, 16, False),
])
def test_routing_rule(device, dtype, m, taken):
    assert lu_kernel.takes(device, dtype, m) is taken


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_helpers_keep_torch_linalg_bits(dtype):
    """CPU tensors (the parity tests' inputs) keep ``torch.linalg``'s bits
    and launch nothing."""
    M = _randn(4, 12, seed=21, dtype=dtype)
    M[2, :, 5] = 0.0  # a singular lane: NaN, as before
    rhs = torch.randn((4, 12), dtype=dtype)
    launched, library = lu_kernel.launches, engine.library_calls
    inv, info = torch.linalg.inv_ex(M)
    want = torch.where((info != 0)[:, None, None], float("nan"), inv)
    got = engine.inv_or_nan(M)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.isnan(got[2]).all()
    x, info = torch.linalg.solve_ex(M, rhs[:, :, None])
    want = torch.where((info != 0)[:, None], float("nan"), x[:, :, 0])
    got = engine.solve_or_nan(M, rhs)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert (lu_kernel.launches, engine.library_calls) == (launched, library)


def _two_phase():
    c, G, h = (torch.tensor(a) for a in random_inequality_lps(8, 16, 16,
                                                              seed=3))
    cfg = SolverConfig(pricing="dantzig", refactor_every=16, polish_pivots=4)
    return solve_batch_two_phase(*device_standard_form_batch(c, G, h), 200,
                                 200, cfg)


def _bounded():
    gen = torch.Generator().manual_seed(5)
    prob = device_bounded_lps(gen, 8, 12, 12, "cpu")
    basis = torch.arange(12, 24, dtype=torch.int32).expand(8, 12).clone()
    vs = torch.cat([torch.zeros((8, 12), dtype=torch.int8),
                    torch.full((8, 12), 2, dtype=torch.int8)], dim=1)
    cfg = SolverConfig(pricing="dantzig", refactor_every=16, polish_pivots=8)
    return solve_batch_bounded(*prob, basis, vs, 400, cfg)


@pytest.mark.parametrize("entry,run", [("solve_batch_two_phase", _two_phase),
                                       ("solve_batch_bounded", _bounded)])
def test_root_span_notes_the_batched_lu(entry, run, monkeypatch):
    """On the CPU the root span reads ``lu_launches`` 0 and ``lu_library``
    0; with the kernel's rule widened to CPU tensors (its plain version
    then serves them) and each wrapper call counted as a launch,
    ``lu_launches`` is the number of factorizations in the call."""
    obs.stop()
    rec = obs.start()
    try:
        run()
        (call,) = rec.calls()
        assert call[0].name == entry
        assert call[0].counts["lu_launches"] == 0
        assert call[0].counts["lu_library"] == 0

        calls = []
        for name in ("inverse", "solve"):
            real = getattr(lu_kernel, name)

            def counted(*a, _real=real, **kw):
                calls.append(1)
                lu_kernel.launches += 1
                return _real(*a, **kw)
            monkeypatch.setattr(lu_kernel, name, counted)
        monkeypatch.setattr(lu_kernel, "takes",
                            lambda device, dtype, m: dtype == torch.float32)
        run()
        call = rec.calls()[-1]
        assert call[0].counts["lu_launches"] == len(calls) > 0
        assert call[0].counts["lu_library"] == 0
    finally:
        obs.stop()


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lane_err(got, want):
    """max|got - want| / max|want| of each lane, float64 on the host."""
    d = (got.double() - want).abs().reshape(got.shape[0], -1).amax(dim=1)
    return (d / want.abs().reshape(got.shape[0], -1).amax(dim=1)).cpu()


def _hold_to_library(M, rhs):
    """The kernel's largest and median error over lanes at most twice
    ``torch.linalg``'s in float32, both against float64 on the card."""
    inv_ref = torch.linalg.inv(M.double())
    x_ref = torch.linalg.solve(M.double(), rhs.double()[:, :, None])[..., 0]
    lib_inv = torch.linalg.inv_ex(M)[0]
    lib_x = torch.linalg.solve_ex(M, rhs[:, :, None])[0][..., 0]
    for got, lib, ref in ((lu_kernel.inverse(M), lib_inv, inv_ref),
                          (lu_kernel.solve(M, rhs), lib_x, x_ref)):
        assert torch.isfinite(got).all()
        e, e_lib = _lane_err(got, ref), _lane_err(lib, ref)
        assert e.max() <= 2 * e_lib.max(), (e.max(), e_lib.max())
        assert e.median() <= 2 * e_lib.median(), (e.median(), e_lib.median())


@pytest.mark.card
@pytest.mark.parametrize("B,m", [(1024, 256), (8, 256), (1, 256),
                                 (1024, 128), (64, 250)])
def test_kernel_error_within_twice_the_librarys(cuda, B, m):
    gen = torch.Generator(device=cuda).manual_seed(B + m)
    M = torch.randn((B, m, m), generator=gen, device=cuda)
    rhs = torch.randn((B, m), generator=gen, device=cuda)
    launched = lu_kernel.launches
    _hold_to_library(M, rhs)
    assert lu_kernel.launches == launched + 2


@pytest.mark.card
def test_kernel_on_the_cells_basis_matrices(cuda):
    """A crossover's basis guess (the m largest of ``[x; s]`` after the
    IPM, as ``crossover_batch_canonical`` takes it) and the two-phase
    simplex's final bases, at m = 256."""
    from linprog_tpu_torch.ipm import ipm_solve_batch_canonical

    gen = torch.Generator(device=cuda).manual_seed(2101)
    c, G, h = device_inequality_lps(gen, 256, 256, 256, cuda)
    res = ipm_solve_batch_canonical(c, G, h)
    B, m, n = G.shape
    eye = torch.eye(m, device=cuda).expand(B, m, m)
    As = torch.cat([G, eye], dim=2)
    x = res.x[:, :n]
    s = h - torch.einsum("bmn,bn->bm", G, x)
    xs = torch.cat([x.clamp_min(0.0), s.clamp_min(0.0)], dim=1)
    guess = torch.sort(torch.topk(xs, m, dim=1).indices, dim=1).values
    _hold_to_library(basis_matrix(As, guess), h)

    cs, A, b = device_standard_form_batch(c[:64], G[:64], h[:64])
    two = solve_batch_two_phase(cs, A, b, 2000, 2000,
                                SolverConfig(pricing="dantzig",
                                             refactor_every=64))
    _hold_to_library(basis_matrix(A, two.basis), b)


@pytest.mark.card
@pytest.mark.parametrize("m", [20, 256])
def test_kernel_nan_lanes(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(m)
    M = torch.randn((6, m, m), generator=gen, device=cuda)
    rhs = torch.randn((6, m), generator=gen, device=cuda)
    M[1, :, m // 2] = 0.0  # a zero column: a zero pivot
    M[4, m - 1, 3] = float("nan")
    inv, x = lu_kernel.inverse(M), lu_kernel.solve(M, rhs)
    assert torch.isnan(inv[1]).all() and torch.isnan(x[1]).all()
    assert not torch.isfinite(inv[4]).all()
    assert not torch.isfinite(x[4]).all()
    good = [0, 2, 3, 5]
    assert torch.isfinite(inv[good]).all() and torch.isfinite(x[good]).all()
    # the good lanes' bits do not depend on their neighbours
    assert torch.equal(lu_kernel.inverse(M[good]), inv[good])
    assert torch.equal(lu_kernel.solve(M[good], rhs[good]), x[good])


@pytest.mark.card
@pytest.mark.parametrize("m", [7, 128, 200, 256])
def test_kernel_lane_bits_alone_moved_and_rerun(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(7 * m)
    M = torch.randn((33, m, m), generator=gen, device=cuda)
    rhs = torch.randn((33, m), generator=gen, device=cuda)
    inv, x = lu_kernel.inverse(M), lu_kernel.solve(M, rhs)
    assert torch.equal(lu_kernel.inverse(M), inv)
    assert torch.equal(lu_kernel.solve(M, rhs), x)
    perm = torch.randperm(33, generator=torch.Generator().manual_seed(m))
    perm = perm.to(cuda)
    assert torch.equal(lu_kernel.inverse(M[perm]), inv[perm])
    assert torch.equal(lu_kernel.solve(M[perm], rhs[perm]), x[perm])
    for lane in (0, 17, 32):
        assert torch.equal(lu_kernel.inverse(M[lane:lane + 1]),
                           inv[lane:lane + 1])
        assert torch.equal(lu_kernel.solve(M[lane:lane + 1],
                                           rhs[lane:lane + 1]),
                           x[lane:lane + 1])
    # a transposed view reads M in place: the contiguous copy's bits
    assert torch.equal(lu_kernel.solve(M.transpose(1, 2), rhs),
                       lu_kernel.solve(M.transpose(1, 2).contiguous(), rhs))


@pytest.mark.card
def test_kernel_against_plain_and_pivots(cuda):
    """The plain version on the card agrees with the kernel to float32
    rounding at m = 256, and takes LAPACK's pivot rows."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    M = torch.randn((16, 256, 256), generator=gen, device=cuda)
    rhs = torch.randn((16, 256), generator=gen, device=cuda)
    ref = torch.linalg.inv(M.double())
    assert _lane_err(lu_kernel._plain(M), ref).max() < 1e-3
    assert _lane_err(lu_kernel.inverse(M), ref).max() < 1e-3
    xr = torch.linalg.solve(M.double(), rhs.double()[:, :, None])[..., 0]
    assert _lane_err(lu_kernel._plain(M, rhs), xr).max() < 1e-3
    assert torch.equal(lu_kernel.pivot_rows(M[:4].cpu()),
                       _lapack_rows(M[:4].cpu()))


@pytest.mark.card
def test_helpers_route_by_device_dtype_and_m(cuda):
    M = torch.randn((4, 256, 256), device=cuda)
    rhs = torch.randn((4, 256), device=cuda)
    launched, library = lu_kernel.launches, engine.library_calls
    assert torch.equal(engine.inv_or_nan(M), lu_kernel.inverse(M))
    assert torch.equal(engine.solve_or_nan(M, rhs), lu_kernel.solve(M, rhs))
    assert lu_kernel.launches == launched + 4
    assert engine.library_calls == library
    engine.inv_or_nan(M.double())
    engine.solve_or_nan(torch.randn((2, 300, 300), device=cuda),
                        torch.randn((2, 300), device=cuda))
    assert lu_kernel.launches == launched + 4
    assert engine.library_calls == library + 2
