"""linprog_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card.  Every test skips where ``torch.cuda.is_available()`` is
False.  On a machine with a CUDA device and no JAX, run

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(``tests/conftest.py`` configures JAX for the reference's CPU suite; this
file imports neither JAX nor the reference package.)
"""

import numpy as np
import pytest
import torch

from linprog_tpu_torch import status as st
from linprog_tpu_torch.engine import basis_matrix, solve_or_nan
from linprog_tpu_torch.generators import random_inequality_lps
from linprog_tpu_torch.ops import cholinv_kernel, solve_kernel, stream_kernel
from linprog_tpu_torch.ops.solve_kernel import SegmentState


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _slack_instance(B, m, n, seed, dual, dev, degenerate=True):
    """[G | I] from the slack basis.  ``degenerate`` zeroes every other rhs
    (primal mode) or every third cost (dual mode), so zero-progress pivots
    occur and stall escalation fires."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    if dual:
        c = np.abs(c)
        if degenerate:
            c[:, ::3] = 0.0
    else:
        h = np.abs(h)
        if degenerate:
            h[:, ::2] = 0.0
    A = np.concatenate([G, np.broadcast_to(np.eye(m, dtype=np.float32),
                                           (B, m, m))], axis=2)
    cs = np.concatenate([c, np.zeros((B, m), np.float32)], axis=1)
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    pen = np.zeros((B, n + m), np.float32)
    pen[:, n:] = np.inf
    state = SegmentState(
        invBT=t(np.broadcast_to(np.eye(m, dtype=np.float32), (B, m, m))),
        bfs=t(h), cB=t(np.zeros((B, m), np.float32)),
        basis=t(np.broadcast_to(np.arange(n, n + m, dtype=np.int32), (B, m))),
        pen=t(pen), gamma=t(np.ones((B, n + m), np.float32)),
        iters=t(np.zeros(B, np.int32)), status=t(np.zeros(B, np.int32)),
    )
    return t(A), t(cs), t(np.zeros((B, n + m), np.float32)), t(h), state


def _modes(fn):
    """Parametrize over primal/dual x bland/dantzig x unpacked/packed."""
    fn = pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])(fn)
    fn = pytest.mark.parametrize("pricing", [0, 1], ids=["bland", "dantzig"])(fn)
    return pytest.mark.parametrize("packed", [False, True],
                                   ids=["unpacked", "packed"])(fn)


def _both(A, c, apen, state0, **kw):
    """The kernel and the plain version from copies of one state."""
    before = solve_kernel.launches
    k = solve_kernel.solve_segment(A, c, apen, 512,
                                   SegmentState(*(t.clone() for t in state0)),
                                   **kw)
    p = solve_kernel.solve_segment_plain(
        A, c, apen, 512, SegmentState(*(t.clone() for t in state0)), **kw)
    torch.cuda.synchronize()
    assert solve_kernel.launches == before + 1
    return k, p


@_modes
def test_segment_kernel_matches_plain(cuda, dual, pricing, packed):
    """16 pivots on degenerate lanes with stall escalation at 2: the same
    basis, status, iteration count, c_B and penalties on every lane, and a
    factor and basic values as accurate as the plain version's.  Accuracy
    is the float64 residual against the (shared) final basis: the versions
    sum in different orders, and small pivots amplify that difference to
    ~1e-5 of the factor's scale, so the factors are not compared entry by
    entry.  Longer degenerate runs split where summation order flips a
    near tie, so the segment is kept short; on these instances escalation
    changes the dantzig path of every lane within it."""
    A, c, apen, h, state0 = _slack_instance(64, 32, 48, seed=pricing + 2 * dual,
                                            dual=dual, dev=cuda)
    kw = dict(seg_len=16, pricing=pricing, opt_tol=1e-6, pivot_tol=1e-7,
              dual=dual, feas_tol=1e-6, stall_limit=2, packed=packed)
    k, p = _both(A, c, apen, state0, **kw)
    for name in ("basis", "status", "iters", "pen", "cB"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=0, atol=0)
    Bm = basis_matrix(A, p.basis).double()
    eye = torch.eye(Bm.shape[1], dtype=torch.float64, device=cuda)

    def residuals(s):
        f = (Bm @ s.invBT.transpose(1, 2).double() - eye).abs().amax()
        x = (torch.einsum("bij,bj->bi", Bm, s.bfs.double())
             - h.double()).abs().amax()
        return f.item(), x.item()

    (fk, xk), (fp, xp) = residuals(k), residuals(p)
    assert fk <= 2.0 * fp + 1e-6, (fk, fp)
    assert xk <= 2.0 * xp + 1e-6, (xk, xp)
    if pricing == 1:
        p0 = solve_kernel.solve_segment_plain(
            A, c, apen, 512, SegmentState(*(t.clone() for t in state0)),
            **dict(kw, stall_limit=0))
        assert bool((p0.basis != p.basis).any())


@_modes
def test_segment_kernel_full_run_matches_plain(cuda, dual, pricing, packed):
    """Nondegenerate lanes run to optimality in one segment: every lane
    OPTIMAL in both versions, and the same objective (exact solve at the
    final basis) to 1e-5 relative."""
    A, c, apen, h, state0 = _slack_instance(64, 32, 48, seed=pricing + 2 * dual,
                                            dual=dual, dev=cuda,
                                            degenerate=False)
    k, p = _both(A, c, apen, state0, seg_len=512, pricing=pricing,
                 opt_tol=1e-6, pivot_tol=1e-7, dual=dual, feas_tol=1e-6,
                 stall_limit=2, packed=packed)
    assert bool((k.status == st.OPTIMAL).all())
    assert bool((p.status == st.OPTIMAL).all())

    def objective(s):
        xB = solve_or_nan(basis_matrix(A, s.basis), h)
        return (torch.gather(c, 1, s.basis.long()).double() * xB.double()).sum(1)

    ok, op = objective(k), objective(p)
    assert ((ok - op).abs() / op.abs().clamp_min(1.0)).max().item() <= 1e-5


def test_segment_kernel_one_iteration_is_exact(cuda):
    """One bland iteration from the slack basis: duals are exactly zero, so
    pricing involves no sums and the kernel must reproduce the plain
    version bit for bit."""
    A, c, apen, h, state0 = _slack_instance(64, 32, 48, seed=7, dual=False,
                                            dev=cuda)
    kw = dict(seg_len=1, pricing=0, opt_tol=1e-6, pivot_tol=1e-7)
    k = solve_kernel.solve_segment(A, c, apen, 10,
                                   SegmentState(*(t.clone() for t in state0)),
                                   **kw)
    p = solve_kernel.solve_segment_plain(
        A, c, apen, 10, SegmentState(*(t.clone() for t in state0)), **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_segment_kernel_negative_zero_ratio_ties_at_lowest_row(cuda):
    """A basic value of -0.0 ratios to +0.0 (the reference's semantics), so
    the tie at zero goes to row 0 in the kernel as in the plain version."""
    A = torch.tensor([[[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 1.0]]],
                     device=cuda)
    c = torch.tensor([[-1.0, 0.0, 0.0, 0.0]], device=cuda)
    inf = float("inf")
    state0 = SegmentState(
        invBT=torch.eye(2, device=cuda)[None].contiguous(),
        bfs=torch.tensor([[0.0, -0.0]], device=cuda),
        cB=torch.zeros((1, 2), device=cuda),
        basis=torch.tensor([[2, 3]], dtype=torch.int32, device=cuda),
        pen=torch.tensor([[0.0, 0.0, inf, inf]], device=cuda),
        gamma=torch.ones((1, 4), device=cuda),
        iters=torch.zeros(1, dtype=torch.int32, device=cuda),
        status=torch.zeros(1, dtype=torch.int32, device=cuda),
    )
    k, p = _both(A, c, torch.zeros_like(c), state0, seg_len=1, pricing=1,
                 opt_tol=1e-6, pivot_tol=1e-7, packed=True)
    assert k.basis.tolist() == p.basis.tolist() == [[0, 3]]


def test_segment_kernel_refuses_devex(cuda):
    A, c, apen, h, state = _slack_instance(4, 8, 8, seed=0, dual=False, dev=cuda)
    with pytest.raises(NotImplementedError):
        solve_kernel.solve_segment(A, c, apen, 10, state, seg_len=4,
                                   pricing=2, opt_tol=1e-6, pivot_tol=1e-7)


@pytest.mark.parametrize("mb", [8, 16, 32, 64])
def test_panel_kernel_matches_plain(cuda, mb):
    """The kernel takes the same IEEE-rounded steps as the plain version
    (no FMA contraction, 1/sqrt), so the two agree to the last bit."""
    rng = np.random.default_rng(mb)
    X = rng.normal(size=(96, mb, mb)).astype(np.float32)
    M = X @ np.swapaxes(X, 1, 2) + mb * np.eye(mb, dtype=np.float32)
    M[5] = -M[5]  # non-SPD lane
    Mt = torch.tensor(M, device=cuda)
    before = cholinv_kernel.launches
    W = cholinv_kernel.panel_cholinv(Mt)
    Wp = cholinv_kernel.panel_cholinv_plain(Mt)
    torch.cuda.synchronize()
    assert cholinv_kernel.launches == before + 1
    good = torch.ones(96, dtype=torch.bool, device=cuda)
    good[5] = False
    assert not bool(torch.isfinite(W[5]).all())
    torch.testing.assert_close(W[good], Wp[good], rtol=0, atol=0)


def test_exact_pipeline_on_card_matches_cpu(cuda):
    """solve_batch_exact on the card (kernels) against the CPU run (plain
    versions) of the same instances: same statuses, objectives to 1e-5."""
    import linprog_tpu_torch as lt

    c, G, h = (torch.tensor(a) for a in random_inequality_lps(16, 32, 32, seed=5))
    res_cpu, _ = lt.solve_batch_exact(c, G, h)
    res, info = lt.solve_batch_exact(c.to(cuda), G.to(cuda), h.to(cuda))
    assert info["crossed"] + info["fallback"] == 16
    np.testing.assert_array_equal(res.status.cpu().numpy(),
                                  res_cpu.status.numpy())
    rel = ((res.cost.cpu() - res_cpu.cost).abs()
           / res_cpu.cost.abs().clamp_min(1.0)).max().item()
    assert rel <= 1e-5
    cert = lt.certify_vertex_batch(c.to(cuda), G.to(cuda), h.to(cuda),
                                   res.basis)
    assert int(cert["certified"].sum()) >= 15


def _stream_both(A, c, apen, state0, **kw):
    """The cluster kernel and its plain version from copies of one state."""
    before = stream_kernel.launches
    k = stream_kernel.solve_segment_stream(
        A, c, apen, 512, SegmentState(*(t.clone() for t in state0)), **kw)
    p = stream_kernel.solve_segment_stream_plain(
        A, c, apen, 512, SegmentState(*(t.clone() for t in state0)), **kw)
    torch.cuda.synchronize()
    assert stream_kernel.launches == before + 1
    return k, p


def _residuals(A, h, s):
    """float64 max residuals of the factor and the basic values against
    the final basis."""
    Bm = basis_matrix(A, s.basis).double()
    eye = torch.eye(Bm.shape[1], dtype=torch.float64, device=A.device)
    f = (Bm @ s.invBT.transpose(1, 2).double() - eye).abs().amax()
    x = (torch.einsum("bij,bj->bi", Bm, s.bfs.double()) - h.double()).abs().amax()
    return f.item(), x.item()


def _assert_lockstep(A, h, k, p):
    for name in ("basis", "status", "iters", "pen", "cB"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=0, atol=0)
    (fk, xk), (fp, xp) = _residuals(A, h, k), _residuals(A, h, p)
    assert fk <= 2.0 * fp + 1e-6, (fk, fp)
    assert xk <= 2.0 * xp + 1e-6, (xk, xp)


@pytest.mark.parametrize("degenerate", [True, False],
                         ids=["degenerate", "nondegenerate"])
@_modes
def test_stream_kernel_matches_plain(cuda, dual, pricing, packed, degenerate):
    """16 pivots of the cluster kernel in lockstep with the plain version
    (stall escalation at 2): the same basis, status, iteration count, c_B
    and penalties on every lane, and a factor and basic values as accurate
    as the plain version's by float64 residual (the versions sum in
    different orders, so factors are not compared entry by entry).  These
    are the instances of the whole-segment kernel's lockstep test; each
    CTA owns 4 rows and 10 columns, so the direction splits its rows over
    groups of threads."""
    A, c, apen, h, state0 = _slack_instance(64, 32, 48, seed=pricing + 2 * dual,
                                            dual=dual, dev=cuda,
                                            degenerate=degenerate)
    k, p = _stream_both(A, c, apen, state0, seg_len=16, pricing=pricing,
                        opt_tol=1e-6, pivot_tol=1e-7, dual=dual,
                        feas_tol=1e-6, stall_limit=2, packed=packed)
    _assert_lockstep(A, h, k, p)
    assert bool((k.iters > 0).any())


@pytest.mark.parametrize("m,n", [(37, 50), (5, 6), (3, 2)],
                         ids=["ragged", "m5", "m3"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_stream_kernel_ragged_and_tiny_lanes(cuda, m, n, dual):
    """Slices of unequal length (m, n + m not divisible by 8) and lanes
    smaller than the cluster (CTAs with empty slices) run nondegenerate
    instances to the end in lockstep with the plain version."""
    A, c, apen, h, state0 = _slack_instance(16, m, n, seed=m + dual,
                                            dual=dual, dev=cuda,
                                            degenerate=False)
    k, p = _stream_both(A, c, apen, state0, seg_len=512, pricing=1,
                        opt_tol=1e-6, pivot_tol=1e-7, dual=dual,
                        feas_tol=1e-6, stall_limit=24, packed=True)
    _assert_lockstep(A, h, k, p)
    assert bool((k.status != st.RUNNING).all())


def test_stream_kernel_negative_zero_ratio_ties_at_lowest_row(cuda):
    """A basic value of -0.0 ratios to +0.0 in every CTA's partial key, so
    the tie at zero goes to row 0 as in the plain version."""
    A = torch.tensor([[[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 1.0]]],
                     device=cuda)
    c = torch.tensor([[-1.0, 0.0, 0.0, 0.0]], device=cuda)
    inf = float("inf")
    state0 = SegmentState(
        invBT=torch.eye(2, device=cuda)[None].contiguous(),
        bfs=torch.tensor([[0.0, -0.0]], device=cuda),
        cB=torch.zeros((1, 2), device=cuda),
        basis=torch.tensor([[2, 3]], dtype=torch.int32, device=cuda),
        pen=torch.tensor([[0.0, 0.0, inf, inf]], device=cuda),
        gamma=torch.ones((1, 4), device=cuda),
        iters=torch.zeros(1, dtype=torch.int32, device=cuda),
        status=torch.zeros(1, dtype=torch.int32, device=cuda),
    )
    k, p = _stream_both(A, c, torch.zeros_like(c), state0, seg_len=1,
                        pricing=1, opt_tol=1e-6, pivot_tol=1e-7, packed=True)
    assert k.basis.tolist() == p.basis.tolist() == [[0, 3]]


def test_stream_kernel_refuses_devex_and_blocked_dual(cuda):
    A, c, apen, h, state = _slack_instance(4, 8, 8, seed=0, dual=False, dev=cuda)
    kw = dict(seg_len=4, opt_tol=1e-6, pivot_tol=1e-7)
    before = stream_kernel.launches
    with pytest.raises(ValueError, match="devex"):
        stream_kernel.solve_segment_stream(A, c, apen, 10, state, pricing=2,
                                           **kw)
    with pytest.raises(ValueError, match="primal only"):
        stream_kernel.solve_segment_stream(A, c, apen, 10, state, pricing=1,
                                           dual=True, factor_blocked=True,
                                           **kw)
    assert stream_kernel.launches == before


def test_exact_large_m_route_on_card_matches_cpu(cuda, monkeypatch):
    """solve_batch_exact on the large-m route (boundary shrunk to 8, every
    segment on the streaming kernel, a one-pivot budget so the retry and
    the fallback run) on the card against the CPU run of the same
    instances: the same statuses and objectives to 1e-5."""
    import linprog_tpu_torch as lt
    import linprog_tpu_torch.engine_batched as teb
    from linprog_tpu_torch import calibration

    monkeypatch.setattr(teb, "_mega_kernel_fits",
                        lambda m, n, with_at, **kw: False)
    table = calibration.get_table()
    table["xover_pallas_max_m"] = 8
    calibration.set_table({"default": table})
    try:
        c, G, h = (torch.tensor(a) for a in random_inequality_lps(8, 24, 24, seed=58))
        res_cpu, info_cpu = lt.solve_batch_exact(c, G, h, maxiters=1)
        before = stream_kernel.launches
        res, info = lt.solve_batch_exact(c.to(cuda), G.to(cuda), h.to(cuda),
                                         maxiters=1)
    finally:
        calibration.reset_table()
    assert stream_kernel.launches > before
    assert info["crossed"] + info["fallback"] == 8
    np.testing.assert_array_equal(res.status.cpu().numpy(),
                                  res_cpu.status.numpy())
    rel = ((res.cost.cpu() - res_cpu.cost).abs()
           / res_cpu.cost.abs().clamp_min(1.0)).max().item()
    assert rel <= 1e-5


@pytest.mark.parametrize("kernel,m,n", [("stream", 2048, 4096),
                                        ("segment", 256, 2368)],
                         ids=["stream", "segment"])
def test_kernels_launch_at_48kb_of_dynamic_shared_memory(cuda, kernel, m, n):
    """Shapes whose vectors take exactly 48 KB of dynamic shared memory
    (the stream kernel at the two-phase fallback shape of m = 2048): with
    the static shared memory on top they need the opt-in limit, which
    both wrappers set at every launch."""
    A, c, apen, h, state0 = _slack_instance(2, m, n, seed=1, dual=False,
                                            dev=cuda, degenerate=False)
    kw = dict(seg_len=2, pricing=1, opt_tol=1e-6, pivot_tol=1e-7,
              packed=True)
    if kernel == "stream":
        from linprog_tpu_torch.ops import _build

        assert _build.library().lp_solve_segment_stream_smem(m, n + m) == 48 * 1024
        k, p = _stream_both(A, c, apen, state0, **kw)
    else:
        assert (7 * m + 4 * (n + m)) * 4 == 48 * 1024
        k, p = _both(A, c, apen, state0, **kw)
    torch.testing.assert_close(k.basis, p.basis, rtol=0, atol=0)
    assert bool((k.iters == 2).all())
