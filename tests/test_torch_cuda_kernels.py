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

from linprog_tpu_torch import observability as obs
from linprog_tpu_torch import refine
from linprog_tpu_torch import status as st
from linprog_tpu_torch.engine import basis_matrix, solve_or_nan
from linprog_tpu_torch.generators import (
    device_bounded_lps,
    device_inequality_lps,
    device_standard_form_batch,
    random_inequality_lps,
)
from linprog_tpu_torch.ops import (
    bounded_kernel,
    cholinv_kernel,
    dd_kernel,
    solve_kernel,
    step_kernels,
    stream_kernel,
)
from linprog_tpu_torch.ops.bounded_kernel import BoundedSegmentState
from linprog_tpu_torch.ops.plans import SegmentPlan, StreamingPlan, resident
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


def _both_modes(fn):
    """Parametrize over primal/dual x unpacked/packed."""
    fn = pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])(fn)
    return pytest.mark.parametrize("packed", [False, True],
                                   ids=["unpacked", "packed"])(fn)


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


@pytest.mark.parametrize("seg_len", [1, 16], ids=["one", "sixteen"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_segment_kernel_devex_matches_plain(cuda, dual, seg_len):
    """Devex on nondegenerate lanes, one iteration and a 16-pivot segment:
    the same basis, status, iteration count, c_B and penalties; weights
    within 1e-4 relative (their products amplify summation-order noise);
    factors by float64 residual.  The weights moved off 1 on some lane."""
    A, c, apen, h, state0 = _slack_instance(64, 32, 48, seed=21 + dual,
                                            dual=dual, dev=cuda,
                                            degenerate=False)
    k, p = _both(A, c, apen, state0, seg_len=seg_len, pricing=2,
                 opt_tol=1e-6, pivot_tol=1e-7, dual=dual, feas_tol=1e-6,
                 stall_limit=24, packed=False)
    _assert_lockstep(A, h, k, p)
    torch.testing.assert_close(k.gamma, p.gamma, rtol=1e-4, atol=1e-6)
    assert bool((k.gamma != 1.0).any())
    assert bool((k.iters == seg_len).any())


def test_segment_kernel_refuses_an_unknown_pricing_code(cuda):
    A, c, apen, h, state = _slack_instance(4, 8, 8, seed=0, dual=False, dev=cuda)
    before = solve_kernel.launches
    with pytest.raises(ValueError, match="pricing"):
        solve_kernel.solve_segment(A, c, apen, 10, state, seg_len=4,
                                   pricing=3, opt_tol=1e-6, pivot_tol=1e-7)
    assert solve_kernel.launches == before


@pytest.mark.parametrize("B", [1, 64, 1024])
@pytest.mark.parametrize("mb", [1, 5, 16, 31, 32, 33, 48, 64])
def test_panel_kernel_matches_plain(cuda, mb, B):
    """The warp-per-matrix kernel (mb <= 32, odd sizes masked) and the
    block-per-matrix kernel (mb > 32) take the same IEEE-rounded steps as
    the plain version (no FMA contraction, 1/sqrt), so they agree to the
    last bit; a planted non-SPD lane comes out non-finite in both."""
    rng = np.random.default_rng(mb)
    X = rng.normal(size=(B, mb, mb)).astype(np.float32)
    M = X @ np.swapaxes(X, 1, 2) + mb * np.eye(mb, dtype=np.float32)
    bad = min(5, B - 1)
    M[bad] = -M[bad]  # non-SPD lane
    Mt = torch.tensor(M, device=cuda)
    before = cholinv_kernel.launches
    W = cholinv_kernel.panel_cholinv(Mt)
    Wp = cholinv_kernel.panel_cholinv_plain(Mt)
    torch.cuda.synchronize()
    assert cholinv_kernel.launches == before + 1
    good = torch.ones(B, dtype=torch.bool, device=cuda)
    good[bad] = False
    assert not bool(torch.isfinite(W[bad]).all())
    assert not bool(torch.isfinite(Wp[bad]).all())
    assert bool(torch.isfinite(W[good]).all())
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


def _stream_both(A, c, apen, state0, maxiters=512, **kw):
    """The cluster kernel and its plain version from copies of one state."""
    before = stream_kernel.launches
    k = stream_kernel.solve_segment_stream(
        A, c, apen, maxiters, SegmentState(*(t.clone() for t in state0)), **kw)
    p = stream_kernel.solve_segment_stream_plain(
        A, c, apen, maxiters, SegmentState(*(t.clone() for t in state0)),
        **kw)
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


@pytest.mark.parametrize("kernel,m,n", [("stream", 2000, 1355),
                                        ("segment", 520, 2451),
                                        ("segment-cluster", 16, 910)],
                         ids=["stream", "segment", "segment-cluster"])
def test_kernels_launch_at_48kb_of_dynamic_shared_memory(cuda, kernel, m, n):
    """Shapes whose dynamic shared memory is exactly 48 KB (the stream
    kernel on its scalar branch, which has no ring, at a ragged (2000,
    3355); the segment kernel's streaming branch at a ragged (520, 2971),
    past the largest cluster, on its scalar branch at 8 CTAs a lane with
    its vectors alone; its cluster-resident branch at (16, 926) at 2 CTAs a
    lane): with the static shared memory on top they need the opt-in
    limit, which the wrappers set at every launch."""
    A, c, apen, h, state0 = _slack_instance(2, m, n, seed=1, dual=False,
                                            dev=cuda, degenerate=False)
    kw = dict(seg_len=2, pricing=1, opt_tol=1e-6, pivot_tol=1e-7,
              packed=True)
    if kernel == "stream":
        k, p = _stream_both(A, c, apen, state0, **kw)
        assert not stream_kernel.last_plan.aligned
        assert stream_kernel.last_plan.smem_bytes == 48 * 1024
    elif kernel == "segment":
        plan = solve_kernel.large_scalar_plan(8, m, n + m)
        floats = (3 * m + 3 * (n + m) + 5 * -(-m // 8)
                  + 4 * -(-(n + m) // 8))
        assert plan.smem_bytes == 48 * 1024 == 4 * (-(-floats // 4) * 4)
        k, p = _both(A, c, apen, state0, **kw)
        assert solve_kernel.last_plan == plan
    else:
        plan = SegmentPlan(2, solve_kernel.cluster_bytes(
            m, n + m, 2))
        assert plan in solve_kernel.segment_plans(2, m, n + m)
        assert plan.smem_bytes == 48 * 1024
        k = solve_kernel.launch_with_plan(
            plan, A, c, apen, 512, SegmentState(*(t.clone() for t in state0)),
            **kw)
        p = solve_kernel.solve_segment_plain(
            A, c, apen, 512, SegmentState(*(t.clone() for t in state0)), **kw)
        torch.cuda.synchronize()
    torch.testing.assert_close(k.basis, p.basis, rtol=0, atol=0)
    assert bool((k.iters == 2).all())


# the shapes the paths give the segment kernel ([B, m, structural n]; the
# lane is [G | I], n + m columns): the crossover, the recovery bucket, the
# router's ipm+crossover and its two-phase simplex with artificials
_SEGMENT_SHAPES = {"crossover": (1024, 256, 256), "recovery": (64, 512, 512),
                   "router": (256, 256, 256), "simplex": (1024, 128, 256)}


def _segment_mid_solve(A, c, apen, state0, pivots, **kw):
    """``state0`` advanced by ``pivots`` iterations of the plain version."""
    s = SegmentState(*(t.clone() for t in state0))
    return solve_kernel.solve_segment_plain(A, c, apen, 1 << 20, s,
                                            **dict(kw, seg_len=pivots))


def _device_slack_instance(B, m, n, seed, dual, dev):
    """``_slack_instance`` made on the card (a large batch from numpy would
    dominate the test): nondegenerate [G | I] lanes from the slack basis."""
    from linprog_tpu_torch.generators import device_inequality_lps

    gen = torch.Generator(device=dev).manual_seed(seed)
    c, G, h = device_inequality_lps(gen, B, m, n, dev)
    if dual:
        c = c.abs()
    else:
        h = h.abs()
    eye = torch.eye(m, device=dev).expand(B, m, m)
    A = torch.cat([G, eye], dim=2).contiguous()
    cs = torch.cat([c, torch.zeros((B, m), device=dev)], dim=1).contiguous()
    pen = torch.zeros((B, n + m), device=dev)
    pen[:, n:] = float("inf")
    state = SegmentState(
        invBT=eye.contiguous().clone(), bfs=h.contiguous().clone(),
        cB=torch.zeros((B, m), device=dev),
        basis=torch.arange(n, n + m, dtype=torch.int32,
                           device=dev).expand(B, m).contiguous(),
        pen=pen, gamma=torch.ones((B, n + m), device=dev),
        iters=torch.zeros(B, dtype=torch.int32, device=dev),
        status=torch.zeros(B, dtype=torch.int32, device=dev))
    return A, cs, torch.zeros((B, n + m), device=dev), h.contiguous(), state


@pytest.mark.parametrize("shape", sorted(_SEGMENT_SHAPES))
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_segment_kernel_lockstep_from_mid_solve(cuda, dual, shape):
    """At the paths' shapes, on the cluster-resident branch: 16 pivots from
    a state 12 pivots into the solve (the first iteration runs the duals
    pass on a dense factor, the other 15 take their duals from the eta
    pass) in lockstep with the plain version on all but 16 of 1024 lanes
    (summation order may flip a near tie), with factors as accurate by
    float64 residual on the lanes in lockstep."""
    B, m, n = _SEGMENT_SHAPES[shape]
    A, c, apen, h, slack = _device_slack_instance(B, m, n, 31 + dual, dual,
                                                  cuda)
    kw = dict(pricing=1, opt_tol=1e-6, pivot_tol=1e-7, dual=dual,
              feas_tol=1e-6, stall_limit=24, packed=True)
    state0 = _segment_mid_solve(A, c, apen, slack, 12, **kw)
    k, p = _both(A, c, apen, state0, seg_len=16, **kw)
    assert solve_kernel.last_plan.cluster > 0
    same = torch.ones(B, dtype=torch.bool, device=cuda)
    for name in ("basis", "status", "iters", "pen", "cB"):
        a, b = getattr(k, name), getattr(p, name)
        same &= (a == b).reshape(B, -1).all(dim=1)
    assert int((~same).sum()) <= max(2, B * 16 // 1024)
    assert bool((k.iters == 28).any())
    sub = lambda s: SegmentState(*(t[same] for t in s))  # noqa: E731
    (fk, xk), (fp, xp) = (_residuals(A[same], h[same], sub(k)),
                          _residuals(A[same], h[same], sub(p)))
    assert fk <= 2.0 * fp + 1e-6, (fk, fp)
    assert xk <= 2.0 * xp + 1e-6, (xk, xp)


@pytest.mark.parametrize("m,n", [(32, 48), (37, 50), (128, 256), (256, 256),
                                 (5, 6)],
                         ids=["m32", "ragged", "m128", "m256", "m5"])
@pytest.mark.parametrize("pricing", [1, 2], ids=["dantzig", "devex"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_segment_kernel_same_answer_for_every_plan(cuda, dual, pricing, m, n):
    """Every planned cluster size over 48 pivots gives the same state bit
    for bit: every sum runs over the lane's 16 row bands in one fixed order,
    whatever the cluster size (m = 37: bands of 3 rows, the last cut to 1;
    m = 5: CTAs with empty slices).  Against the plain version: the same
    basis, status and iteration count, and factors as accurate."""
    B = 8
    A, c, apen, h, state0 = _slack_instance(B, m, n, seed=17 + dual,
                                            dual=dual, dev=cuda,
                                            degenerate=False)
    kw = dict(seg_len=48, pricing=pricing, opt_tol=1e-6, pivot_tol=1e-7,
              dual=dual, feas_tol=1e-6, stall_limit=24, packed=True)
    lib = solve_kernel._build.library()
    plans = solve_kernel.segment_plans(B, m, n + m)
    assert len(plans) >= 2 and all(pl.cluster > 0 for pl in plans)
    results = {}
    for pl in plans:
        assert lib.lp_solve_segment_cluster_max_clusters(
            pl.cluster, pl.smem_bytes) > 0
        s = SegmentState(*(t.clone() for t in state0))
        solve_kernel.launch_with_plan(pl, A, c, apen, 1 << 20, s, **kw)
        torch.cuda.synchronize()
        results[pl.cluster] = s
    p = solve_kernel.solve_segment_plain(
        A, c, apen, 1 << 20, SegmentState(*(t.clone() for t in state0)), **kw)
    first = results[plans[0].cluster]
    _assert_lockstep(A, h, first, p)
    for key, s in results.items():
        for a, b in zip(s, first):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"cluster = {key}")


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_segment_kernel_block_branch_past_the_largest_cluster(cuda, dual):
    """m = 1024, n = 2048 does not fit a 16-CTA cluster: the streaming
    branch runs it (the name dates from the block per lane it replaced),
    16 pivots in lockstep with the plain version."""
    m, n = 1024, 1024
    assert not resident(m, n + m, solve_kernel.cluster_bytes)
    A, c, apen, h, state0 = _slack_instance(4, m, n, seed=9, dual=dual,
                                            dev=cuda, degenerate=False)
    k, p = _both(A, c, apen, state0, seg_len=16, pricing=1, opt_tol=1e-6,
                 pivot_tol=1e-7, dual=dual, feas_tol=1e-6, stall_limit=24,
                 packed=True)
    assert isinstance(solve_kernel.last_plan, StreamingPlan)
    assert solve_kernel.last_plan in solve_kernel.segment_plans(4, m, n + m)
    _assert_lockstep(A, h, k, p)
    assert bool((k.iters == 16).all())


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_segment_stream_one_iteration_from_the_slack_start(cuda, dual):
    """[8, 1024, 2048] from the slack start on the streaming branch: zero
    duals and an identity factor, so every sum has one nonzero term, and one
    iteration equals the plain version's bit for bit on every lane."""
    m = 1024
    A, c, apen, h, state0 = _device_slack_instance(8, m, m, 41 + dual, dual,
                                                   cuda)
    k, p = _both(A, c, apen, state0, seg_len=1, pricing=1, opt_tol=1e-6,
                 pivot_tol=1e-7, dual=dual, feas_tol=1e-6, stall_limit=24,
                 packed=True)
    assert isinstance(solve_kernel.last_plan, StreamingPlan)
    for name, a, q in zip(k._fields, k, p):
        torch.testing.assert_close(a, q, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    assert bool((k.iters == 1).all()) and bool((k.basis != state0.basis).any())


@pytest.mark.parametrize("m", [1024, 1023], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("pricing", [1, 2], ids=["dantzig", "devex"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_segment_stream_same_bits_under_every_plan_and_branch(cuda, dual,
                                                              pricing, m):
    """Past the cluster line, 16 pivots from a state 8 pivots into the solve
    (a dense factor: the sums reorder) give the same state bit for bit
    under every built layout of the streaming branch: 2, 4 and 8 CTAs a
    lane, a ring that fills the SM or half of it, and on the aligned shape
    the scalar-load branch too (fixed row bands, one tree, the same order
    on both load branches); devex's weights included."""
    B = 4
    A, c, apen, h, slack = _device_slack_instance(B, m, m, m + dual, dual,
                                                  cuda)
    kw = dict(pricing=pricing, opt_tol=1e-6, pivot_tol=1e-7, dual=dual,
              feas_tol=1e-6, stall_limit=24, packed=True)
    state0 = _segment_mid_solve(A, c, apen, slack, 8, **kw)
    plans = solve_kernel.built_stream_plans(B, m, 2 * m, devex=pricing == 2)
    assert len(plans) >= 2 and any(not pl.aligned for pl in plans)
    if m % 4 == 0:
        assert {(pl.cluster, pl.ctas_per_sm) for pl in plans if pl.aligned} \
            == set(solve_kernel.LARGE_LAYOUTS)
    results = []
    for pl in plans:
        assert solve_kernel.clusters_held(pl) > 0, pl
        s = SegmentState(*(t.clone() for t in state0))
        solve_kernel.launch_with_plan(pl, A, c, apen, 1 << 20, s, seg_len=16,
                                      **kw)
        torch.cuda.synchronize()
        results.append((pl, s))
    first = results[0][1]
    assert bool((first.iters == 24).any())
    for pl, s in results[1:]:
        for name, a, q in zip(s._fields, s, first):
            torch.testing.assert_close(a, q, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name} under {pl}")


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_segment_stream_devex_lockstep_with_plain(cuda, dual):
    """Devex on the streaming branch at [8, 1024, 2048]: 16 pivots in
    lockstep with the plain version (basis, status, iterations, penalties
    and c_B equal on all but 2 lanes, as the mid-solve tests allow for near
    ties that the sums' order decides), and the weights within 1e-3
    relative on the lanes in lockstep, the bound of chip_smoke.py's 16-pivot
    devex check on the cluster-resident branch (a weight grows as 1 / d_l^2,
    so the sums' order moves it by twice d_l's relative error: 1.4e-4 in
    dual mode on the H100; the pivot row of the primal mode rides the next
    pricing pass, the launch's last one takes a pass of its own)."""
    B, m = 8, 1024
    A, c, apen, h, state0 = _device_slack_instance(B, m, m, 51 + dual, dual,
                                                   cuda)
    k, p = _both(A, c, apen, state0, seg_len=16, pricing=2, opt_tol=1e-6,
                 pivot_tol=1e-7, dual=dual, feas_tol=1e-6, stall_limit=24,
                 packed=True)
    assert isinstance(solve_kernel.last_plan, StreamingPlan)
    same = torch.ones(B, dtype=torch.bool, device=cuda)
    for name in ("basis", "status", "iters", "pen", "cB"):
        a, q = getattr(k, name), getattr(p, name)
        same &= (a == q).reshape(B, -1).all(dim=1)
    assert int((~same).sum()) <= 2
    assert bool((k.iters == 16).any())
    assert bool((p.gamma[same] != 1.0).any())
    rel = ((k.gamma[same] - p.gamma[same]).abs()
           / p.gamma[same].abs().clamp_min(1.0)).max().item()
    assert rel <= 1e-3


def test_segment_stream_exact_path_matches_cpu(cuda):
    """solve_batch_exact at B = 4, m = n = 768, past the cluster line, on
    the card (the crossover on the streaming branch) against the CPU run
    (the plain version) of the same instances: the same statuses, costs
    within 1e-5 relative."""
    import linprog_tpu_torch as lt

    B, m = 4, 768
    assert not resident(m, 2 * m, solve_kernel.cluster_bytes)
    c, G, h = (torch.tensor(a) for a in random_inequality_lps(B, m, m,
                                                               seed=13))
    res_cpu, _ = lt.solve_batch_exact(c, G, h)
    before = solve_kernel.launches_streaming
    res, info = lt.solve_batch_exact(c.to(cuda), G.to(cuda), h.to(cuda))
    assert solve_kernel.launches_streaming > before
    np.testing.assert_array_equal(res.status.cpu().numpy(),
                                  res_cpu.status.numpy())
    rel = ((res.cost.cpu() - res_cpu.cost).abs()
           / res_cpu.cost.abs().clamp_min(1.0)).max().item()
    assert rel <= 1e-5


def test_segment_kernel_refuses_a_plan_that_does_not_fit(cuda):
    """The C entry point checks the plan against the shape: too little
    shared memory, a cluster size that is not built, and a cluster too small
    for the lane are refused before any launch."""
    A, c, apen, h, state = _slack_instance(2, 128, 256, seed=0, dual=False,
                                           dev=cuda)
    kw = dict(seg_len=1, pricing=1, opt_tol=1e-6, pivot_tol=1e-7)
    good = solve_kernel.segment_plans(2, 128, 384)[0]
    before = solve_kernel.launches
    for bad in (good._replace(smem_bytes=16), good._replace(cluster=3),
                SegmentPlan(1, solve_kernel.cluster_bytes(
                    128, 384, 1))):
        with pytest.raises(RuntimeError, match="invalid"):
            solve_kernel.launch_with_plan(bad, A, c, apen, 10, state, **kw)
    assert solve_kernel.launches == before


# ---- kernel 1's unit layout against its dense launch -------------------------

# [B, m, n]: the two-phase simplex's Phase-I matrix [G | I | I] at m = 256
# (rows of h < 0 sign-flipped: -1 slack entries, basic artificials), the
# crossover's [G | I] (256 held columns in both), and the recovery
# bucket's [G | I] at m = 512 (512 held)
_UNIT_SHAPES = {"two_phase": (64, 256, 768), "slack": (64, 256, 512),
                "recovery": (64, 512, 1024)}
# the unit layout's planned cluster sizes there
_UNIT_CLUSTERS = {"two_phase": [4, 8, 16], "slack": [4, 8, 16],
                  "recovery": [16]}
# lanes with a planted non-finite dual
_NONFINITE_LANES = (0, 2)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _unit_instance(shape, dual, dev):
    """``(A, c, apen, state0)`` at ``_UNIT_SHAPES[shape]`` from the crash or
    slack basis (``invBT = I``), primal mode feasible; dual mode with |c|
    and negative basic values.  Lane 0's factor has a NaN row (its dual
    there is NaN); lane 1's unit column at a row with a zero dual holds -1,
    so its product is -0; lane 2's dual at row 100 is +inf and every other
    one finite (one infinite entry of its factor, under a basic cost of 1),
    so the unit columns of row 100 price to -inf and those of its CTA's
    other rows to NaN."""
    from linprog_tpu_torch.engine import slack_crash_state
    from linprog_tpu_torch.engine_batched import _segment_pack
    from linprog_tpu_torch.generators import (device_inequality_lps,
                                              device_standard_form_batch)

    B, m, n = _UNIT_SHAPES[shape]
    n_g = n - 2 * m if shape == "two_phase" else n - m
    gen = torch.Generator(device=dev).manual_seed(41 + dual)
    c, G, h = device_inequality_lps(gen, B, m, n_g, dev)
    if shape == "two_phase":
        c_std, A, b = device_standard_form_batch(c, G, h)
        eye = torch.eye(m, device=dev).expand(B, m, m)
        A = torch.cat([A, eye], dim=2).contiguous()
        crash = slack_crash_state(A, b, 2 * m)
        zeros = torch.zeros((B, m), device=dev)
        if dual:
            cost = torch.cat([c_std.abs(), zeros], dim=1)
            allowed = torch.arange(n, device=dev) < 2 * m
            crash = crash._replace(bfs=torch.where(
                torch.arange(m, device=dev) % 3 == 0, -crash.bfs, crash.bfs))
        else:
            cost = torch.cat([torch.zeros_like(c_std), zeros + 1.0], dim=1)
            allowed = torch.ones(n, dtype=torch.bool, device=dev)
        # lane 1: an artificial of a row whose slack is basic (dual +0)
        row = int(torch.nonzero(crash.basis[1] < 2 * m)[0])
        A[1, :, 2 * m + row] *= -1.0
        apen, state0 = _segment_pack(cost, A, crash, allowed)
    else:
        A, cost, apen, _, state0 = _device_slack_instance(B, m, n_g,
                                                          41 + dual, dual,
                                                          dev)
        A[1, :, n - 1] *= -1.0  # a slack of cost 0, basic: dual +0
    state0.invBT[0, 70, :] = float("nan")
    state0.cB[2, 5] = 1.0
    state0.invBT[2, 100, 5] = float("inf")
    return A, cost.contiguous(), apen, state0


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(_UNIT_SHAPES))
@pytest.mark.parametrize("pricing", [0, 1, 2],
                         ids=["bland", "dantzig", "devex"])
@_both_modes
def test_segment_kernel_unit_layout_is_the_dense_launch(cuda, dual, packed,
                                                        pricing, shape):
    """The unit layout (the structural columns held, the rest as rows and
    values) gives the dense launch's state bit for bit over 48 pivots, at
    every built cluster size that holds its lane, in every mode: the NaN
    lane stops at its first iteration in both, the -0 lane goes on, the
    +inf-dual lane prices its unit columns as the dense pass does.  Against
    the plain version: one iteration with the same basis and status, and
    16 pivots in lockstep on all but 2 lanes (summation order may flip a
    near tie), off the planted non-finite lanes."""
    A, c, apen, state0 = _unit_instance(shape, dual, cuda)
    B, m, n = A.shape
    unit = solve_kernel.unit_columns(A)
    assert unit is not None and unit.n_d == n - (2 * m if shape == "two_phase"
                                                 else m)
    kw = dict(seg_len=48, pricing=pricing, opt_tol=1e-6, pivot_tol=1e-7,
              dual=dual, feas_tol=1e-6, stall_limit=24, packed=packed)
    dense = SegmentState(*(t.clone() for t in state0))
    before = solve_kernel.launches_unit
    solve_kernel.launch_with_plan(solve_kernel.segment_plans(B, m, n)[0], A,
                                  c, apen, 1 << 20, dense, **kw)
    assert solve_kernel.launches_unit == before
    torch.cuda.synchronize()
    assert int(dense.iters[0]) == 1 and int(dense.iters[1]) > 8
    assert int((dense.iters > 8).sum()) > B // 2
    plans = solve_kernel.segment_plans(B, m, n, n_d=unit.n_d)
    assert [p.cluster for p in plans] == _UNIT_CLUSTERS[shape]
    for plan in plans:
        s = SegmentState(*(t.clone() for t in state0))
        solve_kernel.launch_with_plan(plan, A, c, apen, 1 << 20, s, unit=unit,
                                      **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(SegmentState._fields, s, dense):
            assert torch.equal(_bits(a), _bits(b)), (plan.cluster, name)
    assert solve_kernel.launches_unit == before + len(plans)

    keep = torch.ones(B, dtype=torch.bool, device=cuda)
    keep[list(_NONFINITE_LANES)] = False
    for pivots, names, allowed in ((1, ("basis", "status"), 0),
                                   (16, ("basis", "status", "iters", "pen",
                                         "cB"), 2)):
        k = SegmentState(*(t.clone() for t in state0))
        solve_kernel.launch_with_plan(plans[0], A, c, apen, 1 << 20, k,
                                      unit=unit, **dict(kw, seg_len=pivots))
        p = solve_kernel.solve_segment_plain(
            A, c, apen, 1 << 20, SegmentState(*(t.clone() for t in state0)),
            **dict(kw, seg_len=pivots))
        torch.cuda.synchronize()
        same = torch.ones(B, dtype=torch.bool, device=cuda)
        for name in names:
            a, b = getattr(k, name), getattr(p, name)
            same &= (a == b).reshape(B, -1).all(dim=1)
        assert int((keep & ~same).sum()) <= allowed, (pivots, name)


@pytest.mark.card
def test_unit_layout_plan_at_the_two_phase_shape(cuda):
    """At [1024, 256, 768] the unit layout's plan takes 4 CTAs a lane (the
    dense one 8), and the card holds at least 28 of its clusters at once;
    the wrapper picks it."""
    B, m, n = 1024, 256, 768
    plan = solve_kernel.segment_plans(B, m, n, n_d=256)[0]
    assert plan.cluster == 4 and solve_kernel.clusters_held(plan) >= 28
    index = torch.cuda.current_device()
    assert solve_kernel._choose_plan(B, m, n, False, index, True, 256) == plan
    assert solve_kernel._choose_plan(B, m, n, False, index, True).cluster == 8


@pytest.mark.card
@pytest.mark.parametrize("B,m,n,n_d,pays", [
    (1024, 256, 768, 256, True),    # the two-phase simplex: 4 CTAs, not 8
    (64, 256, 768, 256, True),
    (1024, 256, 512, 256, False),   # the crossover's [G | I]: 4 either way
    (64, 512, 1024, 512, False),    # the recovery bucket: 16 either way
    (4, 256, 768, 256, False),      # a batch within the SMs: 16 either way
    (1024, 256, 512, 0, True),      # every column a unit column: 2 CTAs
    (1024, 256, 768, 768, False),   # nothing left out
    (0, 256, 768, 256, False),      # no lanes
    (64, 1024, 2048, 1024, False),  # the streaming branch
])
def test_unit_layout_pays_where_it_saves_ctas(cuda, B, m, n, n_d, pays):
    """The unit layout is taken where its plan on the card has fewer CTAs a
    lane than the dense launch's, and only there."""
    assert solve_kernel.unit_pays(B, m, n, n_d, cuda) == pays


@pytest.mark.card
def test_solve_segment_takes_the_unit_layout_where_it_pays(cuda):
    """``solve_segment`` with a map: the unit layout at the two-phase shape,
    the dense launch at the crossover's (the same cluster), the same bits
    either way; the ``segment`` span holds each launch's layout."""
    from linprog_tpu_torch import observability as obs

    kw = dict(seg_len=8, pricing=1, opt_tol=1e-6, pivot_tol=1e-7,
              feas_tol=1e-6, stall_limit=24, packed=True)
    for shape, held, cluster in (("two_phase", 256, 4), ("slack", 512, 4)):
        A, c, apen, state0 = _unit_instance(shape, False, cuda)
        B, m, n = A.shape
        unit = solve_kernel.unit_columns(A)
        before = solve_kernel.launches_unit
        rec = obs.start()
        with obs.span("segment"):
            s = solve_kernel.solve_segment(
                A, c, apen, 1 << 20,
                SegmentState(*(t.clone() for t in state0)), unit=unit, **kw)
        obs.stop()
        (call,) = rec.calls()
        assert call[0].read_counts() == {"held_cols": held,
                                         "cluster": cluster,
                                         "branch": "resident"}
        assert solve_kernel.launches_unit == before + (held < n)
        d = solve_kernel.solve_segment(
            A, c, apen, 1 << 20, SegmentState(*(t.clone() for t in state0)),
            **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(SegmentState._fields, s, d):
            assert torch.equal(_bits(a), _bits(b)), (shape, name)


@pytest.mark.card
def test_unit_columns_on_the_card_copy_no_part_of_A(cuda):
    """The map of the two-phase matrix at [1024, 256, 768] (805 MB) is made
    with reductions: its peak above what was allocated is a few MB, and its
    rows and values are the nonzeros'."""
    from linprog_tpu_torch.generators import (device_inequality_lps,
                                              device_standard_form_batch)

    B, m = 1024, 256
    gen = torch.Generator(device=cuda).manual_seed(5)
    _, A, _ = device_standard_form_batch(*device_inequality_lps(gen, B, m, m,
                                                                cuda))
    A = torch.cat([A, torch.eye(m, device=cuda).expand(B, m, m)], dim=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    unit = solve_kernel.unit_columns(A)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 32 * 2**20
    assert unit.n_d == m
    tail = A[:64, :, m:]
    rows = (tail != 0).to(torch.int8).argmax(dim=1)
    assert torch.equal(unit.rows[:64].long(), rows)
    assert torch.equal(unit.vals[:64], torch.gather(tail, 1, rows[:, None])[:, 0])


@pytest.mark.card
def test_two_phase_on_card_same_bits_with_and_without_the_unit_layout(
        cuda, monkeypatch):
    """The two-phase simplex through the segment loop: its kernel-1
    launches take the unit layout, and every field of the result is that
    of the same solve with the layout turned off."""
    import linprog_tpu_torch.engine_batched as teb
    from linprog_tpu_torch.batch import solve_batch_two_phase
    from linprog_tpu_torch.config import SolverConfig
    from linprog_tpu_torch.generators import (device_inequality_lps,
                                              device_standard_form_batch)

    gen = torch.Generator(device=cuda).manual_seed(11)
    c, A, b = device_standard_form_batch(*device_inequality_lps(
        gen, 64, 256, 256, cuda))
    cfg = SolverConfig(pricing="dantzig", refactor_every=256, polish_pivots=4)
    before = solve_kernel.launches_unit
    on = solve_batch_two_phase(c, A, b, 4000, 4000, cfg)
    assert solve_kernel.launches_unit > before
    monkeypatch.setattr(teb, "unit_pays", lambda *args: False)
    before = solve_kernel.launches_unit
    off = solve_batch_two_phase(c, A, b, 4000, 4000, cfg)
    assert solve_kernel.launches_unit == before
    assert bool((on.status == st.OPTIMAL).all())
    for name, a, b2 in zip(on._fields, on, off):
        assert torch.equal(_bits(a), _bits(b2)), name


def _noted_branch(run):
    """The ``branch`` a kernel wrapper notes on the open ``segment`` span
    for one launch of ``run()``."""
    from linprog_tpu_torch import observability as obs

    rec = obs.start()
    try:
        with obs.span("segment"):
            run()
        torch.cuda.synchronize()
    finally:
        obs.stop()
    (call,) = rec.calls()
    return call[0].read_counts()["branch"]


@pytest.mark.card
@pytest.mark.parametrize("kernel,B,m,n,branch", [
    (1, 32, 1024, 1024, "stream"),    # the m = 1024 crossover's [G | I]
    (1, 1024, 256, 256, "resident"),  # the m = 256 crossover's
    (4, 16, 1280, 1280, "stream"),    # kernel 4 past its largest cluster
    (4, 1024, 256, 256, "resident"),
])
def test_segment_span_notes_the_branch_that_ran(cuda, kernel, B, m, n,
                                               branch):
    """Kernels 1 and 4 note ``"stream"`` for the streaming branch and
    ``"resident"`` for the cluster-resident one (two pivots a lane)."""
    kw = dict(seg_len=2, opt_tol=1e-6, pivot_tol=1e-7, packed=True)
    if kernel == 1:
        A, c, apen, _, state = _device_slack_instance(B, m, n, 7, False,
                                                      cuda)
        noted = _noted_branch(lambda: solve_kernel.solve_segment(
            A, c, apen, 1 << 20, state, pricing=1, feas_tol=1e-6,
            stall_limit=24, **kw))
        streaming = isinstance(solve_kernel.last_plan,
                               StreamingPlan)
    else:
        A, c, lb, ub, _, state = _bounded_instance(B, m, n, 7, cuda)
        noted = _noted_branch(lambda: bounded_kernel.solve_bounded_segment(
            A, c, lb, ub, 1 << 20, state, **kw))
        streaming = isinstance(bounded_kernel.last_plan,
                               StreamingPlan)
    assert noted == branch
    assert streaming == (branch == "stream")
    assert bool((state.iters == 2).all())


@pytest.mark.card
@pytest.mark.parametrize("flags", [
    {},
    {"a_resident": False},
    {"a_resident": False, "factor_blocked": True},
], ids=["resident", "stream", "blocked"])
def test_stream_kernel_notes_stream_in_every_mode(cuda, flags):
    """Kernel 3 at the m = 1024 fallback's Phase I lanes, (1024, 3072),
    notes ``"stream"`` whatever mode its caller chose: the card runs one
    streaming body for all three."""
    A, c, apen, _, state = _device_slack_instance(8, 1024, 2048, 7, False,
                                                  cuda)
    noted = _noted_branch(lambda: stream_kernel.solve_segment_stream(
        A, c, apen, 1 << 20, state, seg_len=2, pricing=1, opt_tol=1e-6,
        pivot_tol=1e-7, feas_tol=1e-6, stall_limit=24, packed=True,
        **flags))
    assert noted == "stream"
    assert bool((state.iters == 2).all())


def _mid_solve(A, c, apen, state0, pivots, **kw):
    """``state0`` advanced by ``pivots`` iterations of the plain version."""
    s = SegmentState(*(t.clone() for t in state0))
    return stream_kernel.solve_segment_stream_plain(A, c, apen, 1 << 20, s,
                                                    **dict(kw, seg_len=pivots))


_STREAM_SHAPES = {"aligned": (128, 256), "ragged": (37, 50)}


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("shape", sorted(_STREAM_SHAPES))
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_stream_kernel_lockstep_from_mid_solve(cuda, packed, dual, shape, B):
    """16 pivots from a state 12 pivots into the solve, so the first
    iteration runs the standalone duals on a dense factor and the other 15
    take their duals from the eta pass: the same basis, status, iteration
    count, c_B and penalties as the plain version on every lane; factors
    by float64 residual.  The aligned shape takes the bulk-copy rings at
    every cluster size, the ragged one the scalar branch."""
    m, n = _STREAM_SHAPES[shape]
    A, c, apen, h, slack = _slack_instance(B, m, n, seed=3 + dual, dual=dual,
                                           dev=cuda, degenerate=False)
    kw = dict(pricing=1, opt_tol=1e-6, pivot_tol=1e-7, dual=dual,
              feas_tol=1e-6, stall_limit=24, packed=packed)
    state0 = _mid_solve(A, c, apen, slack, 12, **kw)
    k, p = _stream_both(A, c, apen, state0, seg_len=16, **kw)
    assert stream_kernel.last_plan.aligned == (shape == "aligned")
    _assert_lockstep(A, h, k, p)
    assert bool((k.iters == 28).any())


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("shape", sorted(_STREAM_SHAPES))
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_stream_kernel_long_run_matches_plain(cuda, dual, shape, B):
    """One launch of up to 4096 pivots, in which every lane ends (the
    slowest takes more than 512): the same statuses and the same float64
    objective at the final basis to 1e-5 relative."""
    m, n = _STREAM_SHAPES[shape]
    A, c, apen, h, state0 = _slack_instance(B, m, n, seed=11 + dual,
                                            dual=dual, dev=cuda,
                                            degenerate=False)
    k, p = _stream_both(A, c, apen, state0, maxiters=4096, seg_len=4096,
                        pricing=1,
                        opt_tol=1e-6, pivot_tol=1e-7, dual=dual,
                        feas_tol=1e-6, stall_limit=24, packed=True)
    torch.testing.assert_close(k.status, p.status, rtol=0, atol=0)
    assert bool((k.status != st.RUNNING).all())

    def objective(s):
        xB = solve_or_nan(basis_matrix(A, s.basis), h)
        return (torch.gather(c, 1, s.basis.long()).double() * xB.double()).sum(1)

    ok, op = objective(k), objective(p)
    assert ((ok - op).abs() / op.abs().clamp_min(1.0)).max().item() <= 1e-5


@pytest.mark.parametrize("m,n", [(128, 256), (640, 640), (2048, 1024),
                                 (100, 156)],
                         ids=["m128", "m640", "m2048", "m100"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_stream_kernel_same_answer_for_every_plan(cuda, dual, m, n):
    """Every built plan (8 and 2 blocks a lane on the bulk-copy branch, 8 on
    the scalar branch) over 48 pivots gives the same state bit for bit:
    every sum runs over the lane's eight row bands in one fixed order,
    whatever the cluster size and the branch.  Against the plain version:
    the same basis, status and iteration count, and factors as accurate.
    m = 640 streams rows in one chunk and m = 2048 in two, through several
    stages of both rings; at m = 100 the bands are 13 rows and the last is
    cut to 9."""
    from linprog_tpu_torch.ops import _build

    B = 8
    A, c, apen, h, state0 = _slack_instance(B, m, n, seed=17 + dual,
                                            dual=dual, dev=cuda,
                                            degenerate=False)
    kw = dict(seg_len=48, pricing=1, opt_tol=1e-6, pivot_tol=1e-7, dual=dual,
              feas_tol=1e-6, stall_limit=24, packed=True)
    lib = _build.library()
    results = {}
    for plan in stream_kernel.stream_plans(B, m, n + m, dual=dual):
        assert plan.aligned
        scalar = stream_kernel.scalar_plan(plan.cluster, m, n + m, dual)
        for name, pl in (("ring", plan), ("scalar", scalar)):
            if pl is None:
                continue
            assert lib.lp_solve_segment_stream_max_clusters(
                pl.cluster, int(pl.aligned), pl.smem_bytes) > 0
            s = SegmentState(*(t.clone() for t in state0))
            stream_kernel.launch_with_plan(pl, A, c, apen, 1 << 20, s, **kw)
            torch.cuda.synchronize()
            results[plan.cluster, name] = s
    assert set(results) == {(8, "ring"), (8, "scalar"), (2, "ring")}
    p = stream_kernel.solve_segment_stream_plain(
        A, c, apen, 1 << 20, SegmentState(*(t.clone() for t in state0)), **kw)
    assert bool((p.iters > 16).all())
    first = results[8, "ring"]
    _assert_lockstep(A, h, first, p)
    for key, s in results.items():
        for a, b in zip(s, first):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"(cluster, branch) = {key}")


def test_stream_kernel_refuses_a_plan_that_does_not_fit(cuda):
    """The C entry point checks the plan against the shape: an aligned
    plan on a ragged shape and a ring larger than the stated shared memory
    are refused before any launch."""
    A, c, apen, h, state = _slack_instance(2, 37, 50, seed=0, dual=False,
                                           dev=cuda)
    kw = dict(seg_len=1, pricing=1, opt_tol=1e-6, pivot_tol=1e-7)
    good = stream_kernel.stream_plans(2, 37, 87)[0]
    assert not good.aligned
    before = stream_kernel.launches
    with pytest.raises(RuntimeError, match="invalid"):
        stream_kernel.launch_with_plan(
            good._replace(aligned=True, stages=4, stage_floats=64,
                          warp_stages=2, chunk_floats=32),
            A, c, apen, 10, state, **kw)
    with pytest.raises(RuntimeError, match="invalid"):
        stream_kernel.launch_with_plan(good._replace(smem_bytes=16), A, c,
                                       apen, 10, state, **kw)
    assert stream_kernel.launches == before


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_stream_kernel_at_the_largest_two_phase_shape(cuda, dual):
    """m = 4096, n = 12288: the lane's vectors take most of a block's shared
    memory, so the plan shrinks the ring (and drops 2 blocks a lane); three
    pivots in lockstep with the plain version."""
    m, n = 4096, 8192
    plans = stream_kernel.stream_plans(2, m, n + m, dual=dual)
    assert all(p.aligned and p.smem_bytes > 128 * 1024 for p in plans)
    assert 2 not in [p.cluster for p in plans]
    A, c, apen, h, state0 = _slack_instance(2, m, n, seed=5, dual=dual,
                                            dev=cuda, degenerate=False)
    k, p = _stream_both(A, c, apen, state0, seg_len=3, pricing=1,
                        opt_tol=1e-6, pivot_tol=1e-7, dual=dual,
                        feas_tol=1e-6, stall_limit=24, packed=True)
    assert stream_kernel.last_plan in plans
    for name in ("basis", "status", "iters", "pen", "cB"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=0, atol=0)
    assert bool((k.iters == 3).all())


# ---- the bounded-variable segment kernel ----------------------------------


def _bounded_instance(B, m, n, seed, dev):
    """``device_bounded_lps`` with its all-slack start in the kernel's
    layout."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    c, A, b, lb, ub = device_bounded_lps(gen, B, m, n, dev)
    ntot = n + m
    basis = torch.arange(n, ntot, dtype=torch.int32, device=dev).expand(B, m)
    vs = torch.zeros((B, ntot), dtype=torch.int8, device=dev)
    vs[:, n:] = bounded_kernel.BASIC
    zeros = torch.zeros((B, m), device=dev)
    state = BoundedSegmentState(
        invBT=torch.eye(m, device=dev).expand(B, m, m).contiguous(),
        bfs=b.clone(), cB=zeros.clone(), basis=basis.contiguous(),
        vstate=vs, lbB=zeros.clone(),
        ubB=torch.full((B, m), float("inf"), device=dev),
        iters=torch.zeros(B, dtype=torch.int32, device=dev),
        status=torch.zeros(B, dtype=torch.int32, device=dev),
    )
    return (A.contiguous(), c.contiguous(), lb.contiguous(), ub.contiguous(),
            b, state)


def _bounded_both(A, c, lb, ub, state0, maxiters=1 << 20, **kw):
    before = bounded_kernel.launches
    k = bounded_kernel.solve_bounded_segment(
        A, c, lb, ub, maxiters,
        BoundedSegmentState(*(t.clone() for t in state0)), **kw)
    p = bounded_kernel.solve_bounded_segment_plain(
        A, c, lb, ub, maxiters,
        BoundedSegmentState(*(t.clone() for t in state0)), **kw)
    torch.cuda.synchronize()
    assert bounded_kernel.launches == before + 1
    return k, p


def _assert_bounded_lockstep(k, p):
    for name in ("basis", "vstate", "status", "iters", "cB", "lbB", "ubB"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=0, atol=0)
    # summation order only: 1e-4 of scale after at most 16 updates
    scale = p.invBT.abs().amax().item()
    assert (k.invBT - p.invBT).abs().amax().item() <= 1e-4 * max(scale, 1.0)
    assert (k.bfs - p.bfs).abs().amax().item() <= 1e-4 * max(
        p.bfs.abs().amax().item(), 1.0)


@pytest.mark.parametrize("m,n", [(32, 48), (37, 50)], ids=["m32", "ragged"])
@pytest.mark.parametrize("seg_len", [1, 16], ids=["one", "sixteen"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_kernel_matches_plain(cuda, packed, seg_len, m, n):
    """One iteration and a 16-iteration segment from the all-slack start,
    at sizes that are and are not multiples of 32: the same basis, variable
    states, status, iteration count and basis rows on every lane."""
    A, c, lb, ub, b, state0 = _bounded_instance(64, m, n, seed=m + seg_len,
                                                dev=cuda)
    k, p = _bounded_both(A, c, lb, ub, state0, seg_len=seg_len, opt_tol=1e-6,
                         pivot_tol=1e-7, packed=packed)
    _assert_bounded_lockstep(k, p)
    assert bool((k.iters == seg_len).all())
    if seg_len == 16:
        assert bool((k.vstate == bounded_kernel.AT_UB).any())  # flips


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_kernel_full_run_matches_plain(cuda, packed):
    """Every lane runs to optimality in one segment in both versions, with
    the same objective (exact solve at the final basis and bounds) to 1e-5
    relative; maxiters stops a second run short."""
    A, c, lb, ub, b, state0 = _bounded_instance(64, 32, 48, seed=5, dev=cuda)
    kw = dict(opt_tol=1e-6, pivot_tol=1e-7, packed=packed)
    k, p = _bounded_both(A, c, lb, ub, state0, seg_len=4096, **kw)
    assert bool((k.status == st.OPTIMAL).all())
    assert bool((p.status == st.OPTIMAL).all())

    def objective(s):
        x_n = torch.where(s.vstate == 1, ub, torch.zeros_like(ub))
        rhs = b - torch.einsum("bmn,bn->bm", A, x_n)
        xB = solve_or_nan(basis_matrix(A, s.basis), rhs)
        x = x_n.scatter(1, s.basis.long(), xB)
        return (c.double() * x.double()).sum(1)

    ok, op = objective(k), objective(p)
    assert ((ok - op).abs() / op.abs().clamp_min(1.0)).max().item() <= 1e-5
    k, p = _bounded_both(A, c, lb, ub, state0, maxiters=5, seg_len=4096, **kw)
    _assert_bounded_lockstep(k, p)
    assert bool((k.iters == 5).all()) and bool((k.status == 0).all())


def _hand_bounded(dev, c, A, b, lb, ub, basis, vstate):
    t = lambda v, dt=torch.float32: torch.tensor([v], dtype=dt, device=dev)  # noqa: E731
    c, A, b, lb, ub = t(c), t(A), t(b), t(lb), t(ub)
    basis = t(basis, torch.int32)
    idx = basis.long()
    m = basis.shape[1]
    state = BoundedSegmentState(
        invBT=torch.eye(m, device=dev)[None].contiguous(), bfs=b.clone(),
        cB=torch.gather(c, 1, idx), basis=basis, vstate=t(vstate, torch.int8),
        lbB=torch.gather(lb, 1, idx), ubB=torch.gather(ub, 1, idx),
        iters=torch.zeros(1, dtype=torch.int32, device=dev),
        status=torch.zeros(1, dtype=torch.int32, device=dev))
    return A, c, lb, ub, state


INF = float("inf")
_HAND_CASES = {
    # a pure bound flip: x0 crosses to its upper bound, no basis change
    "flip": (([-1.0, 0.0], [[1.0, 1.0]], [5.0], [0.0, 0.0], [2.0, INF],
              [1], [0, 2]), [[1]], [[1, 2]], 0),
    # the leaving variable lands on its upper bound
    "leave-to-ub": (([-1.0, 0.0], [[-1.0, 1.0]], [1.0], [0.0, 0.0],
                     [10.0, 3.0], [1], [0, 2]), [[0]], [[2, 1]], 0),
    # no finite step of any kind
    "unbounded": (([-1.0, 0.0], [[1.0, -1.0]], [1.0], [0.0, 0.0], [INF, INF],
                   [0], [2, 0]), [[0]], [[2, 0]], st.PRIMAL_UNBOUNDED),
    # a -0.0 basic value ties at zero with row 0: the lowest row leaves
    "negative-zero": (([-1.0, 0.0, 0.0, 0.0],
                       [[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 1.0]],
                       [0.0, -0.0], [0.0] * 4, [5.0, 5.0, INF, INF], [2, 3],
                       [0, 0, 2, 2]), [[0, 3]], [[2, 0, 0, 2]], 0),
}


@pytest.mark.parametrize("case", sorted(_HAND_CASES))
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_kernel_hand_built_steps(cuda, packed, case):
    prob, basis, vstate, status = _HAND_CASES[case]
    A, c, lb, ub, state0 = _hand_bounded(cuda, *prob)
    k, p = _bounded_both(A, c, lb, ub, state0, seg_len=1, opt_tol=1e-6,
                         pivot_tol=1e-7, packed=packed)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert k.basis.tolist() == basis and k.vstate.tolist() == vstate
    assert k.status.tolist() == [status] and k.iters.tolist() == [1]


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_kernel_tie_between_the_two_ratio_minima(cuda, packed):
    """Equal step lengths to a lower and to an upper bound: unpacked mode
    compares the values (row 1 leaves to its upper bound), packed mode the
    keys (row 0 leaves to its lower bound)."""
    A, c, lb, ub, state0 = _hand_bounded(
        cuda, [-1.0, 0.0, 0.0], [[1.0, 1.0, 0.0], [-1.0, 0.0, 1.0]],
        [1.0, 1.0], [0.0] * 3, [10.0, INF, 2.0], [1, 2], [0, 2, 2])
    k, p = _bounded_both(A, c, lb, ub, state0, seg_len=1, opt_tol=1e-6,
                         pivot_tol=1e-7, packed=packed)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert k.basis.tolist() == ([[0, 2]] if packed else [[1, 0]])
    assert k.vstate.tolist() == ([[2, 0, 2]] if packed else [[2, 2, 1]])


def test_bounded_kernel_launches_at_48kb_of_dynamic_shared_memory(cuda):
    """m = 1715, n = 3465, past the largest cluster and not 16-byte
    aligned: the streaming branch (which replaced the block per lane) takes
    its scalar-load plan at 8 CTAs a lane, whose vectors, (3m + n + 7
    ceil(m / 8) + 5 ceil(n / 8)) floats, take exactly 48 KB of dynamic
    shared memory; with the static part on top the launch needs the opt-in
    limit, which the wrapper sets at every launch."""
    m, n = 1715, 1750
    assert 4 * (3 * m + (n + m) + 7 * -(-m // 8) + 5 * -(-(n + m) // 8)
                + 3) // 16 * 16 == 48 * 1024
    plan = bounded_kernel.segment_plans(2, m, n + m)[0]
    assert isinstance(plan, StreamingPlan)
    assert plan.smem_bytes == 48 * 1024 and not plan.aligned
    A, c, lb, ub, b, state0 = _bounded_instance(2, m, n, seed=1, dev=cuda)
    k, p = _bounded_both(A, c, lb, ub, state0, seg_len=2, opt_tol=1e-6,
                         pivot_tol=1e-7, packed=True)
    assert isinstance(bounded_kernel.last_plan,
                      StreamingPlan)
    assert bounded_kernel.last_plan.smem_bytes == 48 * 1024
    torch.testing.assert_close(k.basis, p.basis, rtol=0, atol=0)
    torch.testing.assert_close(k.vstate, p.vstate, rtol=0, atol=0)
    assert bool((k.iters == 2).all())


def test_bounded_kernel_cluster_launches_at_48kb_of_dynamic_shared_memory(
        cuda):
    """The cluster-resident branch at (16, 980), 2 CTAs a lane: exactly 48
    KB of dynamic shared memory a CTA."""
    m, n = 16, 964
    plan = SegmentPlan(2, bounded_kernel.cluster_bytes(
        m, n + m, 2))
    assert plan.smem_bytes == 48 * 1024
    assert plan in bounded_kernel.segment_plans(2, m, n + m)
    A, c, lb, ub, b, state0 = _bounded_instance(2, m, n, seed=1, dev=cuda)
    kw = dict(seg_len=2, opt_tol=1e-6, pivot_tol=1e-7, packed=True)
    k = bounded_kernel.launch_with_plan(
        plan, A, c, lb, ub, 1 << 20,
        BoundedSegmentState(*(t.clone() for t in state0)), **kw)
    p = bounded_kernel.solve_bounded_segment_plain(
        A, c, lb, ub, 1 << 20,
        BoundedSegmentState(*(t.clone() for t in state0)), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(k.basis, p.basis, rtol=0, atol=0)
    torch.testing.assert_close(k.vstate, p.vstate, rtol=0, atol=0)
    assert bool((k.iters == 2).all())


@pytest.mark.parametrize("shape", sorted(_SEGMENT_SHAPES))
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_kernel_lockstep_from_mid_solve(cuda, packed, shape):
    """At the segment kernels' shapes, on the cluster-resident branch: 16
    iterations from a state 12 iterations into the solve (the first runs
    the duals pass on a dense factor; the others take them from the eta
    pass, or keep them over a flip) in lockstep with the plain version on
    all but 16 of 1024 lanes, basic values within 1e-4 of scale there."""
    B, m, n = _SEGMENT_SHAPES[shape]
    A, c, lb, ub, b, slack = _bounded_instance(B, m, n, seed=41, dev=cuda)
    kw = dict(opt_tol=1e-6, pivot_tol=1e-7, packed=packed)
    state0 = bounded_kernel.solve_bounded_segment_plain(
        A, c, lb, ub, 1 << 20,
        BoundedSegmentState(*(t.clone() for t in slack)), seg_len=12, **kw)
    k, p = _bounded_both(A, c, lb, ub, state0, seg_len=16, **kw)
    assert bounded_kernel.last_plan.cluster > 0
    same = torch.ones(B, dtype=torch.bool, device=cuda)
    for name in ("basis", "vstate", "status", "iters", "cB", "lbB", "ubB"):
        a, q = getattr(k, name), getattr(p, name)
        same &= (a == q).reshape(B, -1).all(dim=1)
    assert int((~same).sum()) <= max(2, B * 16 // 1024)
    assert bool((k.iters == 28).any())
    scale = max(p.bfs[same].abs().max().item(), 1.0)
    assert (k.bfs[same] - p.bfs[same]).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("m,n", [(32, 48), (37, 50), (128, 256), (256, 256),
                                 (5, 6)],
                         ids=["m32", "ragged", "m128", "m256", "m5"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_kernel_same_answer_for_every_plan(cuda, packed, m, n):
    """Every planned cluster size over 48 iterations gives the same state
    bit for bit (fixed row bands, one tree); against the plain version the
    same basis, variable states, status and iteration count."""
    B = 8
    A, c, lb, ub, b, state0 = _bounded_instance(B, m, n, seed=m + 3, dev=cuda)
    kw = dict(seg_len=48, opt_tol=1e-6, pivot_tol=1e-7, packed=packed)
    lib = solve_kernel._build.library()
    plans = bounded_kernel.segment_plans(B, m, n + m)
    assert len(plans) >= 2 and all(pl.cluster > 0 for pl in plans)
    results = {}
    for pl in plans:
        assert lib.lp_solve_bounded_cluster_max_clusters(
            pl.cluster, pl.smem_bytes) > 0
        s = BoundedSegmentState(*(t.clone() for t in state0))
        bounded_kernel.launch_with_plan(pl, A, c, lb, ub, 1 << 20, s, **kw)
        torch.cuda.synchronize()
        results[pl.cluster] = s
    p = bounded_kernel.solve_bounded_segment_plain(
        A, c, lb, ub, 1 << 20,
        BoundedSegmentState(*(t.clone() for t in state0)), **kw)
    first = results[plans[0].cluster]
    for name in ("basis", "vstate", "status", "iters"):
        torch.testing.assert_close(getattr(first, name), getattr(p, name),
                                   rtol=0, atol=0)
    for key, s in results.items():
        for a, q in zip(s, first):
            torch.testing.assert_close(a, q, rtol=0, atol=0, equal_nan=True,
                                       msg=f"cluster = {key}")


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_kernel_block_branch_past_the_largest_cluster(cuda, packed):
    """m = 1024, n = 2048 does not fit a 16-CTA cluster: the streaming
    branch runs it (the name dates from the block per lane it replaced),
    16 iterations in lockstep with the plain version."""
    m, n = 1024, 1024
    plans = bounded_kernel.segment_plans(4, m, n + m)
    assert all(isinstance(pl, StreamingPlan)
               for pl in plans)
    A, c, lb, ub, b, state0 = _bounded_instance(4, m, n, seed=9, dev=cuda)
    k, p = _bounded_both(A, c, lb, ub, state0, seg_len=16, opt_tol=1e-6,
                         pivot_tol=1e-7, packed=packed)
    assert isinstance(bounded_kernel.last_plan,
                      StreamingPlan)
    _assert_bounded_lockstep(k, p)


def test_bounded_path_on_card_matches_cpu(cuda):
    """solve_batch_bounded on the card (kernel) against the CPU run (plain
    version) of the same instances: same statuses, objectives to 1e-5."""
    import linprog_tpu_torch as lt

    B, m, n = 16, 24, 24
    gen = torch.Generator().manual_seed(3)
    prob = device_bounded_lps(gen, B, m, n, "cpu")
    basis = torch.arange(n, n + m, dtype=torch.int32).expand(B, m)
    vs = torch.zeros((B, n + m), dtype=torch.int8)
    vs[:, n:] = 2
    cfg = lt.SolverConfig(pricing="dantzig", refactor_every=16,
                          polish_pivots=8, packed_select=True)
    res_cpu = lt.solve_batch_bounded(*prob, basis, vs, 2000, cfg)
    before = bounded_kernel.launches
    res = lt.solve_batch_bounded(*(t.to(cuda) for t in prob), basis.to(cuda),
                                 vs.to(cuda), 2000, cfg)
    assert bounded_kernel.launches > before
    assert bool((res.status == st.OPTIMAL).all())
    np.testing.assert_array_equal(res.status.cpu().numpy(),
                                  res_cpu.status.numpy())
    rel = ((res.cost.cpu() - res_cpu.cost).abs()
           / res_cpu.cost.abs().clamp_min(1.0)).max().item()
    assert rel <= 1e-5


# ---- the two per-step kernels ----------------------------------------------


def _step_inputs(B, m, n, seed, dev):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    invB = np.eye(m, dtype=np.float32) + 0.2 * f(B, m, m)
    pen = np.zeros((B, n), np.float32)
    pen[:, ::5] = np.inf
    c = f(B, n)
    c[1] = 1e4  # a lane with no eligible column
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (t(f(B, m)), t(invB), t(f(B, m, n)), t(c), t(pen),
            t(rng.random((B, m)).astype(np.float32)))


@pytest.mark.parametrize("m,n", [(32, 96), (37, 83), (256, 768)],
                         ids=["m32", "ragged", "m256"])
@pytest.mark.parametrize("dantzig", [True, False], ids=["dantzig", "bland"])
def test_price_entering_kernel_matches_plain(cuda, dantzig, m, n):
    cB, invB, A, c, pen, _ = _step_inputs(64, m, n, seed=m, dev=cuda)
    c[2] = 1.0
    cB[2] = 0.0
    c[2, [3, 7]] = -2.0  # an exact tie: the first index wins
    c[3, 0] = float("nan")  # dantzig: enter == n
    before = step_kernels.launches["price_entering"]
    k = step_kernels.price_entering(cB, invB, A, c, pen, dantzig=dantzig,
                                    opt_tol=1e-6)
    p = step_kernels.price_entering_plain(cB, invB, A, c, pen,
                                          dantzig=dantzig, opt_tol=1e-6)
    torch.cuda.synchronize()
    assert step_kernels.launches["price_entering"] == before + 1
    y = torch.einsum("bm,bmk->bk", cB.double(), invB.double())
    r = c.double() - torch.einsum("bm,bmn->bn", y, A.double()) + pen.double()
    # lanes whose two smallest reduced costs are closer than summation-order
    # noise may pick either; everywhere else the integers are equal
    two = r.nan_to_num(nan=float("inf")).topk(2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0] > 1e-4) | (two[:, 1] == two[:, 0])
    clear[3] = True
    if not dantzig:
        clear = torch.ones_like(clear)
    assert int(clear.sum()) >= 60
    torch.testing.assert_close(k[0][clear], p[0][clear], rtol=0, atol=0)
    torch.testing.assert_close(k[1], p[1], rtol=0, atol=0)
    assert int(k[1][1]) == 0 and int(k[0][2]) == 3
    if dantzig:
        assert int(k[0][3]) == n and int(k[1][3]) == 0


@pytest.mark.parametrize("m", [32, 37, 256], ids=["m32", "ragged", "m256"])
def test_ratio_eta_pivot_kernel_matches_plain(cuda, m):
    _, invB, A, _, _, bfs = _step_inputs(64, m, 2 * m, seed=100 + m, dev=cuda)
    acol = A[:, :, 4].contiguous()
    invB[0] = -torch.eye(m, device=cuda)
    acol[0] = acol[0].abs() + 0.1  # no positive direction entry: unbounded
    go = torch.ones((64, 1), dtype=torch.int32, device=cuda)
    go[1] = 0
    ki, kb = invB.clone(), bfs.clone()
    pi, pb = invB.clone(), bfs.clone()
    before = step_kernels.launches["ratio_eta_pivot"]
    k = step_kernels.ratio_eta_pivot(ki, kb, acol, go, pivot_tol=1e-7)
    p = step_kernels.ratio_eta_pivot_plain(pi, pb, acol, go, pivot_tol=1e-7)
    torch.cuda.synchronize()
    assert step_kernels.launches["ratio_eta_pivot"] == before + 1
    assert k[0] is ki and k[1] is kb  # in place
    torch.testing.assert_close(k[2], p[2], rtol=0, atol=0)
    torch.testing.assert_close(k[3], p[3], rtol=0, atol=0)
    assert int(k[3][0]) == 1 and int(k[2][0]) == 0 and int(k[3][1]) == 0
    for lane in (0, 1):  # nothing changes without a pivot
        torch.testing.assert_close(ki[lane], invB[lane], rtol=0, atol=0)
        torch.testing.assert_close(kb[lane], bfs[lane], rtol=0, atol=0)
    # one rank-1 update from equal inputs: summation order of d only
    scale = pi.abs().amax().item()
    assert (ki - pi).abs().amax().item() <= 1e-5 * scale
    assert (kb - pb).abs().amax().item() <= 1e-5 * pb.abs().amax().item()
    assert bool((ki[2] != invB[2]).any())


def test_batched_primal_step_on_card_matches_cpu(cuda):
    """16 steps of the kernel branch on the card in lockstep with the same
    steps on the CPU (plain versions): basis, iteration count and status
    equal after every step."""
    from linprog_tpu_torch import engine
    from linprog_tpu_torch.config import SolverConfig
    from linprog_tpu_torch.engine_batched import batched_primal_step

    B, m, n = 16, 12, 16
    c, G, h = (torch.tensor(a) for a in random_inequality_lps(B, m, n, seed=9))
    eye = torch.eye(m).expand(B, m, m)
    A1 = torch.cat([torch.where((h < 0)[:, :, None], -1.0, 1.0)
                    * torch.cat([G, eye], dim=2), eye], dim=2).contiguous()
    b = h.abs()
    c1 = torch.cat([torch.zeros((B, n + m)), torch.ones((B, m))], dim=1)
    allowed = torch.ones(n + 2 * m, dtype=torch.bool)
    cfg = SolverConfig(pricing="dantzig")
    s_cpu = engine.slack_crash_state(A1, b, n + m)
    s_dev = engine.SimplexState(*(t.to(cuda).contiguous() for t in s_cpu))
    dev_args = tuple(t.to(cuda) for t in (c1, A1, b, allowed))
    before = dict(step_kernels.launches)
    for _ in range(16):
        s_cpu = batched_primal_step(c1, A1, b, allowed, s_cpu, cfg, 100)
        s_dev = batched_primal_step(*dev_args, s_dev, cfg, 100)
        for name in ("basis", "iters", "status"):
            np.testing.assert_array_equal(
                getattr(s_dev, name).cpu().numpy(),
                getattr(s_cpu, name).numpy(), err_msg=name)
    assert step_kernels.launches["price_entering"] == before["price_entering"] + 16
    assert step_kernels.launches["ratio_eta_pivot"] == before["ratio_eta_pivot"] + 16


# ---- the batched front door on the card --------------------------------------


def _cpu_and_card(arrays, cuda):
    cpu = [torch.tensor(a) for a in arrays]
    return cpu, [t.to(cuda) for t in cpu]


def _same_answers(res, res_cpu, tol=1e-5):
    """Statuses equal lane for lane; costs of OPTIMAL lanes within ``tol``
    relative."""
    np.testing.assert_array_equal(res.status.cpu().numpy(),
                                  res_cpu.status.numpy())
    ok = res_cpu.status == st.OPTIMAL
    rel = ((res.cost.cpu() - res_cpu.cost).abs()
           / res_cpu.cost.abs().clamp_min(1.0))[ok]
    assert rel.numel() and rel.max().item() <= tol


@pytest.mark.parametrize("chunks", [1, 3])
def test_pooled_recovery_on_card_matches_cpu(cuda, chunks):
    """The starved IPM's stragglers recovered on CUDA tensors (kernels 1 and
    2) against the same call on CPU tensors (plain versions), at m = 64:
    the same statuses, every lane OPTIMAL with a basis, costs to 1e-5.  Both
    recoveries start from the CPU run's raw iterates, so the pick lists are
    the same."""
    import linprog_tpu_torch as lt

    icfg = lt.IPMConfig(maxiters=4)
    batches_cpu, batches, raws_cpu, raws = [], [], [], []
    before2 = cholinv_kernel.launches
    for s in range(chunks):
        cpu, card = _cpu_and_card(random_inequality_lps(16, 64, 64, seed=s),
                                  cuda)
        batches_cpu.append(tuple(cpu))
        batches.append(tuple(card))
        raw = lt.ipm_solve_batch_canonical(*cpu, icfg)
        raws_cpu.append(raw)
        raws.append(lt.BatchResult(*(t.to(cuda) for t in raw)))
        on_card = lt.ipm_solve_batch_canonical(*card, icfg)
        assert bool((on_card.status != st.OPTIMAL).all())
    assert cholinv_kernel.launches > before2
    recs_cpu = lt.recover_stragglers_pooled(batches_cpu, raws_cpu)
    before1 = solve_kernel.launches
    recs = lt.recover_stragglers_pooled(batches, raws)
    assert solve_kernel.launches > before1
    for rec, rec_cpu in zip(recs, recs_cpu):
        assert rec.x.is_cuda and bool((rec.status == st.OPTIMAL).all())
        assert bool((rec.basis >= 0).all())
        _same_answers(rec, rec_cpu)


def test_recover_flag_on_card_launches_both_kernels(cuda):
    """``ipm_solve_batch_canonical(recover=True)`` end to end on the card."""
    import linprog_tpu_torch as lt

    _, (c, G, h) = _cpu_and_card(random_inequality_lps(16, 64, 64, seed=5),
                                 cuda)
    before = (solve_kernel.launches, cholinv_kernel.launches)
    res = lt.ipm_solve_batch_canonical(c, G, h, lt.IPMConfig(maxiters=4),
                                       recover=True)
    assert solve_kernel.launches > before[0]
    assert cholinv_kernel.launches > before[1]
    assert bool((res.status == st.OPTIMAL).all())
    cert = lt.certify_vertex_batch(c, G, h, res.basis)
    assert int(cert["certified"].sum()) >= 15


@pytest.mark.parametrize("polish", [0, 8])
def test_warm_rhs_resolve_on_card_matches_cpu(cuda, polish):
    """``reoptimize_batch_new_rhs`` at m = 64 from the bases of a CPU
    two-phase solve: CUDA tensors (kernel 1, dual then primal) against CPU
    tensors: the same statuses, costs to 1e-5, fewer pivots than fresh."""
    import linprog_tpu_torch as lt
    from linprog_tpu_torch.batch import reoptimize_batch_new_rhs
    from linprog_tpu_torch.generators import to_standard_form_batch

    cs, As, bs = to_standard_form_batch(
        *random_inequality_lps(16, 64, 64, seed=11))
    cfg = lt.SolverConfig(pricing="dantzig", refactor_every=64,
                          packed_select=True, polish_pivots=polish)
    rng = np.random.default_rng(0)
    bs_new = bs * (1.0 + 0.05 * rng.standard_normal(bs.shape)
                   .astype(np.float32))
    cpu, card = _cpu_and_card((cs, As, bs_new), cuda)
    base = lt.solve_batch_two_phase(torch.tensor(cs), torch.tensor(As),
                                    torch.tensor(bs), 2000, 2000, cfg)
    assert bool((base.status == st.OPTIMAL).all())
    assert bool((base.basis < cs.shape[1]).all())
    warm_cpu = reoptimize_batch_new_rhs(*cpu, base.basis, 2000, cfg)
    before = (solve_kernel.launches, solve_kernel.launches_dual)
    warm = reoptimize_batch_new_rhs(*card, base.basis.to(cuda), 2000, cfg)
    n_all = solve_kernel.launches - before[0]
    n_dual = solve_kernel.launches_dual - before[1]
    assert n_dual >= 1 and n_all - n_dual >= 1  # a dual and a primal phase
    done = (warm.status == st.OPTIMAL) | (warm.status == st.DUAL_UNBOUNDED)
    assert bool(done.all())
    _same_answers(warm, warm_cpu)
    assert warm.iters.double().mean() < 0.5 * base.iters.double().mean()


def test_warm_ipm_and_standard_form_on_card_launch_the_panel_kernel(cuda):
    import linprog_tpu_torch as lt

    _, (c, G, h) = _cpu_and_card(random_inequality_lps(16, 64, 64, seed=7),
                                 cuda)
    res, state = lt.ipm_solve_batch_canonical(c, G, h, return_state=True)
    before = cholinv_kernel.launches
    warm = lt.reoptimize_ipm_batch_canonical(c, G, h * 1.02, state)
    n_warm = cholinv_kernel.launches - before
    cold = lt.ipm_solve_batch_canonical(c, G, h * 1.02)
    n_cold = cholinv_kernel.launches - before - n_warm
    assert 0 < n_warm < n_cold
    ok = (warm.status == st.OPTIMAL) & (cold.status == st.OPTIMAL)
    assert int(ok.sum()) >= 14
    rel = ((warm.cost - cold.cost).abs() / cold.cost.abs().clamp_min(1.0))[ok]
    assert rel.max().item() <= 2e-3  # two answers of the eps_rel = 1e-3 class
    A = torch.cat([G, torch.eye(64, device=cuda).expand(16, 64, 64)], dim=2)
    cs = torch.cat([c, torch.zeros((16, 64), device=cuda)], dim=1)
    before = cholinv_kernel.launches
    std = lt.ipm_solve_batch_standard(cs, A, h)
    assert cholinv_kernel.launches > before
    np.testing.assert_array_equal(std.status.cpu().numpy(),
                                  res.status.cpu().numpy())


@pytest.mark.parametrize("prefer", ["simplex", "ipm", "ipm+crossover",
                                    "pdhg"])
def test_front_door_on_card_matches_cpu(cuda, prefer):
    import linprog_tpu_torch as lt

    cpu, card = _cpu_and_card(random_inequality_lps(16, 64, 64, seed=9), cuda)
    res_cpu, _ = lt.solve_batch_auto(*cpu, accuracy=1e-4, prefer=prefer)
    res, info = lt.solve_batch_auto(*card, accuracy=1e-4, prefer=prefer)
    assert info["family"] == prefer and res.x.shape == (16, 64)
    assert bool((res.status == st.OPTIMAL).all())
    # two interior answers of one eps class; vertices to 1e-5
    interior = prefer in ("ipm", "pdhg")
    _same_answers(res, res_cpu, tol=2e-3 if interior else 1e-5)


def test_rays_on_card(cuda):
    import linprog_tpu_torch as lt
    from linprog_tpu_torch.batch import unbounded_rays_from_result

    A = torch.tensor([[[1.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
                      [[-1.0, -1.0, 0.0], [0.0, 0.0, 1.0]]], device=cuda)
    b = torch.ones((2, 2), device=cuda)
    c = torch.tensor([[-1.0, -1.0, 0.0], [0.0, 0.0, 0.0]], device=cuda)
    res = lt.solve_batch_two_phase(c, A, b, 50, 50)
    assert res.status.tolist() == [st.PRIMAL_UNBOUNDED, st.PRIMAL_INFEASIBLE]
    rays = unbounded_rays_from_result(c, A, res)
    assert rays[0].tolist() == [1.0, 1.0, 0.0] and not bool(rays[1].any())
    y = res.y[1]
    assert bool((y @ A[1] <= 1e-6).all()) and float(y @ b[1]) > 0


# ---- the per-lane engines and the routes of the blocked-factor regime -----


def _dual_instance(B, m, n, seed):
    """Positive costs and a right-hand side with negative entries, started
    at the slack basis: dual feasible, primal infeasible (numpy)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, m, n)).astype(np.float32)
    c = (0.1 + rng.random((B, n))).astype(np.float32)
    h = rng.standard_normal((B, m)).astype(np.float32)
    A = np.concatenate([G, np.broadcast_to(np.eye(m, dtype=np.float32),
                                           (B, m, m))], axis=2)
    cs = np.concatenate([c, np.zeros((B, m), np.float32)], axis=1)
    basis = np.broadcast_to(np.arange(n, n + m, dtype=np.int32), (B, m))
    return cs, A, h, np.ascontiguousarray(basis)


@pytest.fixture
def blocked_shape(monkeypatch):
    """Every shape is a blocked-factor shape: the whole-segment gate shut,
    the streaming rule answering ``stream_blocked``."""
    import linprog_tpu_torch.engine_batched as teb

    monkeypatch.setattr(teb, "_mega_kernel_fits",
                        lambda m, n, with_at, **kw: False)
    monkeypatch.setattr(teb, "_stream_variant",
                        lambda m, n, **kw: ("stream_blocked", n))


def _exact_cost(cs, A, b, basis):
    x = solve_or_nan(basis_matrix(A.double(), basis), b.double())
    return (torch.gather(cs.double(), 1, basis.long()) * x).sum(dim=1)


def test_stream_kernel_unblocked_dual_at_a_blocked_shape(cuda, blocked_shape):
    """Dual mode at a blocked-factor shape launches the streaming kernel
    unblocked on the card; against the CPU run (its plain version) the same
    statuses and float64 costs at the final bases within 1e-5 relative."""
    from linprog_tpu_torch import engine
    from linprog_tpu_torch.config import SolverConfig
    from linprog_tpu_torch.engine_batched import run_batched

    cs, A, h, basis = _dual_instance(16, 48, 48, seed=4)
    cfg = SolverConfig(pricing="dantzig", refactor_every=16)
    out = {}
    for dev in ("cpu", cuda):
        tc, tA, th, tb = (torch.tensor(a, device=dev)
                          for a in (cs, A, h, basis))
        before = stream_kernel.launches
        s = run_batched(tc, tA, th, engine.make_state(tA, th, tb),
                        torch.ones(tc.shape[1], dtype=torch.bool,
                                   device=dev), 500, cfg, mode="dual")
        if dev != "cpu":
            assert stream_kernel.launches > before
        out[str(dev)] = (s, _exact_cost(tc, tA, th, s.basis).cpu())
    (p, pc), (k, kc) = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(k.status.cpu().numpy(), p.status.numpy())
    assert bool((p.status == st.OPTIMAL).any())
    opt = p.status == st.OPTIMAL
    rel = ((kc - pc).abs() / pc.abs().clamp_min(1.0))[opt]
    assert rel.max().item() <= 1e-5


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_kernel_block_branch_at_1280(cuda, packed):
    """[4, 1280, 2560], past the v5e line, on the streaming branch (the
    name dates from the block per lane it replaced): the same bits under
    every plan the branch offers, and 16 iterations in lockstep with the
    plain version."""
    m = 1280
    plans = bounded_kernel.segment_plans(4, m, 2 * m)
    assert len(plans) >= 2 and all(
        isinstance(pl, StreamingPlan) for pl in plans)
    A, c, lb, ub, b, state0 = _bounded_instance(4, m, m, seed=12, dev=cuda)
    kw = dict(seg_len=16, opt_tol=1e-6, pivot_tol=1e-7, packed=packed)
    k, p = _bounded_both(A, c, lb, ub, state0, **kw)
    assert bounded_kernel.last_plan in plans
    _assert_bounded_lockstep(k, p)
    for pl in plans:
        s = BoundedSegmentState(*(t.clone() for t in state0))
        bounded_kernel.launch_with_plan(pl, A, c, lb, ub, 1 << 20, s, **kw)
        torch.cuda.synchronize()
        for a, q in zip(s, k):
            torch.testing.assert_close(a, q, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_stream_one_iteration_from_the_slack_start(cuda, packed):
    """[16, 1280, 2560] (phase 16's lanes) from the all-slack start: zero
    duals and an identity factor, so every sum has one nonzero term, and
    one iteration equals the plain version's bit for bit on every lane."""
    m = 1280
    A, c, lb, ub, b, state0 = _bounded_instance(16, m, m, seed=16, dev=cuda)
    k, p = _bounded_both(A, c, lb, ub, state0, seg_len=1, opt_tol=1e-6,
                         pivot_tol=1e-7, packed=packed)
    assert isinstance(bounded_kernel.last_plan,
                      StreamingPlan)
    for name, a, q in zip(k._fields, k, p):
        torch.testing.assert_close(a, q, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    assert bool((k.iters == 1).all())


@pytest.mark.parametrize("m", [1280, 1279], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_stream_same_bits_under_every_plan_and_branch(cuda, packed,
                                                              m):
    """Past the cluster line, 16 iterations from a state 8 iterations into
    the solve (a dense factor: the sums reorder) give the same state bit
    for bit under every built layout of the streaming branch: 4 and 8 CTAs
    a lane, a ring that fills the SM or half of it, and on the aligned
    shape the scalar-load branch too (fixed row bands, one tree, the same
    order on both load branches)."""
    B = 4
    A, c, lb, ub, b, slack = _bounded_instance(B, m, m, seed=m, dev=cuda)
    kw = dict(opt_tol=1e-6, pivot_tol=1e-7, packed=packed)
    state0 = bounded_kernel.solve_bounded_segment_plain(
        A, c, lb, ub, 1 << 20,
        BoundedSegmentState(*(t.clone() for t in slack)), seg_len=8, **kw)
    plans = bounded_kernel.built_stream_plans(B, m, 2 * m)
    assert len(plans) >= 2
    assert any(not pl.aligned for pl in plans)
    if m % 4 == 0:
        assert any(pl.aligned for pl in plans)
    results = []
    for pl in plans:
        assert bounded_kernel.clusters_held(pl) > 0, pl
        s = BoundedSegmentState(*(t.clone() for t in state0))
        bounded_kernel.launch_with_plan(pl, A, c, lb, ub, 1 << 20, s,
                                        seg_len=16, **kw)
        torch.cuda.synchronize()
        results.append((pl, s))
    first = results[0][1]
    assert bool((first.iters == 24).any())
    for pl, s in results[1:]:
        for name, a, q in zip(s._fields, s, first):
            torch.testing.assert_close(a, q, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name} under {pl}")


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bounded_stream_lockstep_from_mid_solve_with_flips(cuda, packed):
    """[8, 1280, 2560] with upper bounds on half of x cut to a thousandth
    (so that an entering column of that half crosses to its other bound
    before any basic variable leaves) and infinite ones on the slacks, from
    a state 12 iterations into the solve:
    16 iterations in lockstep with the plain version (basis, variable
    states, status, iterations, c_B and the basic bounds equal on all but
    max(2, 16 of 1024) lanes, as the cluster-resident branch's mid-solve
    test allows for near ties that the sums' order decides; bfs within 1e-4
    of scale there), through bound flips, which the plain version's
    iteration-by-iteration run counts."""
    B, m = 8, 1280
    gen = torch.Generator(device=cuda).manual_seed(29)
    c, A, b, lb, ub = device_bounded_lps(gen, B, m, m, cuda)
    ub[:, : m // 2] *= 1e-3
    assert bool(torch.isinf(ub[:, m:]).all())
    _, _, _, _, _, slack = _bounded_instance(B, m, m, seed=29, dev=cuda)
    slack = slack._replace(bfs=b.clone())
    kw = dict(opt_tol=1e-6, pivot_tol=1e-7, packed=packed)
    state0 = bounded_kernel.solve_bounded_segment_plain(
        A, c, lb, ub, 1 << 20,
        BoundedSegmentState(*(t.clone() for t in slack)), seg_len=12, **kw)
    k, _ = _bounded_both(A, c, lb, ub, state0, seg_len=16, **kw)
    assert isinstance(bounded_kernel.last_plan,
                      StreamingPlan)
    p, flips = BoundedSegmentState(*(t.clone() for t in state0)), 0
    for _ in range(16):
        before = BoundedSegmentState(*(t.clone() for t in p))
        bounded_kernel.solve_bounded_segment_plain(A, c, lb, ub, 1 << 20, p,
                                                   seg_len=1, **kw)
        flips += int(((p.vstate != before.vstate).any(dim=1)
                      & (p.basis == before.basis).all(dim=1)).sum())
    assert flips > 0
    same = torch.ones(B, dtype=torch.bool, device=cuda)
    for name in ("basis", "vstate", "status", "iters", "cB", "lbB", "ubB"):
        a, q = getattr(k, name), getattr(p, name)
        same &= (a == q).reshape(B, -1).all(dim=1)
    assert int((~same).sum()) <= 2
    assert bool((k.iters == 28).any())
    scale = max(p.bfs[same].abs().max().item(), 1.0)
    assert (k.bfs[same] - p.bfs[same]).abs().max().item() <= 1e-4 * scale


def test_bounded_stream_path_matches_cpu(cuda):
    """solve_batch_bounded at B = 4, m = 640, n = 1280, past the cluster
    line, on the card (the streaming branch) against the CPU run (the plain
    version) of the same instances: the same statuses, objectives within
    1e-5 relative."""
    import linprog_tpu_torch as lt

    B, m = 4, 640
    assert isinstance(bounded_kernel.segment_plans(B, m, 2 * m)[0],
                      StreamingPlan)
    gen = torch.Generator().manual_seed(7)
    prob = device_bounded_lps(gen, B, m, m, "cpu")
    basis = torch.arange(m, 2 * m, dtype=torch.int32).expand(B, m)
    vs = torch.zeros((B, 2 * m), dtype=torch.int8)
    vs[:, m:] = bounded_kernel.BASIC
    cfg = lt.SolverConfig(pricing="dantzig", refactor_every=256,
                          polish_pivots=8, packed_select=True)
    res_cpu = lt.solve_batch_bounded(*prob, basis, vs, 20000, cfg)
    before = bounded_kernel.launches
    res = lt.solve_batch_bounded(*(t.to(cuda) for t in prob), basis.to(cuda),
                                 vs.to(cuda), 20000, cfg)
    assert bounded_kernel.launches > before
    assert isinstance(bounded_kernel.last_plan,
                      StreamingPlan)
    assert bool((res.status == st.OPTIMAL).all())
    np.testing.assert_array_equal(res.status.cpu().numpy(),
                                  res_cpu.status.numpy())
    rel = ((res.cost.cpu() - res_cpu.cost).abs()
           / res_cpu.cost.abs().clamp_min(1.0)).max().item()
    assert rel <= 1e-5


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_per_lane_engine_on_card_matches_cpu(cuda, mode):
    """``engine.run`` on CUDA tensors against CPU tensors: the same
    statuses, bases and iteration counts; basic values within 1e-4 of the
    lane's scale (refactorized every 8 pivots)."""
    from linprog_tpu_torch import engine
    from linprog_tpu_torch.config import SolverConfig

    if mode == "dual":
        cs, A, b, basis = _dual_instance(8, 12, 12, seed=2)
    else:
        c, G, h = random_inequality_lps(8, 12, 12, seed=1)
        cs = np.concatenate([c, np.zeros((8, 12), np.float32)], axis=1)
        A = np.concatenate([G, np.broadcast_to(np.eye(12, dtype=np.float32),
                                               (8, 12, 12))], axis=2)
        b = h
        basis = np.ascontiguousarray(np.broadcast_to(
            np.arange(12, 24, dtype=np.int32), (8, 12)))
    cfg = SolverConfig(pricing="dantzig", refactor_every=8, kernels="torch")
    out = []
    for dev in ("cpu", cuda):
        tc, tA, tb, tbas = (torch.tensor(a, device=dev)
                            for a in (cs, A, b, basis))
        s = engine.run(tc, tA, tb, engine.make_state(tA, tb, tbas),
                       torch.ones(tc.shape[1], dtype=torch.bool, device=dev),
                       200, cfg, mode)
        out.append(tuple(t.cpu() for t in s))
    p, k = out
    for i in (0, 3, 4):  # basis, iters, status
        torch.testing.assert_close(k[i], p[i], rtol=0, atol=0)
    scale = p[2].abs().amax(dim=1).clamp_min(1.0)
    assert bool(((k[2] - p[2]).abs().amax(dim=1) <= 1e-4 * scale).all())


def test_bounded_engine_on_card_matches_cpu(cuda):
    """``solve_batch_bounded(kernels="torch")`` (the per-lane bounded
    engine) on CUDA tensors against CPU tensors: the same statuses, bases
    and iteration counts, objectives within 1e-5 relative."""
    import linprog_tpu_torch as lt
    from linprog_tpu_torch.config import SolverConfig

    gen = torch.Generator().manual_seed(3)
    prob = device_bounded_lps(gen, 8, 10, 12, "cpu")
    basis = torch.arange(12, 22, dtype=torch.int32).expand(8, 10).contiguous()
    vs = torch.zeros((8, 22), dtype=torch.int8)
    vs[:, 12:] = bounded_kernel.BASIC
    cfg = SolverConfig(refactor_every=16, kernels="torch")
    p = lt.solve_batch_bounded(*prob, basis, vs, 500, cfg)
    k = lt.solve_batch_bounded(*(t.to(cuda) for t in prob), basis.to(cuda),
                               vs.to(cuda), 500, cfg)
    assert bool((p.status == st.OPTIMAL).all())
    for name in ("status", "basis", "iters"):
        torch.testing.assert_close(getattr(k, name).cpu(), getattr(p, name),
                                   rtol=0, atol=0)
    rel = ((k.cost.cpu() - p.cost).abs() / p.cost.abs().clamp_min(1.0))
    assert rel.max().item() <= 1e-5


def test_reoptimize_new_rhs_at_a_blocked_shape(cuda, blocked_shape):
    """The warm right-hand-side re-solve at a blocked-factor shape: the
    dual phase on the streaming kernel unblocked, the primal cleanup
    blocked, on the card against the CPU run; the same statuses and costs
    within 1e-5 relative."""
    import linprog_tpu_torch as lt
    from linprog_tpu_torch.batch import reoptimize_batch_new_rhs
    from linprog_tpu_torch.config import SolverConfig
    from linprog_tpu_torch.generators import to_standard_form_batch

    c, G, h = random_inequality_lps(16, 32, 32, seed=6)
    cs, As, bs = (torch.tensor(a) for a in to_standard_form_batch(c, G, h))
    cfg = SolverConfig(pricing="dantzig", refactor_every=16)
    base = lt.solve_batch_two_phase(cs, As, bs, 500, 500, cfg)
    assert bool((base.status == st.OPTIMAL).all())
    rng = np.random.default_rng(1)
    b_new = bs * torch.tensor(
        1.0 + 0.05 * rng.standard_normal(bs.shape), dtype=torch.float32)
    p = reoptimize_batch_new_rhs(cs, As, b_new, base.basis, 500, cfg)
    before = stream_kernel.launches
    k = reoptimize_batch_new_rhs(cs.to(cuda), As.to(cuda), b_new.to(cuda),
                                 base.basis.to(cuda), 500, cfg)
    assert stream_kernel.launches >= before + 2  # dual, then primal
    np.testing.assert_array_equal(k.status.cpu().numpy(), p.status.numpy())
    opt = p.status == st.OPTIMAL
    assert bool(opt.any())
    rel = ((k.cost.cpu() - p.cost).abs() / p.cost.abs().clamp_min(1.0))[opt]
    assert rel.max().item() <= 1e-5


# ---- the first-order and sparse families -----------------------------------


def _sparse_batch(B, m, n, dens, seed):
    from linprog_tpu_torch.generators import random_sparse_inequality_lps

    c, rows, cols, vals, h = random_sparse_inequality_lps(B, m, n, dens,
                                                          seed=seed)
    return rows, cols, [torch.tensor(a) for a in (c, vals, h)]


def test_sparse_normal_assembly_on_card_is_deterministic(cuda):
    """The assembly on the card: the same bits from two calls, within
    1e-6 of the largest entry of the CPU's, and the operator's products
    against the CPU's."""
    from linprog_tpu_torch.ipm_sparse import SparsePattern, _SparseSlackOp

    rows, cols, (c, vals, h) = _sparse_batch(16, 96, 96, 0.1, seed=3)
    pat = SparsePattern(rows, cols, 96, 96, device=cuda)
    gen = torch.Generator().manual_seed(0)
    d = torch.exp(18.0 * torch.rand((16, 192), generator=gen) - 9.0)
    cpu = _SparseSlackOp(pat.tables("cpu"), vals, 96, 96)
    card = _SparseSlackOp(pat.tables(cuda), vals.to(cuda), 96, 96)
    n1, n2 = card.normal(d.to(cuda)), card.normal(d.to(cuda))
    assert same_bits_t(n1, n2)
    ref = cpu.normal(d)
    assert (n1.cpu() - ref).abs().max() <= 1e-6 * ref.abs().max()
    v = torch.rand((16, 192), generator=gen)
    assert torch.allclose(card.mv(v.to(cuda)).cpu(), cpu.mv(v), atol=1e-5)
    w = torch.rand((16, 96), generator=gen)
    assert torch.allclose(card.mtv(w.to(cuda)).cpu(), cpu.mtv(w), atol=1e-5)


def same_bits_t(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_sparse_ipm_and_recovery_on_card_match_cpu(cuda):
    import linprog_tpu_torch as lt

    rows, cols, cpu = _sparse_batch(8, 24, 24, 0.3, seed=9)
    card = [t.to(cuda) for t in cpu]
    cfg = lt.IPMConfig(eps_rel=1e-3, maxiters=40)
    before = cholinv_kernel.launches
    res = lt.ipm_solve_batch_sparse_canonical(card[0], rows, cols, *card[1:],
                                              (24, 24), cfg)
    assert cholinv_kernel.launches > before
    res_cpu = lt.ipm_solve_batch_sparse_canonical(cpu[0], rows, cols,
                                                  *cpu[1:], (24, 24), cfg)
    _same_answers(res, res_cpu, tol=2e-3)
    starved = lt.IPMConfig(eps_rel=1e-3, maxiters=4)
    raw = lt.ipm_solve_batch_sparse_canonical(card[0], rows, cols, *card[1:],
                                              (24, 24), starved)
    before = solve_kernel.launches
    rec = lt.recover_stragglers_sparse(card[0], rows, cols, *card[1:],
                                       (24, 24), raw)
    assert solve_kernel.launches > before
    assert bool((rec.status == st.OPTIMAL).all())
    assert bool((rec.basis >= 0).all())


def test_pdhg_on_card_matches_cpu(cuda):
    import linprog_tpu_torch as lt
    from linprog_tpu_torch.pdhg import (
        PDHGConfig,
        pdhg_solve_batch_canonical,
        pdhg_solve_batch_sparse,
    )

    cpu, card = _cpu_and_card(random_inequality_lps(16, 48, 48, seed=2), cuda)
    cfg = PDHGConfig(eps_rel=1e-4, adaptive=False)
    _, cost_k, status_k, _ = pdhg_solve_batch_canonical(*card, cfg=cfg)
    _, cost_c, status_c, _ = pdhg_solve_batch_canonical(*cpu, cfg=cfg)
    assert bool((status_k == st.OPTIMAL).all())
    np.testing.assert_array_equal(status_k.cpu().numpy(), status_c.numpy())
    rel = (cost_k.cpu() - cost_c).abs() / cost_c.abs().clamp_min(1.0)
    assert rel.max().item() <= 2e-4

    rows, cols, (c, vals, h) = _sparse_batch(8, 48, 48, 0.1, seed=1)
    lb, ub = torch.zeros((8, 48)), torch.full((8, 48), float("inf"))
    scfg = PDHGConfig(eps_rel=1e-4)
    runs = [pdhg_solve_batch_sparse(*(t.to(cuda) for t in (c,)), rows, cols,
                                    *(t.to(cuda) for t in (vals, h)), 0,
                                    lb.to(cuda), ub.to(cuda), (48, 48),
                                    cfg=scfg) for _ in range(2)]
    for a, b in zip(*runs):  # the same bits twice
        assert torch.equal(a, b)
    ref = pdhg_solve_batch_sparse(c, rows, cols, vals, h, 0, lb, ub,
                                  (48, 48), cfg=scfg)
    np.testing.assert_array_equal(runs[0].status.cpu().numpy(),
                                  ref.status.numpy())
    # the general-form solver runs on the card by default
    res = lt.PDHGSolver(np.array([-1.0, -2.0]),
                        G=np.array([[1.0, 1.0], [0.0, 1.0]]),
                        h=np.array([4.0, 2.0])).solve()
    assert res.optimum and abs(res.cost + 6.0) < 1e-2


def test_pdhg_crossover_on_card(cuda):
    import linprog_tpu_torch as lt

    cpu, card = _cpu_and_card(random_inequality_lps(16, 32, 32, seed=4), cuda)
    before = solve_kernel.launches
    res, crossed = lt.pdhg_crossover_batch_canonical(*card)
    assert solve_kernel.launches > before  # the cleanup phases' segments
    assert int(crossed.sum()) >= 15
    res_cpu, crossed_cpu = lt.pdhg_crossover_batch_canonical(*cpu)
    both = crossed.cpu() & crossed_cpu
    rel = ((res.cost.cpu() - res_cpu.cost).abs()
           / res_cpu.cost.abs().clamp_min(1.0))[both]
    assert rel.numel() and rel.max().item() <= 1e-5


def test_pdhg_graphed_chunks_match_eager(cuda, monkeypatch):
    """The captured chunk of steps against the same steps launched one by
    one: the same statuses and answers, dense and sparse."""
    from linprog_tpu_torch import pdhg

    _, card = _cpu_and_card(random_inequality_lps(16, 48, 48, seed=3), cuda)
    cfg = pdhg.PDHGConfig(eps_rel=1e-4)
    rows, cols, (c, vals, h) = _sparse_batch(8, 48, 48, 0.1, seed=2)
    lb = torch.zeros((8, 48), device=cuda)
    ub = torch.full((8, 48), float("inf"), device=cuda)

    def both():
        dense = pdhg.pdhg_solve_batch_canonical(*card, cfg=cfg)
        sparse = pdhg.pdhg_solve_batch_sparse(
            c.to(cuda), rows, cols, vals.to(cuda), h.to(cuda), 0, lb, ub,
            (48, 48), cfg=cfg)
        return dense, sparse

    graphed = both()
    monkeypatch.setattr(pdhg, "_graphed", lambda chunk, state: chunk)
    eager = both()
    for a, b in ((graphed[0][2], eager[0][2]),
                 (graphed[1].status, eager[1].status)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert bool((graphed[0][2] == st.OPTIMAL).all())
    rel = ((graphed[0][1] - eager[0][1]).abs()
           / eager[0][1].abs().clamp_min(1.0))
    assert rel.max().item() <= 2e-4
    assert torch.allclose(graphed[1].x, eager[1].x, atol=1e-3)


# ---- the reference's last modes: split and sectional pricing, ablation -----


@pytest.mark.parametrize("m,n", [(32, 48), (128, 256), (1100, 1100)],
                         ids=["m32", "m128", "block"])
@pytest.mark.parametrize("pricing", [0, 1], ids=["bland", "dantzig"])
def test_segment_kernel_split_pricing_matches_plain(cuda, pricing, m, n):
    """Split-bf16 pricing, 16 pivots with stall escalation at 2, on the
    cluster branch (m = 32, 128) and the streaming branch (m = 1100, the id
    from the block per lane it replaced): the plain version's basis,
    status, iterations, c_B and penalties, and factors as accurate; the
    split path really ran (its own count)."""
    B = 8 if m > 512 else 64
    A, c, apen, h, state0 = _slack_instance(B, m, n, seed=pricing + 30,
                                            dual=False, dev=cuda,
                                            degenerate=False)
    before = solve_kernel.launches_split
    k, p = _both(A, c, apen, state0, seg_len=16, pricing=pricing,
                 opt_tol=1e-6, pivot_tol=1e-7, feas_tol=1e-6, stall_limit=2,
                 packed=True, split=True)
    assert solve_kernel.launches_split == before + 1
    assert isinstance(solve_kernel.last_plan,
                      StreamingPlan) == (m > 512)
    _assert_lockstep(A, h, k, p)
    assert bool((k.iters > 0).all())


def test_segment_kernel_split_same_answer_for_every_plan(cuda):
    """Split pricing keeps a lane's bits independent of the cluster size:
    the three partial sums run in the fixed band tree."""
    B, m, n = 8, 128, 256
    A, c, apen, h, state0 = _slack_instance(B, m, n, seed=31, dual=False,
                                            dev=cuda, degenerate=False)
    kw = dict(seg_len=48, pricing=1, opt_tol=1e-6, pivot_tol=1e-7,
              stall_limit=24, packed=True, split=True)
    results = []
    for pl in solve_kernel.segment_plans(B, m, n + m):
        s = SegmentState(*(t.clone() for t in state0))
        solve_kernel.launch_with_plan(pl, A, c, apen, 1 << 20, s, **kw)
        torch.cuda.synchronize()
        results.append(s)
    assert len(results) >= 2
    for s in results[1:]:
        for a, b in zip(s, results[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("ablate", range(8))
@pytest.mark.parametrize("m,n", [(128, 256), (1100, 1100)],
                         ids=["cluster", "block"])
def test_segment_kernel_ablation_modes_match_plain(cuda, m, n, ablate):
    """Each ablation mode, 4 iterations on both branches (m = 1100: the
    streaming branch, the id from the block per lane it replaced): the
    plain version's basis, status, iterations and penalties (what a mode
    drops is dropped in both); ablate = 0 gives the bits of a call without
    it."""
    B = 8
    A, c, apen, h, state0 = _slack_instance(B, m, n, seed=33, dual=False,
                                            dev=cuda, degenerate=False)
    kw = dict(seg_len=4, pricing=1, opt_tol=1e-6, pivot_tol=1e-7,
              stall_limit=2, packed=True)
    k, p = _both(A, c, apen, state0, ablate=ablate, **kw)
    assert isinstance(solve_kernel.last_plan,
                      StreamingPlan) == (m > 512)
    for name in ("basis", "status", "iters", "pen"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=0, atol=0)
    if ablate == 0:
        d = solve_kernel.solve_segment(
            A, c, apen, 512, SegmentState(*(t.clone() for t in state0)), **kw)
        torch.cuda.synchronize()
        for a, b in zip(k, d):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_segment_kernel_refuses_split_in_dual_mode_and_devex(cuda):
    A, c, apen, h, state = _slack_instance(2, 8, 8, seed=0, dual=True,
                                           dev=cuda)
    kw = dict(seg_len=4, opt_tol=1e-6, pivot_tol=1e-7, split=True)
    before = solve_kernel.launches
    with pytest.raises(ValueError, match="split pricing requires"):
        solve_kernel.solve_segment(A, c, apen, 10, state, pricing=1,
                                   dual=True, **kw)
    with pytest.raises(ValueError, match="split pricing requires"):
        solve_kernel.solve_segment(A, c, apen, 10, state, pricing=2, **kw)
    assert solve_kernel.launches == before


@pytest.mark.parametrize("B", [8, 64])
@pytest.mark.parametrize("n_blk", [16, 64])
@pytest.mark.parametrize("pricing", [0, 1], ids=["bland", "dantzig"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_stream_kernel_partial_pricing_matches_plain(cuda, packed, pricing,
                                                     n_blk, B):
    """Sectional pricing, 32 iterations with stall escalation at 2 (empty
    sections counted) at 8 and 2 CTAs a lane: the plain version's basis,
    status, iterations, c_B and penalties on every lane, factors as
    accurate; its own launch count."""
    A, c, apen, h, state0 = _slack_instance(B, 128, 128, seed=40 + pricing,
                                            dual=False, dev=cuda,
                                            degenerate=False)
    before = stream_kernel.launches_partial
    k, p = _stream_both(A, c, apen, state0, seg_len=32, pricing=pricing,
                        opt_tol=1e-6, pivot_tol=1e-7, feas_tol=1e-6,
                        stall_limit=2, packed=packed, partial=True,
                        n_blk=n_blk)
    assert stream_kernel.launches_partial == before + 1
    assert stream_kernel.last_plan.cluster == (8 if B == 8 else 2)
    _assert_lockstep(A, h, k, p)


def test_stream_kernel_partial_runs_to_optimal_like_plain(cuda):
    """Nondegenerate lanes to the end in one launch with sectional pricing:
    every lane OPTIMAL in both versions, and the same objective to 1e-5
    (over hundreds of pivots the two summation orders may split a lane's
    path at a near tie, so iterations are not compared)."""
    A, c, apen, h, state0 = _slack_instance(8, 64, 192, seed=44, dual=False,
                                            dev=cuda, degenerate=False)
    k, p = _stream_both(A, c, apen, state0, seg_len=4096, pricing=1,
                        opt_tol=1e-6, pivot_tol=1e-7, feas_tol=1e-6,
                        stall_limit=24, packed=True, partial=True, n_blk=64)
    assert bool((k.status == st.OPTIMAL).all())
    assert bool((p.status == st.OPTIMAL).all())

    def objective(s):
        xB = solve_or_nan(basis_matrix(A, s.basis), h)
        return (torch.gather(c, 1, s.basis.long()).double() * xB.double()).sum(1)

    ok, op = objective(k), objective(p)
    assert ((ok - op).abs() / op.abs().clamp_min(1.0)).max().item() <= 1e-5


def test_stream_kernel_partial_same_answer_for_every_plan(cuda):
    """8 and 2 CTAs a lane give the same bits in sectional mode."""
    B, m, n = 8, 128, 128
    A, c, apen, h, state0 = _slack_instance(B, m, n, seed=45, dual=False,
                                            dev=cuda, degenerate=False)
    kw = dict(seg_len=48, pricing=1, opt_tol=1e-6, pivot_tol=1e-7,
              stall_limit=24, packed=True, partial=True, n_blk=32)
    results = []
    for plan in stream_kernel.stream_plans(B, m, n + m):
        s = SegmentState(*(t.clone() for t in state0))
        stream_kernel.launch_with_plan(plan, A, c, apen, 1 << 20, s, **kw)
        torch.cuda.synchronize()
        results.append(s)
    assert len(results) == 2
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_two_phase_lane973_on_card_ends_feasible(cuda):
    """The lane of phase 20a that kernel 1's path ended at an infeasible
    basis (tests/data/two_phase_lane973.npz) solved on the card: OPTIMAL
    with x >= -1e-6 after the dual repair, cost within 1e-6 of HiGHS."""
    import pathlib

    from scipy.optimize import linprog

    import linprog_tpu_torch as lt
    from linprog_tpu_torch.config import tuned_config

    d = np.load(pathlib.Path(__file__).parent / "data" /
                "two_phase_lane973.npz")
    c, A, b = (torch.tensor(d[k], device=cuda) for k in ("c", "A", "b"))
    res = lt.solve_batch_two_phase(c, A, b, 4000, 4000, tuned_config(256))
    assert int(res.status[0]) == st.OPTIMAL
    assert float(res.x.min()) >= -1e-6
    ref = linprog(d["c"][0].astype(np.float64), A_eq=d["A"][0], b_eq=d["b"][0],
                  method="highs")
    assert abs(float(res.cost[0]) - ref.fun) <= 1e-6 * max(1.0, abs(ref.fun))


# ---- the double-word kernel (refine.py's split products and sums) ---------


def _dd_plain(bvec, y, M):
    """refine.py's eager chain on the same tensors: the plain version."""
    s, e = refine._dd_chunk_products(y, M, 8)
    parts = [s, e] if bvec is None else [bvec[:, None, :], -s, -e]
    return refine._kahan_sum_chunks(torch.cat(parts, dim=1))


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _dd_inputs(B, m, n, seed, dev, transposed):
    """y[B, m], M[B, m, n] (with ``transposed`` the transposed view of a
    contiguous [B, n, m], as refine.dd_residual passes it) and the f32
    product as bvec, so the residual is rounding-sized."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((B, m), generator=gen, device=dev)
    if transposed:
        M = torch.randn((B, n, m), generator=gen, device=dev).transpose(1, 2)
    else:
        M = torch.randn((B, m, n), generator=gen, device=dev)
    return torch.einsum("bm,bmn->bn", y, M), y, M


DD_SHAPES = [(1024, 256, 256), (1024, 512, 256), (32, 1024, 1024),
             (64, 1000, 1000), (3, 5, 1), (2, 7000, 40)]


@pytest.mark.card
@pytest.mark.parametrize("transposed", [False, True], ids=["rowmat", "view"])
@pytest.mark.parametrize("B,m,n", DD_SHAPES,
                         ids=["1024x256x256", "AT_1024x512x256",
                              "32x1024x1024", "pad_64x1000x1000", "tiny",
                              "scratch_2x7000x40"])
def test_dd_kernel_matches_plain_bit_for_bit(cuda, B, m, n, transposed):
    """The residual ``bvec - y M`` and the product ``y M``: the kernel's
    outputs equal the plain chain's in every bit.  [1024, 256, 256] is a
    basis matrix of the m = 256 cells, row-major (refine_duals) and as the
    transposed view (refine_bfs); [1024, 512, 256] the bounded cell's
    ``b - A x_N`` over ``A^T``; [32, 1024, 1024] the m = 1024 cell's; m =
    1000 ends on padded rows; 7000 rows put the chunks' pairs in the
    scratch buffer."""
    bvec, y, M = _dd_inputs(B, m, n, B + m + n, cuda, transposed)
    assert (dd_kernel.scratch_floats(B, m, n) > 0) == (m >= 7000)
    before = dd_kernel.launches
    for bv in (bvec, None):
        got = dd_kernel.chunk_products_sum(bv, y, M)
        _same_bits(got, _dd_plain(bv, y, M))
    torch.cuda.synchronize()
    assert dd_kernel.launches == before + 2


@pytest.mark.card
@pytest.mark.parametrize("transposed", [False, True], ids=["rowmat", "view"])
def test_dd_kernel_matches_plain_on_nonfinite_lanes(cuda, transposed):
    """One lane with an inf in y, one with a NaN in M, one with an inf in
    M and one with a zero y and signed zeros in bvec: the same bits, NaN
    and inf positions included (the card's NaN is canonical on both
    sides)."""
    bvec, y, M = _dd_inputs(1024, 256, 256, 7, cuda, transposed)
    y[3, 7] = float("inf")
    M[5, 2, 9] = float("nan")
    M[6, 255, 0] = -float("inf")
    y[8] = 0.0
    bvec[8, :2] = torch.tensor([-0.0, 0.0], device=cuda)
    for bv in (bvec, None):
        got = dd_kernel.chunk_products_sum(bv, y, M)
        _same_bits(got, _dd_plain(bv, y, M))
        assert bool(torch.isnan(got[3]).any()) and bool(
            torch.isnan(got[5, 9]))
        assert not bool(torch.isnan(got[10]).any())


@pytest.mark.card
def test_dd_kahan_sum_matches_plain_at_the_pricing_shape(cuda, monkeypatch):
    """``dd_rowmat(y, A)`` at the simplex cell's [1024, 256, 768]: its
    partials P[1024, 32, 768] summed by the kernel's sum-only entry point
    against ``_kahan_sum_chunks``, on P itself (with a NaN, an inf and a
    strided view) and through the public function."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    P = torch.randn((1024, 32, 768), generator=gen, device=cuda)
    P = P * 10.0 ** torch.randint(-6, 7, P.shape, generator=gen, device=cuda)
    P[0, 0, 0], P[1, 5, 1], P[2, 31, 2] = -0.0, float("inf"), float("nan")
    _same_bits(dd_kernel.kahan_sum(P), refine._kahan_sum_chunks(P))
    Pt = P.transpose(0, 2).contiguous().transpose(0, 2)  # strides (1, ., .)
    _same_bits(dd_kernel.kahan_sum(Pt), refine._kahan_sum_chunks(P))
    _, y, A = _dd_inputs(1024, 256, 768, 12, cuda, False)
    got = refine.dd_rowmat(y, A)
    monkeypatch.setattr(refine, "_on_card", lambda *ts: False)
    _same_bits(got, refine.dd_rowmat(y, A))


def _polish_both(fn, monkeypatch):
    """``fn()`` with the kernel (recorded) and with the plain chain on the
    same CUDA tensors; both results and the kernel run's spans."""
    obs.stop()
    rec = obs.start()
    before = dd_kernel.launches
    try:
        got = fn()
        torch.cuda.synchronize()
    finally:
        obs.stop()
    launched = dd_kernel.launches - before
    monkeypatch.setattr(refine, "_on_card", lambda *ts: False)
    want = fn()
    torch.cuda.synchronize()
    assert dd_kernel.launches == before + launched
    return got, want, launched, rec.calls()


@pytest.mark.card
def test_polish_batch_with_the_dd_kernel_matches_plain(cuda, monkeypatch):
    """A whole ``polish_batch`` at the m = 256 cells' [1024, 256, 512] from
    the slack basis, 3 rounds: the same basis, x_B, y, factor and rounds
    bit for bit, and the polish span's ``dd_launches`` is the kernel's
    count."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    c, A, b = device_standard_form_batch(
        *device_inequality_lps(gen, 1024, 256, 256, cuda))
    basis = torch.arange(256, 512, dtype=torch.int32,
                         device=cuda).expand(1024, 256).contiguous()
    allowed = torch.ones(512, dtype=torch.bool, device=cuda)
    active = torch.ones(1024, dtype=torch.bool, device=cuda)
    got, want, launched, calls = _polish_both(
        lambda: refine.polish_batch(c, A, b, basis, allowed, active,
                                    max_pivots=3),
        monkeypatch)
    for a, w in zip(got[:4], want[:4]):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    assert got[4] == want[4] > 0
    (call,) = calls
    assert call[0].name == "polish"
    assert call[0].counts["dd_launches"] == launched > 0


@pytest.mark.card
def test_polish_bounded_batch_with_the_dd_kernel_matches_plain(cuda,
                                                              monkeypatch):
    """A whole ``polish_bounded_batch`` at the bounded cell's [1024, 256,
    512] from the all-slack start, 3 rounds: the same basis, bound states,
    x_B, y and factor bit for bit."""
    A, c, lb, ub, b, state = _bounded_instance(1024, 256, 256, 23, cuda)
    active = torch.ones(1024, dtype=torch.bool, device=cuda)
    got, want, launched, calls = _polish_both(
        lambda: refine.polish_bounded_batch(c, A, b, lb, ub, state.basis,
                                            state.vstate, active,
                                            max_pivots=3),
        monkeypatch)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        if a.dtype == torch.float32:
            a, w = a.view(torch.int32), w.view(torch.int32)
        assert torch.equal(a, w)
    (call,) = calls
    assert call[0].name == "bounded_polish" and call[0].counts["pivots"] > 0
    assert call[0].counts["dd_launches"] == launched > 0
