#!/usr/bin/env python3
"""Smoke run of linprog_tpu_torch's exact pipeline on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line:
  0. environment: the card (nvidia-smi name and power limit), torch, CUDA
     and nvcc versions; TF32 is switched off and checked;
  1. build: compiles the CUDA kernels from csrc/ with nvcc, one process per
     source, all started together, and reports ptxas's registers and
     spills per kernel;
  2. panel_cholinv: CUDA kernel against its plain PyTorch version at the
     IPM's [1024, 32, 32] panels (SPD, cond ~1e3; a planted non-SPD lane);
  3. solve_segment: CUDA kernel against its plain version at crossover
     shapes (B = 1024, m = 256, n = 512), primal and dual mode, one
     iteration and a full segment;
  4. the m = 256 path: solve_batch_exact at B = 1024, m = n = 256 (wall:
     the median of 10 runs after a warm-up; launch counts from the first),
     then the dd-KKT certificate and a HiGHS check on 16 lanes;
  5. solve_segment_stream: the cluster kernel against its plain version at
     B = 64, (m, n) = (2048, 4096), primal and dual (one iteration in
     lockstep, then a 64-pivot segment), and at the two-phase shape
     (1024, 3072) and a ragged (1000, 2999), primal;
  6. the m = 2048 path: solve_batch_exact at B = 64, m = n = 2048 (wall:
     the median of 3 runs after a warm-up; launch counts from the first),
     the dd-KKT certificate on every lane, and one more run with stage
     timers.  HiGHS is skipped at this size (minutes per lane on the host);
     the oracle-free certificate is the check.
The line before the last lists each kernel (launches on its path, error
against its plain version, times).  The last line is
{"ok": true, "device": {...}} and is printed only if every phase passed;
any failure exits nonzero.  Without a CUDA device it exits nonzero at once.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import linprog_tpu_torch as lt
from linprog_tpu_torch import status as st
from linprog_tpu_torch.config import tuned_config
from linprog_tpu_torch.engine import basis_matrix, solve_or_nan
from linprog_tpu_torch.generators import device_inequality_lps
from linprog_tpu_torch.ops import _build
from linprog_tpu_torch.ops import cholinv_kernel as ck
from linprog_tpu_torch.ops import solve_kernel as sk
from linprog_tpu_torch.ops import stream_kernel as ssk

B = 1024
M = N = 256
SEED = 0
DEVICE = "cuda"
REPEATS = 10  # timed m = 256 runs after the warm-up (median reported)
XB, XM = 64, 2048  # the m = 2048 path: lanes, m = n
X_REPEATS = 3  # timed m = 2048 runs after the warm-up (median reported)


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def phase_environment():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = _build._nvcc()
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    nvcc_version = out[-1] if out else None
    env = {
        "phase": "environment",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_version,
        "nvcc_path": nvcc,
        "tf32": False,
    }
    emit(env)
    return env


def phase_build():
    t0 = time.time()
    path = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.time() - t0,
          "nvcc_seconds": _build.build_seconds, "library": path,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in _build.build_log.items()}})


def spd_batch(gen, b, mb, cond):
    """Random SPD matrices with eigenvalues log-spaced over [1/cond, 1]."""
    X = torch.randn((b, mb, mb), generator=gen, device=DEVICE,
                    dtype=torch.float64)
    Q, _ = torch.linalg.qr(X)
    lam = torch.logspace(0, -np.log10(cond), mb, device=DEVICE,
                         dtype=torch.float64)
    Mat = (Q * lam[None, None, :]) @ Q.transpose(1, 2)
    return (0.5 * (Mat + Mat.transpose(1, 2))).float().contiguous()


def phase_cholinv():
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    Mat = spd_batch(gen, B, 32, 1e3)
    Mat[7] = -Mat[7]  # planted non-SPD lane
    W = ck.panel_cholinv(Mat)
    Wp = ck.panel_cholinv_plain(Mat)
    torch.cuda.synchronize()
    good = torch.ones(B, dtype=torch.bool, device=DEVICE)
    good[7] = False
    for name, w in (("kernel", W), ("plain", Wp)):
        if torch.isfinite(w[7]).all():
            fail(f"panel_cholinv {name}: planted non-SPD lane came out finite")
        if not torch.isfinite(w[good]).all():
            fail(f"panel_cholinv {name}: non-finite output on an SPD lane")
    err = (W[good] - Wp[good]).abs().max().item()
    rel = err / Wp[good].abs().max().item()
    if not rel <= 1e-4:
        fail(f"panel_cholinv: kernel vs plain max relative diff {rel:.3e} > 1e-4")
    ms = cuda_ms(lambda: ck.panel_cholinv(Mat), 20)
    plain_ms = cuda_ms(lambda: ck.panel_cholinv_plain(Mat), 20)
    out = {"phase": "panel_cholinv", "shape": [B, 32, 32], "cond": 1e3,
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": 1e-4,
           "ms": ms, "plain_ms": plain_ms, "reps": 20}
    emit(out)
    return out


def _segment_instance(dual, b=B, m=M, n_g=N, seed=SEED + 2):
    """A crossover-shaped lane batch ([G | I], b x m x (n_g + m)) from the
    slack basis: primal mode on Gx <= |h| (feasible start), dual mode on
    min |c|'x, Gx <= h (dual-feasible start)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    c, G, h = device_inequality_lps(gen, b, m, n_g, DEVICE)
    if dual:
        c = c.abs()
    else:
        h = h.abs()
    eye = torch.eye(m, device=DEVICE).expand(b, m, m)
    A = torch.cat([G, eye], dim=2).contiguous()
    cs = torch.cat([c, torch.zeros((b, m), device=DEVICE)], dim=1).contiguous()
    n = n_g + m
    basis = torch.arange(n_g, n, dtype=torch.int32, device=DEVICE).expand(b, m)
    pen = torch.zeros((b, n), device=DEVICE)
    pen[:, n_g:] = float("inf")
    state = sk.SegmentState(
        invBT=eye.contiguous().clone(),
        bfs=h.contiguous().clone(),
        cB=torch.zeros((b, m), device=DEVICE),
        basis=basis.contiguous().clone(),
        pen=pen,
        gamma=torch.ones((b, n), device=DEVICE),
        iters=torch.zeros(b, dtype=torch.int32, device=DEVICE),
        status=torch.zeros(b, dtype=torch.int32, device=DEVICE),
    )
    apen = torch.zeros((b, n), device=DEVICE)
    return A, cs, apen, h, state


def _near_tie(keys, bits):
    """bool[B]: the two smallest packed keys lie within one tie bucket."""
    k = keys.long().sort(dim=1).values
    k1, k2 = k[:, 0], k[:, 1]
    return (k2 != sk.INTMAX) & ((k2 >> bits) - (k1 >> bits) <= 1)


def _tie_lanes(A, c, state, dual, cfg):
    """Lanes whose one-iteration choice may flip under summation-order
    noise: the two best packed keys (entering, then leaving) are within
    one low-bit tie bucket."""
    Bn, m, n = A.shape
    bits_n = max(1, (n - 1).bit_length())
    bits_m = max(1, (m - 1).bit_length())
    lane_n = torch.arange(n, dtype=torch.int32, device=DEVICE)
    lane_m = torch.arange(m, dtype=torch.int32, device=DEVICE)
    invBT, bfs, cB, pen = state.invBT, state.bfs, state.cB, state.pen
    y = torch.einsum("bi,bji->bj", cB, invBT)
    if dual:
        neg = bfs < -cfg.feas_tol
        kl = sk.pack_min_keys(bfs, neg, lane_m, bits_m, True).min(dim=1).values
        leave = torch.where(kl != sk.INTMAX, kl & ((1 << bits_m) - 1), 0)
        w = torch.gather(invBT, 2, leave.long()[:, None, None].expand(Bn, m, 1))[:, :, 0]
        urow = torch.einsum("bj,bjk->bk", w, A)
        r = c - torch.einsum("bj,bjk->bk", y, A)
        cand = (urow < -cfg.pivot_tol) & (pen == 0.0)
        theta = torch.where(cand, -r / torch.where(cand, urow, -1.0), float("inf"))
        keys = sk.pack_min_keys(torch.clamp_min(theta, 0.0) + 0.0, cand, lane_n,
                             bits_n, False)
        return _near_tie(keys, bits_n)
    r = c - torch.einsum("bj,bjk->bk", y, A) + pen
    neg = r < -cfg.opt_tol
    keys = sk.pack_min_keys(r, neg, lane_n, bits_n, True)
    tie = _near_tie(keys, bits_n)
    k0 = keys.min(dim=1).values
    enter = torch.where(k0 != sk.INTMAX, k0 & ((1 << bits_n) - 1), 0)
    a = torch.gather(A, 2, enter.long()[:, None, None].expand(Bn, m, 1))[:, :, 0]
    d = torch.einsum("bj,bji->bi", a, invBT)
    pos = d > cfg.pivot_tol
    theta = torch.where(pos, (torch.clamp_min(bfs, 0.0) + 0.0)
                        / torch.where(pos, d, 1.0), float("inf"))
    tkeys = sk.pack_min_keys(theta, pos, lane_m, bits_m, False)
    return tie | _near_tie(tkeys, bits_m)


def _exact_objective(A, c, h, seg):
    xB = solve_or_nan(basis_matrix(A, seg.basis), h)
    cB = torch.gather(c, 1, seg.basis.long())
    return (cB.double() * xB.double()).sum(dim=1)


def phase_segment():
    cfg = tuned_config(M)
    out = {"phase": "solve_segment", "shape": [B, M, N + M],
           "config": {"pricing": cfg.pricing, "packed": cfg.packed_select,
                      "stall_limit": cfg.stall_limit}}
    worst_err = 0.0
    one_ms = {}
    for mode in ("primal", "dual"):
        dual = mode == "dual"
        A, c, apen, h, state0 = _segment_instance(dual)
        kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
                  dual=dual, feas_tol=cfg.feas_tol,
                  stall_limit=cfg.stall_limit, packed=cfg.packed_select)

        def fresh():
            return sk.SegmentState(*(t.clone() for t in state0))

        # (a) one iteration from the same state
        sk_k = sk.solve_segment(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
        sk_p = sk.solve_segment_plain(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
        torch.cuda.synchronize()
        tie = _tie_lanes(A, c, state0, dual, cfg)
        keep = ~tie
        same_basis = (sk_k.basis == sk_p.basis).all(dim=1)
        same_status = sk_k.status == sk_p.status
        bad = keep & ~(same_basis & same_status)
        if bad.any():
            fail(f"solve_segment {mode}: one-iteration basis/status differ on "
                 f"{int(bad.sum())} non-tied lanes")
        err1 = (sk_k.bfs[keep] - sk_p.bfs[keep]).abs().max().item()
        worst_err = max(worst_err, err1)
        pivoted = int((sk_k.basis != state0.basis).any(dim=1).sum())

        # one-iteration times (state copies outside the timed region)
        states = [fresh() for _ in range(21)]
        it_k = iter(states)
        ms_k = cuda_ms(lambda: sk.solve_segment(A, c, apen, 1 << 20, next(it_k),
                                                seg_len=1, **kw), 20)
        states = [fresh() for _ in range(21)]
        it_p = iter(states)
        ms_p = cuda_ms(lambda: sk.solve_segment_plain(
            A, c, apen, 1 << 20, next(it_p), seg_len=1, **kw), 20)
        one_ms[mode] = (ms_k, ms_p)

        # (b) a full segment from the same state: every lane terminates
        seg_len = 8 * M
        full = {}
        for name, fn in (("kernel", sk.solve_segment),
                         ("plain", sk.solve_segment_plain)):
            s = fresh()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(A, c, apen, seg_len, s, seg_len=seg_len, **kw)
            t1.record()
            torch.cuda.synchronize()
            full[name] = (s, t0.elapsed_time(t1))
        sk_full, ms_full_k = full["kernel"]
        sp_full, ms_full_p = full["plain"]
        if not torch.equal(sk_full.status, sp_full.status):
            fail(f"solve_segment {mode}: full-segment statuses differ on "
                 f"{int((sk_full.status != sp_full.status).sum())} lanes")
        both = (sk_full.status == st.OPTIMAL) & (sp_full.status == st.OPTIMAL)
        ok_k = _exact_objective(A, c, h, sk_full)
        ok_p = _exact_objective(A, c, h, sp_full)
        rel = ((ok_k - ok_p).abs() / ok_p.abs().clamp_min(1.0))[both]
        rel_max = rel.max().item() if rel.numel() else 0.0
        if not rel_max <= 1e-5:
            fail(f"solve_segment {mode}: full-segment objectives differ by "
                 f"{rel_max:.3e} relative (> 1e-5)")
        out[mode] = {
            "one_iter": {"excluded_tie_lanes": int(tie.sum()),
                         "pivoted_lanes": pivoted,
                         "max_abs_err_bfs": err1,
                         "ms": ms_k, "plain_ms": ms_p, "reps": 20},
            "full_segment": {
                "seg_len": seg_len,
                "status_counts": {st.status_name(k): int(v) for k, v in zip(
                    *torch.unique(sk_full.status, return_counts=True))},
                "optimal_both": int(both.sum()),
                "max_rel_obj_diff": rel_max, "tol_rel": 1e-5,
                "max_iters_kernel": int(sk_full.iters.max()),
                "max_iters_plain": int(sp_full.iters.max()),
                "ms": ms_full_k, "plain_ms": ms_full_p,
            },
        }
    emit(out)
    return {"max_abs_err": worst_err, "ms": one_ms["primal"][0],
            "plain_ms": one_ms["primal"][1]}


def phase_main_path():
    """Phase 4: solve_batch_exact at B = 1024, m = n = 256."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, B, M, N, DEVICE)

    t0 = time.time()
    lt.solve_batch_exact(c, G, h)  # warm-up
    torch.cuda.synchronize()
    warm = time.time() - t0

    sk.launches = 0
    ck.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res, info = lt.solve_batch_exact(c, G, h)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"solve_segment": sk.launches,
                "panel_cholinv": ck.launches}

    walls = [wall]
    for _ in range(REPEATS - 1):
        t0 = time.time()
        lt.solve_batch_exact(c, G, h)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall_med = float(np.median(walls))

    t1 = time.time()
    cert = lt.certify_vertex_batch(c, G, h, res.basis)
    summ = lt.certificate_summary(cert)
    torch.cuda.synchronize()
    cert_wall = time.time() - t1
    okc = cert["certified"]
    worst = None
    if okc.any():
        worst = max(cert["primal_residual"][okc].max().item(),
                    cert["gap"][okc].max().item())

    status = res.status.cpu().numpy()
    counts = {st.status_name(k): int(v)
              for k, v in zip(*np.unique(status, return_counts=True))}
    if res.x.shape != (B, N) or not torch.isfinite(res.cost).all():
        fail("main path: result has the wrong shape or non-finite costs")

    from scipy.optimize import linprog

    k = 16
    cs, Gs, hs = (t[:k].double().cpu().numpy() for t in (c, G, h))
    cost = res.cost[:k].double().cpu().numpy()
    gaps, highs_s = [], []
    for i in range(k):
        t2 = time.time()
        ref = linprog(cs[i], A_ub=Gs[i], b_ub=hs[i], bounds=(0, None),
                      method="highs")
        highs_s.append(time.time() - t2)
        if ref.status != 0:
            fail(f"main path: HiGHS did not solve lane {i} ({ref.message})")
        gaps.append(abs(cost[i] - ref.fun) / max(1.0, abs(ref.fun)))
    max_gap = float(max(gaps))

    out = {
        "phase": "main_path", "lanes": B, "m": M, "n": N, "seed": SEED,
        "lane_status": counts, "crossed": info["crossed"],
        "fallback": info["fallback"], "certified": summ["certified"],
        "certificate": summ, "max_kkt_residual": worst,
        "wall_s": wall_med, "walls_s": walls, "warmup_wall_s": warm,
        "lps_per_sec": B / wall_med,
        "cert_wall_s": cert_wall, "launches": launches,
        "highs_lanes": k, "max_rel_gap_vs_highs": max_gap,
        "highs_median_s": float(np.median(highs_s)),
        "iters_total": int(res.iters.sum()),
    }
    emit(out)
    n_opt = int((status == st.OPTIMAL).sum())
    if n_opt != B:
        fail(f"main path: {n_opt}/{B} lanes OPTIMAL")
    if summ["certified"] < 1020:
        fail(f"main path: {summ['certified']}/{B} certified (< 1020)")
    if not max_gap <= 1e-5:
        fail(f"main path: HiGHS gap {max_gap:.3e} > 1e-5")
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"main path: kernel {name} was never launched")
    return launches


def _hold_stream(label, A, c, apen, h, state0, cfg, dual, seg_len, reps):
    """The cluster kernel against its plain version from one state: one
    iteration in lockstep (the same basis and status on every lane that
    _tie_lanes does not exclude), then a ``seg_len``-pivot segment (the
    same statuses, float64 objectives at the final bases within 1e-5
    relative).  Returns a report with CUDA-event times of both."""
    kw = dict(pricing=1, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
              dual=dual, feas_tol=cfg.feas_tol, stall_limit=cfg.stall_limit,
              packed=cfg.packed_select, a_resident=False, n_blk=512)

    def fresh():
        return sk.SegmentState(*(t.clone() for t in state0))

    k1 = ssk.solve_segment_stream(A, c, apen, 1 << 20, fresh(), seg_len=1, **kw)
    p1 = ssk.solve_segment_stream_plain(A, c, apen, 1 << 20, fresh(),
                                        seg_len=1, **kw)
    torch.cuda.synchronize()
    keep = ~_tie_lanes(A, c, state0, dual, cfg)
    same = (k1.basis == p1.basis).all(dim=1) & (k1.status == p1.status)
    if (keep & ~same).any():
        fail(f"solve_segment_stream {label}: one-iteration basis/status "
             f"differ on {int((keep & ~same).sum())} non-tied lanes")
    err1 = (k1.bfs[keep] - p1.bfs[keep]).abs().max().item()
    pivoted = int((k1.basis != state0.basis).any(dim=1).sum())
    del k1, p1

    # one-iteration times (state copies outside the timed region)
    times = {}
    for name, fn in (("kernel", ssk.solve_segment_stream),
                     ("plain", ssk.solve_segment_stream_plain)):
        states = iter([fresh() for _ in range(reps)])
        times[name] = cuda_ms(lambda: fn(A, c, apen, 1 << 20, next(states),
                                         seg_len=1, **kw), reps)
        del states

    full = {}
    for name, fn in (("kernel", ssk.solve_segment_stream),
                     ("plain", ssk.solve_segment_stream_plain)):
        s = fresh()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(A, c, apen, 1 << 20, s, seg_len=seg_len, **kw)
        t1.record()
        torch.cuda.synchronize()
        full[name] = (s, t0.elapsed_time(t1))
    sk_full, sp_full = full["kernel"][0], full["plain"][0]
    if not torch.equal(sk_full.status, sp_full.status):
        fail(f"solve_segment_stream {label}: {seg_len}-pivot statuses differ "
             f"on {int((sk_full.status != sp_full.status).sum())} lanes")
    ok_k = _exact_objective(A, c, h, sk_full)
    ok_p = _exact_objective(A, c, h, sp_full)
    rel = ((ok_k - ok_p).abs() / ok_p.abs().clamp_min(1.0)).max().item()
    split = int((sk_full.basis != sp_full.basis).any(dim=1).sum())
    if not rel <= 1e-5:
        fail(f"solve_segment_stream {label}: {seg_len}-pivot objectives "
             f"differ by {rel:.3e} relative (> 1e-5); bases split on {split} "
             "lanes")
    return {
        "shape": list(A.shape), "mode": "dual" if dual else "primal",
        "resident_clusters": _build.library()
        .lp_solve_segment_stream_max_clusters(A.shape[1], A.shape[2]),
        "one_iter": {"excluded_tie_lanes": int((~keep).sum()),
                     "pivoted_lanes": pivoted,
                     "max_abs_err_bfs": err1, "ms": times["kernel"],
                     "plain_ms": times["plain"], "reps": reps},
        "segment": {"seg_len": seg_len,
                    "status_counts": {st.status_name(k): int(v) for k, v in
                                      zip(*torch.unique(sk_full.status,
                                                        return_counts=True))},
                    "lanes_with_other_basis": split,
                    "max_rel_obj_diff": rel, "tol_rel": 1e-5,
                    "ms": full["kernel"][1], "plain_ms": full["plain"][1]},
    }


def phase_stream():
    """Phase 5: the cluster kernel at the m = 2048 path's shapes."""
    cfg = tuned_config(XM, refactor_every=128, unroll=2)
    out = {"phase": "solve_segment_stream",
           "config": {"pricing": cfg.pricing, "packed": cfg.packed_select,
                      "stall_limit": cfg.stall_limit}, "runs": []}
    cases = [("crossover primal", False, XB, XM, XM),
             ("crossover dual", True, XB, XM, XM),
             ("two-phase 1024", False, XB, 1024, 2048),
             ("ragged", False, XB, 1000, 1999)]
    for label, dual, b, m, n_g in cases:
        A, c, apen, h, state0 = _segment_instance(dual, b, m, n_g, SEED + 3)
        out["runs"].append(_hold_stream(label, A, c, apen, h, state0, cfg,
                                        dual, 64, 5))
        del A, c, apen, h, state0
        torch.cuda.empty_cache()
    emit(out)
    first = out["runs"][0]
    return {"max_abs_err": max(r["one_iter"]["max_abs_err_bfs"]
                               for r in out["runs"]),
            "ms": first["one_iter"]["ms"],
            "plain_ms": first["one_iter"]["plain_ms"]}


def _stage_walls(run):
    """Run ``run()`` once with stage timers: each listed function wrapped
    with torch.cuda.synchronize() on both sides (nested stages overlap
    their parents, and the syncs slow the run).  Returns seconds per
    stage and the run's wall."""
    import linprog_tpu_torch.batch as lb
    import linprog_tpu_torch.crossover as lx
    import linprog_tpu_torch.engine_batched as le
    import linprog_tpu_torch.ipm as li
    import linprog_tpu_torch.refine as lr

    acc = {}
    saved = []

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        def timed(*a, **k):
            key = label(a) if callable(label) else label
            torch.cuda.synchronize()
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                acc[key] = acc.get(key, 0.0) + time.time() - t0

        saved.append((mod, name, fn))
        setattr(mod, name, timed)

    wrap(li, "ipm_canonical_state", "ipm")
    wrap(lx, "_run_chunked", lambda a: f"crossover_{a[7]}_phases")
    wrap(lr, "polish_batch", "polish")
    wrap(lb, "solve_batch_two_phase", "fallback")
    wrap(le, "solve_segment_stream", "stream_kernel")
    wrap(le, "compact_refactorize", "refactorize")
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return {k: round(v, 4) for k, v in acc.items()}, wall


def phase_exact_m2048():
    """Phase 6: solve_batch_exact at B = 64, m = n = 2048."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, G, h = device_inequality_lps(gen, XB, XM, XM, DEVICE)

    t0 = time.time()
    lt.solve_batch_exact(c, G, h)  # warm-up
    torch.cuda.synchronize()
    warm = time.time() - t0

    sk.launches = ck.launches = ssk.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    res, info = lt.solve_batch_exact(c, G, h)
    torch.cuda.synchronize()
    walls = [time.time() - t0]
    launches = {"solve_segment_stream": ssk.launches,
                "panel_cholinv": ck.launches, "solve_segment": sk.launches}
    for _ in range(X_REPEATS - 1):
        t0 = time.time()
        lt.solve_batch_exact(c, G, h)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall_med = float(np.median(walls))

    t1 = time.time()
    cert = lt.certify_vertex_batch(c, G, h, res.basis)
    summ = lt.certificate_summary(cert)
    torch.cuda.synchronize()
    cert_wall = time.time() - t1

    stages, stage_run_wall = _stage_walls(lambda: lt.solve_batch_exact(c, G, h))
    uncertified = [
        {"lane": i, **{k: float(cert[k][i]) for k in
                       ("primal_residual", "min_xB", "min_reduced_cost", "gap")}}
        for i in torch.nonzero(~cert["certified"]).flatten().tolist()
    ]

    status = res.status.cpu().numpy()
    counts = {st.status_name(k): int(v)
              for k, v in zip(*np.unique(status, return_counts=True))}
    out = {
        "phase": "exact_m2048", "lanes": XB, "m": XM, "n": XM, "seed": SEED,
        "lane_status": counts, "crossed": info["crossed"],
        "retry_crossed": info["retry_crossed"], "fallback": info["fallback"],
        "certified": summ["certified"], "certificate": summ,
        "uncertified": uncertified,
        "wall_s": wall_med, "walls_s": walls, "warmup_wall_s": warm,
        "lps_per_sec": XB / wall_med, "cert_wall_s": cert_wall,
        "launches": launches, "iters_total": int(res.iters.sum()),
        "stage_s": stages, "stage_run_wall_s": stage_run_wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(out)
    if res.x.shape != (XB, XM) or not torch.isfinite(res.cost).all():
        fail("m = 2048 path: result has the wrong shape or non-finite costs")
    n_opt = int((status == st.OPTIMAL).sum())
    if n_opt != XB:
        fail(f"m = 2048 path: {n_opt}/{XB} lanes OPTIMAL")
    if summ["certified"] < XB - 1:
        fail(f"m = 2048 path: {summ['certified']}/{XB} certified (< {XB - 1})")
    for name in ("solve_segment_stream", "panel_cholinv"):
        if launches[name] <= 0:
            fail(f"m = 2048 path: kernel {name} was never launched")
    return launches


def main():
    phase_environment()
    phase_build()
    chol = phase_cholinv()
    seg = phase_segment()
    launches = phase_main_path()
    stream = phase_stream()
    x_launches = phase_exact_m2048()
    emit({"kernels": [
        {"name": "solve_segment", "route": "cuda",
         "source": "linprog_tpu_torch/csrc/solve_segment.cu",
         "replaces": "linprog_tpu/ops/solve_kernel.py:552",
         "launches": launches["solve_segment"],
         "max_abs_err": seg["max_abs_err"],
         "ms": seg["ms"], "plain_ms": seg["plain_ms"]},
        {"name": "panel_cholinv", "route": "cuda",
         "source": "linprog_tpu_torch/csrc/panel_cholinv.cu",
         "replaces": "linprog_tpu/ops/cholinv_kernel.py:80",
         "launches": launches["panel_cholinv"],
         "max_abs_err": chol["max_abs_err"],
         "ms": chol["ms"], "plain_ms": chol["plain_ms"]},
        {"name": "solve_segment_stream", "route": "cuda",
         "source": "linprog_tpu_torch/csrc/solve_segment_stream.cu",
         "replaces": "linprog_tpu/ops/stream_kernel.py:609",
         "launches": x_launches["solve_segment_stream"],
         "max_abs_err": stream["max_abs_err"],
         "ms": stream["ms"], "plain_ms": stream["plain_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
