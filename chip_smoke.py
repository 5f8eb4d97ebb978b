#!/usr/bin/env python3
"""Smoke run of linprog_tpu_torch's exact pipeline on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line:
  0. environment: the card (nvidia-smi name and power limit), torch, CUDA
     and nvcc versions; TF32 is switched off and checked;
  1. build: compiles the CUDA kernels from csrc/ with nvcc;
  2. panel_cholinv: CUDA kernel against its plain PyTorch version at the
     IPM's [1024, 32, 32] panels (SPD, cond ~1e3; a planted non-SPD lane);
  3. solve_segment: CUDA kernel against its plain version at crossover
     shapes (B = 1024, m = 256, n = 512), primal and dual mode, one
     iteration and a full segment;
  4. the main path: solve_batch_exact at B = 1024, m = n = 256 (wall: the
     median of 10 runs after a warm-up; launch counts from the first), then
     the dd-KKT certificate and a HiGHS check on 16 lanes.
The line before the last lists each kernel (launches on the main path,
error against its plain version, times).  The last line is
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

B = 1024
M = N = 256
SEED = 0
DEVICE = "cuda"
REPEATS = 10  # timed main-path runs after the warm-up (median reported)


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
          "nvcc_seconds": _build.build_seconds, "library": path})


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


def _segment_instance(dual):
    """A crossover-shaped lane batch ([G | I], B x 256 x 512) from the slack
    basis: primal mode on Gx <= |h| (feasible start), dual mode on
    min |c|'x, Gx <= h (dual-feasible start)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    c, G, h = device_inequality_lps(gen, B, M, N, DEVICE)
    if dual:
        c = c.abs()
    else:
        h = h.abs()
    eye = torch.eye(M, device=DEVICE).expand(B, M, M)
    A = torch.cat([G, eye], dim=2).contiguous()
    cs = torch.cat([c, torch.zeros((B, M), device=DEVICE)], dim=1).contiguous()
    n = N + M
    basis = torch.arange(N, n, dtype=torch.int32, device=DEVICE).expand(B, M)
    pen = torch.zeros((B, n), device=DEVICE)
    pen[:, N:] = float("inf")
    state = sk.SegmentState(
        invBT=eye.contiguous().clone(),
        bfs=h.contiguous().clone(),
        cB=torch.zeros((B, M), device=DEVICE),
        basis=basis.contiguous().clone(),
        pen=pen,
        gamma=torch.ones((B, n), device=DEVICE),
        iters=torch.zeros(B, dtype=torch.int32, device=DEVICE),
        status=torch.zeros(B, dtype=torch.int32, device=DEVICE),
    )
    apen = torch.zeros((B, n), device=DEVICE)
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


def main():
    phase_environment()
    phase_build()
    chol = phase_cholinv()
    seg = phase_segment()
    launches = phase_main_path()
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
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
