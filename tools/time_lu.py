#!/usr/bin/env python3
"""The batched LU kernel (``csrc/batched_lu.cu``) against its plain version
and against ``torch.linalg`` on a CUDA card.

Run from the repository root on a machine with a CUDA device:

    python3 tools/time_lu.py [--profile] [--shapes B:m ...]

For each shape (default: the paths' [1024, 256, 256], [8, 256, 256],
[1, 256, 256] and [1024, 128, 128], and [64, 250, 250]) it prints one JSON
line: the kernel's launch plan; the relative error of the kernel, of the
plain version and of ``torch.linalg`` in float32 against
``torch.linalg`` in float64 on the card (largest and median over lanes);
the median and range of 3 timings of back-to-back calls (CUDA events) of
the kernel's inverse and solve, of ``inv_ex`` / ``solve_ex`` in float32
(``library_ms``: the yardstick, which the port no longer calls at these
shapes) and of the plain version; and the operation bound at 67 TFLOP/s
(2 m^3 flops a lane for the inverse, 2/3 m^3 for the solve).
``--profile`` adds a ``torch.profiler`` count of one ``inv_ex`` call at
[1024, 256, 256]: device kernels, launches, allocations, frees and
synchronisations, by name.  The last line is ``{"ok": true, ...}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from linprog_tpu_torch.ops import _build, lu_kernel  # noqa: E402

DEFAULT_SHAPES = [(1024, 256), (8, 256), (1, 256), (1024, 128), (64, 250)]
PEAK_FLOPS = 67e12
REPS = {1024: 10, 64: 20}


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed(fn, reps):
    """Median and range of 3 timings of ``reps`` calls back to back, ms a
    call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return {"ms": statistics.median(out), "range": [min(out), max(out)]}


def rel_err(got, want):
    """Largest and median over lanes of max|got - want| / max|want|."""
    d = (got.double() - want).abs().reshape(got.shape[0], -1).amax(dim=1)
    s = want.abs().reshape(got.shape[0], -1).amax(dim=1)
    e = (d / s).cpu()
    return {"max": float(e.max()), "median": float(e.median())}


def library_inverse(M):
    inv, info = torch.linalg.inv_ex(M)
    return torch.where((info != 0)[:, None, None], float("nan"), inv)


def library_solve(M, rhs):
    x, info = torch.linalg.solve_ex(M, rhs[:, :, None])
    return torch.where((info != 0)[:, None], float("nan"), x[:, :, 0])


def case(B, m, dev):
    gen = torch.Generator(device=dev).manual_seed(1000 * B + m)
    M = torch.randn((B, m, m), generator=gen, device=dev)
    rhs = torch.randn((B, m), generator=gen, device=dev)
    want_inv = torch.linalg.inv(M.double())
    want_x = torch.linalg.solve(M.double(), rhs.double()[:, :, None])[..., 0]
    inv = lu_kernel.inverse(M)
    x = lu_kernel.solve(M, rhs)
    torch.cuda.synchronize()
    plain_b = min(B, 64)
    plain_inv = lu_kernel._plain(M[:plain_b])
    plain_x = lu_kernel._plain(M[:plain_b], rhs[:plain_b])
    same = (torch.equal(lu_kernel.inverse(M), inv)
            and torch.equal(lu_kernel.solve(M, rhs), x))
    lone = min(3, B - 1)
    alone = (torch.equal(lu_kernel.inverse(M[lone:lone + 1]),
                         inv[lone:lone + 1])
             and torch.equal(lu_kernel.solve(M[lone:lone + 1],
                                             rhs[lone:lone + 1]),
                             x[lone:lone + 1]))
    reps = REPS.get(B, 50)
    flops_inv, flops_solve = 2.0 * B * m ** 3, 2.0 * B * m ** 3 / 3
    bytes_inv, bytes_solve = 8.0 * B * m * m, 4.0 * B * (m * m + 2 * m)
    out = {
        "shape": [B, m, m], "plan": lu_kernel.plan(m),
        "inverse": {
            "kernel": timed(lambda: lu_kernel.inverse(M), reps),
            "library_ms": timed(lambda: library_inverse(M), reps),
            "plain": timed(lambda: lu_kernel._plain(M), 1),
            "bound_ms": 1e3 * max(flops_inv / PEAK_FLOPS, bytes_inv / 3.35e12),
            "err": rel_err(inv, want_inv),
            "err_library": rel_err(library_inverse(M), want_inv),
            "err_plain": rel_err(plain_inv, want_inv[:plain_b]),
        },
        "solve": {
            "kernel": timed(lambda: lu_kernel.solve(M, rhs), reps),
            "library_ms": timed(lambda: library_solve(M, rhs), reps),
            "plain": timed(lambda: lu_kernel._plain(M, rhs), 1),
            "bound_ms": 1e3 * max(flops_solve / PEAK_FLOPS,
                                  bytes_solve / 3.35e12),
            "err": rel_err(x, want_x),
            "err_library": rel_err(library_solve(M, rhs), want_x),
            "err_plain": rel_err(plain_x, want_x[:plain_b]),
        },
        "same_bits_rerun": same, "same_bits_alone": alone,
    }
    for k in ("inverse", "solve"):
        r = out[k]
        r["roofline_pct"] = 100.0 * r["bound_ms"] / r["kernel"]["ms"]
        r["library_over_kernel"] = r["library_ms"]["ms"] / r["kernel"]["ms"]
    return out


def profile_library(dev):
    """What one ``inv_ex`` call at [1024, 256, 256] does on the host and
    the card, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    M = torch.randn((1024, 256, 256), device=dev)
    library_inverse(M)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        library_inverse(M)
        torch.cuda.synchronize()
    host, device = {}, {}
    for e in prof.events():
        kind = str(getattr(e, "device_type", ""))
        table = device if kind.endswith("CUDA") else host
        table[e.name] = table.get(e.name, 0) + 1
    pick = lambda *keys: {k: v for k, v in sorted(host.items())  # noqa: E731
                          if any(s in k for s in keys)}
    return {"phase": "inv_ex_profile", "shape": [1024, 256, 256],
            "device_kernels": sum(device.values()),
            "device_by_name": device,
            "launches": pick("LaunchKernel", "cuLaunch"),
            "alloc": pick("Malloc", "malloc", "Free", "free"),
            "sync": pick("Synchronize", "Memcpy", "memcpy", "EventQuery")}


def main():
    args = sys.argv[1:]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.library()
    emit({"build_s": time.time() - t0,
          "ptxas": _build.build_log.get("batched_lu.cu", "")[-1500:],
          "card": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], capture_output=True,
              text=True).stdout.strip()})
    shapes = DEFAULT_SHAPES
    if "--shapes" in args:
        i = args.index("--shapes")
        shapes = [tuple(int(v) for v in s.split(":")) for s in args[i + 1:]]
    rows = []
    for B, m in shapes:
        rows.append(case(B, m, dev))
        emit(rows[-1])
    if "--profile" in args:
        emit(profile_library(dev))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "time_lu.json"), "w") as f:
        json.dump(rows, f)
    emit({"ok": True, "seconds": time.time() - t0})


if __name__ == "__main__":
    main()
