#!/usr/bin/env python3
"""Time the double-word kernel (``ops/dd_kernel.py``) against refine.py's
plain eager chain on a CUDA card, at the shapes the benchmark's cells send.

Run from the repository root:

    python3 tools/time_dd.py

For each case: the kernel's and the plain version's ms a call (CUDA events
around 50 and 10 calls back to back after a warm-up, 3 times each: the
median and the range of the 3), the same bits or not, and the
kernel's bound: M, y, bvec read once and the output written once at
3.35 TB/s, or its f32 operations at 33.5 T a second (none is an FMA, so
the 67 TFLOP/s peak counts each as half of one), whichever is larger.
Every result is one JSON line.
"""

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lpbench.roofline import power_limit  # noqa: E402
from linprog_tpu_torch import refine  # noqa: E402
from linprog_tpu_torch.ops import dd_kernel  # noqa: E402

BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
# (lanes, rows, columns, M as the transposed view, with bvec)
CASES = [(1024, 256, 256, False, True), (1024, 256, 256, True, True),
         (1024, 512, 256, True, True), (32, 1024, 1024, False, True),
         (32, 1024, 1024, True, True), (1024, 256, 256, False, False)]


def plain(bvec, y, M):
    s, e = refine._dd_chunk_products(y, M, 8)
    parts = [s, e] if bvec is None else [bvec[:, None, :], -s, -e]
    return refine._kahan_sum_chunks(torch.cat(parts, dim=1))


def ms_per_call(fn, n, reps=3):
    """ms a call of ``fn`` over ``n`` calls back to back, ``reps`` times:
    (median, [least, most])."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / n)
    return statistics.median(times), [min(times), max(times)]


def timings(kernel, plain, b_ms):
    """The kernel's and the plain version's times, the speedup of the
    medians and the share of the bound the kernel reaches."""
    k_ms, k_range = ms_per_call(kernel, 50)
    p_ms, p_range = ms_per_call(plain, 10)
    return {"kernel_ms": k_ms, "kernel_ms_range": k_range,
            "plain_ms": p_ms, "plain_ms_range": p_range,
            "speedup": p_ms / k_ms, "bound_ms": b_ms,
            "roofline_pct": 100.0 * b_ms / k_ms}


def bound_ms(B, m, n):
    K = -(-m // 8)
    nbytes = 4 * (B * m * n + B * m + 2 * B * n)
    ops = 21 * B * (8 * K) * n + 7 * B * n * (2 * K + 1)
    return 1e3 * max(nbytes / BYTES_PER_S, ops / OPS_PER_S), (
        "bytes" if nbytes / BYTES_PER_S >= ops / OPS_PER_S else "operations")


def main():
    if not torch.cuda.is_available():
        sys.exit("time_dd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    info = {"card": torch.cuda.get_device_name(0),
            "power_limit": power_limit()}
    for B, m, n, transposed, residual in CASES:
        gen = torch.Generator(device=dev).manual_seed(B + m + n)
        y = torch.randn((B, m), generator=gen, device=dev)
        M = (torch.randn((B, n, m), generator=gen, device=dev).transpose(1, 2)
             if transposed else
             torch.randn((B, m, n), generator=gen, device=dev))
        bvec = torch.einsum("bm,bmn->bn", y, M) if residual else None
        def kernel():
            return dd_kernel.chunk_products_sum(bvec, y, M)

        same = torch.equal(kernel().view(torch.int32),
                           plain(bvec, y, M).view(torch.int32))
        b_ms, bound_by = bound_ms(B, m, n)
        print(json.dumps({
            "shape": [B, m, n], "transposed_view": transposed,
            "residual": residual, **info, "same_bits": bool(same),
            **timings(kernel, lambda: plain(bvec, y, M), b_ms),
            "bound_by": bound_by}), flush=True)
    # the sum-only entry point at the pricing shape: P[1024, 32, 768]
    P = torch.randn((1024, 32, 768), device=dev)
    same = torch.equal(dd_kernel.kahan_sum(P).view(torch.int32),
                       refine._kahan_sum_chunks(P).view(torch.int32))
    b_ms = 1e3 * 4 * (P.numel() + 1024 * 768) / BYTES_PER_S
    print(json.dumps({"shape": list(P.shape), "sum_only": True, **info,
                      "same_bits": bool(same),
                      **timings(lambda: dd_kernel.kahan_sum(P),
                                lambda: refine._kahan_sum_chunks(P), b_ms),
                      "bound_by": "bytes"}), flush=True)


if __name__ == "__main__":
    main()
