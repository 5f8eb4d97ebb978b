#!/usr/bin/env python3
"""Where the accuracy of the m = 4096 exact leg goes on the card (a
development aid behind ROADMAP Queue 3's two f32 faults).

Run from the repository root on a machine with a CUDA device:

    python3 tools/diag_m4096.py [lanes m]

On ``device_inequality_lps`` (device seed 0; 4 lanes at m = n = 4096 by
default) it prints one JSON line for each of:

1. ``normal_matrix``: the IPM's normal matrix ``G D G'`` at the tenth
   normal factorization of a solve, formed in f32 on the device, in f32 on
   the host and in float64; the largest error of each f32 product against
   the float64 one, relative to the largest entry;
2. ``exact``: ``solve_batch_exact`` under six settings: the normal product
   and the factorizations in f32 at every size (``factors="f32"``:
   ``engine.F64_PAST`` raised past m), the normal product in float64 past
   2048 and the factorizations in f32 (``"normal_f64"``), or both in
   float64 past 2048 (``"float64"``, the package's setting); and the dual
   phases at blocked-factor shapes with packed or unpacked selection (the
   package's setting: unpacked).  For each: the crossed, retried and
   uncrossed counts, the certified lanes, the statuses, the pivots a lane,
   the float64 count of negative reduced costs at each returned basis, and
   the wall.

Each setting runs once after one warm-up of the package's setting; the
host-side product of step 1 runs on the CPU's threads.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import linprog_tpu_torch as lt  # noqa: E402
import linprog_tpu_torch.engine as le  # noqa: E402
import linprog_tpu_torch.engine_batched as leb  # noqa: E402
import linprog_tpu_torch.ipm as li  # noqa: E402
from linprog_tpu_torch.generators import device_inequality_lps  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def normal_matrix_errors(c, G, h):
    """Step 1: capture ``d`` at the tenth normal factorization of an IPM
    solve and form the product three ways."""
    seen = []
    factor = li._normal_factor

    def capture(op, d, reg):
        seen.append(d)
        return factor(op, d, reg)

    li._normal_factor = capture
    try:
        cs = torch.cat([c, torch.zeros_like(h)], dim=1)
        li.ipm_canonical_state(cs, G, h, li.IPMConfig())
    finally:
        li._normal_factor = factor
    d = seen[min(9, len(seen) - 1)][:, : G.shape[2]]
    exact = torch.matmul(G.double() * d.double()[:, None, :],
                         G.double().transpose(1, 2))
    scale = exact.abs().amax(dim=(1, 2))

    def err(M):
        return ((M.double().to(exact.device) - exact).abs().amax(dim=(1, 2))
                / scale).tolist()

    dev = torch.matmul(G * d[:, None, :], G.transpose(1, 2))
    Gh, dh = G.cpu(), d.cpu()
    host = torch.matmul(Gh * dh[:, None, :], Gh.transpose(1, 2))
    return {"factor": min(10, len(seen)), "k": G.shape[2],
            "rel_err_device_f32": err(dev), "rel_err_host_f32": err(host)}


def negative_reduced_costs(c, G, h, basis):
    """float64 count of reduced costs below -1e-5 of the lane's cost scale
    at each basis of ``[G | I]``."""
    B, m, n = G.shape
    A = torch.cat([G, torch.eye(m, device=G.device).expand(B, m, m)],
                  dim=2).double()
    cs = torch.cat([c, torch.zeros_like(h)], dim=1).double()
    idx = basis.long().clamp(0, n + m - 1)
    Bm = torch.gather(A, 2, idx[:, None, :].expand(B, m, m))
    cB = torch.gather(cs, 1, idx)
    y, info = torch.linalg.solve_ex(Bm.transpose(1, 2), cB[:, :, None])
    rc = cs - torch.einsum("bm,bmn->bn", y[:, :, 0], A)
    scale = 1.0 + c.abs().amax(dim=1).double()
    bad = (rc < -1e-5 * scale[:, None]).sum(dim=1)
    return torch.where(info == 0, bad, -1).tolist()


def exact_runs(c, G, h):
    """Step 2: the exact pipeline under the six settings."""
    f64_past, stream, wide = le.F64_PAST, leb.run_batched_stream, le._wide

    def packed_dual(c_, A, b, state, allowed, maxiters, cfg, mode="primal",
                    **kw):
        if mode == "dual":
            cfg = cfg.replace(packed_select=True)
        return stream(c_, A, b, state, allowed, maxiters, cfg, mode, **kw)

    lt.solve_batch_exact(c, G, h)  # warm-up
    for factors in ("f32", "normal_f64", "float64"):
        for dual in ("packed", "unpacked"):
            le.F64_PAST = 1 << 30 if factors == "f32" else f64_past
            if factors == "normal_f64":
                le._wide = lambda M: M  # the inverses and solves stay f32
            leb.run_batched_stream = packed_dual if dual == "packed" else stream
            try:
                torch.cuda.synchronize()
                t0 = time.time()
                res, info = lt.solve_batch_exact(c, G, h)
                torch.cuda.synchronize()
                wall = time.time() - t0
            finally:
                le.F64_PAST, leb.run_batched_stream = f64_past, stream
                le._wide = wide
            cert = lt.certify_vertex_batch(c, G, h, res.basis)
            emit({"step": "exact", "factors": factors, "dual": dual,
                  **info, "certified": cert["certified"].tolist(),
                  "status": res.status.tolist(), "iters": res.iters.tolist(),
                  "negative_reduced_costs":
                      negative_reduced_costs(c, G, h, res.basis),
                  "wall_s": wall})


def main():
    if not torch.cuda.is_available():
        sys.exit("diag_m4096.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lanes, m = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (4, 4096)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    c, G, h = device_inequality_lps(gen, lanes, m, m, "cuda")
    emit({"step": "normal_matrix", "lanes": lanes, "m": m,
          **normal_matrix_errors(c, G, h)})
    exact_runs(c, G, h)


if __name__ == "__main__":
    main()
