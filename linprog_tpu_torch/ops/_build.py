"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/*.cu`` file compiles to an object in its own ``nvcc``
process, all started together; the objects link into ONE shared library
with a plain C interface, loaded with :mod:`ctypes`.  The library goes to
``build/linprog_tpu_torch/<hash>/`` beside the package, keyed by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads at once.  A build failure raises with nvcc's own message; ptxas's
report of each kernel's registers, shared memory and spills is kept in
:data:`build_log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build",
                           "linprog_tpu_torch")

# --fmad=false: every a*b + c rounds twice, as the plain PyTorch versions
# (separate eager ops) do, so a kernel and its plain version differ only by
# summation order.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
build_seconds = None  # wall time of the last build in this process
build_log = {}  # source name -> nvcc's stderr (ptxas -v) of the last build


class KernelBuildError(RuntimeError):
    pass


def _sources():
    names = sorted(f for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh")))
    return [os.path.join(_CSRC, f) for f in names]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "cannot be built"
        )
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16],
                        "liblinprog_kernels.so")


def _run(cmds):
    """Run the commands in parallel; raise with the first failure's output.
    Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{out}\n{err}"
            )
    return [err for _, err in outs]


def build() -> str:
    """Compile the library if it is not built yet; return its path."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cu]
        logs = _run([[nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", "-o", o, p]
                     for p, o in zip(cu, objs)])
        lib = os.path.join(tmp, "lib.so")
        _run([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: concurrent builders never see half a file
    build_log.clear()
    build_log.update({os.path.basename(p): log for p, log in zip(cu, logs)})
    build_seconds = time.time() - t0
    return out


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lp_panel_cholinv.argtypes = [p, p, i, i, p]
    lib.lp_panel_cholinv.restype = i
    tail = [
        i, i, i, i, i,  # B, m, n, seg_len, maxiters
        f, f, f,  # opt_tol, pivot_tol, feas_tol
        i, i, i, i,  # dual, pricing, packed, stall_limit
        p,  # stream
    ]
    # kernel 1: A, c, apen, invBT, bfs, cB, basis, pen, gamma, iters,
    # status; then split and ablate, and the plan before the stream. The
    # cluster-resident branch: the unit layout's rows, values and n_d, then
    # cluster, aligned, smem_bytes
    lib.lp_solve_segment_cluster.argtypes = ([p] * 11 + tail[:-1] + [i, i]
                                             + [p, p, i] + [i] * 3 + [p])
    lib.lp_solve_segment_cluster.restype = i
    lib.lp_solve_segment_cluster_max_clusters.argtypes = [i, i]  # cluster, smem
    lib.lp_solve_segment_cluster_max_clusters.restype = i
    # the streaming branch: cluster, aligned, stages, stage_floats,
    # warp_stages, chunk_floats, smem_bytes
    lib.lp_solve_segment_large.argtypes = ([p] * 11 + tail[:-1] + [i, i]
                                           + [i] * 7 + [p])
    lib.lp_solve_segment_large.restype = i
    # cluster, aligned, smem_bytes
    lib.lp_solve_segment_large_max_clusters.argtypes = [i, i, i]
    lib.lp_solve_segment_large_max_clusters.restype = i
    # the same without gamma (the streaming kernel has no devex), then
    # partial and n_blk (sectional pricing), and the launch plan before the
    # stream: cluster, aligned, stages, stage_floats, warp_stages,
    # chunk_floats, smem_bytes
    lib.lp_solve_segment_stream.argtypes = ([p] * 10 + tail[:-1] + [i, i]
                                            + [i] * 7 + [p])
    lib.lp_solve_segment_stream.restype = i
    bounded = [
        p, p, p, p,  # A, c, lb, ub
        p, p, p, p, p, p, p, p, p,  # invBT, bfs, cB, basis, vstate, lbB,
        # ubB, iters, status
        i, i, i, i, i,  # B, m, n, seg_len, maxiters
        f, f,  # opt_tol, pivot_tol
        i,  # packed
    ]
    # kernel 4's two branches: the plan, then the stream. Cluster-resident:
    # cluster, aligned, smem_bytes; streaming: cluster, aligned, stages,
    # stage_floats, warp_stages, chunk_floats, smem_bytes
    lib.lp_solve_bounded_cluster.argtypes = bounded + [i] * 3 + [p]
    lib.lp_solve_bounded_cluster.restype = i
    lib.lp_solve_bounded_cluster_max_clusters.argtypes = [i, i]
    lib.lp_solve_bounded_cluster_max_clusters.restype = i
    lib.lp_solve_bounded_stream.argtypes = bounded + [i] * 7 + [p]
    lib.lp_solve_bounded_stream.restype = i
    # cluster, aligned, smem_bytes
    lib.lp_solve_bounded_stream_max_clusters.argtypes = [i, i, i]
    lib.lp_solve_bounded_stream_max_clusters.restype = i
    lib.lp_price_entering.argtypes = [
        p, p, p, p, p,  # cB, invB, A, c, penalty
        p, p,  # enter, eligible
        i, i, i, i, f,  # B, m, n, dantzig, opt_tol
        p,  # stream
    ]
    lib.lp_price_entering.restype = i
    lib.lp_ratio_eta_pivot.argtypes = [
        p, p, p, p,  # invB, bfs, acol, go
        p, p,  # leave, unbounded
        i, i, f,  # B, m, pivot_tol
        p,  # stream
    ]
    lib.lp_ratio_eta_pivot.restype = i
    # cluster, aligned, smem_bytes
    lib.lp_solve_segment_stream_max_clusters.argtypes = [i, i, i]
    lib.lp_solve_segment_stream_max_clusters.restype = i
    q = ctypes.c_longlong
    # bvec and its strides (b, j), y (b, i), M (b, i, j), out, scratch;
    # B, m, n, chunk; stream
    lib.lp_dd_rowmat.argtypes = [p, q, q, p, q, q, p, q, q, q, p, p,
                                 i, i, i, i, p]
    lib.lp_dd_rowmat.restype = i
    # B, m, n, chunk -> scratch floats (or a negative error code)
    lib.lp_dd_rowmat_scratch_floats.argtypes = [i, i, i, i]
    lib.lp_dd_rowmat_scratch_floats.restype = q
    # P and its strides (b, k, j), out; B, K, n; stream
    lib.lp_dd_kahan_sum.argtypes = [p, q, q, q, p, i, i, i, p]
    lib.lp_dd_kahan_sum.restype = i
    # M and its strides (b, i, j), rhs (null: the inverse) and its strides
    # (b, i), out; B, m; stream
    lib.lp_batched_lu.argtypes = [p, q, q, q, p, q, q, p, i, i, p]
    lib.lp_batched_lu.restype = i
    # m -> CTAs a lane, shared-memory bytes a CTA
    lib.lp_batched_lu_plan.argtypes = [i, p, p]
    lib.lp_batched_lu_plan.restype = i
    lib.lp_error_string.argtypes = [i]
    lib.lp_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        _declare(lib)
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = library().lp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
