"""ctypes bindings for the native MPS reader (the port's copy of
:mod:`linprog_tpu.io.mps`).

The reader's C++ source is the repository's ``native/mps_reader.cpp``.  At
first use ``g++`` builds it into ``build/linprog_tpu_torch/<hash>/``
beside the package, keyed by a hash of the source and flags (as the CUDA
kernels are, :mod:`linprog_tpu_torch.ops._build`), under a temporary name
that is then renamed into place: processes that build at once never load
half a file, and the JAX package's own build in ``native/`` is left alone.
``read_mps`` returns an :class:`MPSProblem`; ``mps_to_solver_inputs``
converts it to the ``SimplexSolver``/batched canonical inputs
``(c, A, b, G, h, lb, ub)``:

* ``E`` rows -> equality block ``(A, b)``;
* ``L`` rows -> inequality block ``(G, h)``;
* ``G`` rows -> negated into the ``L`` block;
* ``RANGES`` -> an extra ``L`` row per ranged constraint;
* ``OBJSENSE MAX`` -> cost negated (solver minimizes).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "mps_reader.cpp"
_BUILD_ROOT = _REPO / "build" / "linprog_tpu_torch"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
_lib = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libmps_reader.so"


def _build_library(out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build_library(path)
    lib = ctypes.CDLL(str(path))
    lib.mps_open.restype = ctypes.c_void_p
    lib.mps_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.mps_num_rows.argtypes = [ctypes.c_void_p]
    lib.mps_num_cols.argtypes = [ctypes.c_void_p]
    lib.mps_num_entries.argtypes = [ctypes.c_void_p]
    lib.mps_num_integer_markers.argtypes = [ctypes.c_void_p]
    lib.mps_is_maximize.argtypes = [ctypes.c_void_p]
    lib.mps_problem_name.argtypes = [ctypes.c_void_p]
    lib.mps_problem_name.restype = ctypes.c_char_p
    dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.mps_get_structure.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, dptr, dptr, dptr, dptr, dptr,
    ]
    lib.mps_get_entries.argtypes = [ctypes.c_void_p, iptr, iptr, dptr]
    lib.mps_row_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.mps_col_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.mps_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


@dataclasses.dataclass
class MPSProblem:
    """Parsed MPS model (dense constraint matrix)."""

    name: str
    maximize: bool
    row_types: np.ndarray  # '<U1'[m] in {'L','G','E'}
    A: np.ndarray  # [m, n] dense constraint matrix
    rhs: np.ndarray  # [m]
    ranges: np.ndarray  # [m], NaN where unset
    c: np.ndarray  # [n]
    lb: np.ndarray  # [n]
    ub: np.ndarray  # [n]
    row_names: List[str]
    col_names: List[str]
    n_integer_sections: int = 0  # 'MARKER' INTORG sections seen (LP relax)


def read_mps(path: str) -> MPSProblem:
    """Parse an MPS file via the native reader."""
    lib = _load()
    errbuf = ctypes.create_string_buffer(512)
    handle = lib.mps_open(str(path).encode(), errbuf, len(errbuf))
    if not handle:
        raise ValueError(f"MPS parse error: {errbuf.value.decode()}")
    try:
        m = lib.mps_num_rows(handle)
        n = lib.mps_num_cols(handle)
        nnz = lib.mps_num_entries(handle)
        row_types_buf = ctypes.create_string_buffer(max(m, 1))
        rhs = np.zeros(m)
        ranges = np.zeros(m)
        c = np.zeros(n)
        lb = np.zeros(n)
        ub = np.zeros(n)
        lib.mps_get_structure(handle, row_types_buf, rhs, ranges, c, lb, ub)
        rows = np.zeros(nnz, np.int32)
        cols = np.zeros(nnz, np.int32)
        vals = np.zeros(nnz)
        lib.mps_get_entries(handle, rows, cols, vals)
        A = np.zeros((m, n))
        A[rows, cols] = vals
        namebuf = ctypes.create_string_buffer(256)

        def _name(fn, i):
            fn(handle, i, namebuf, len(namebuf))
            return namebuf.value.decode()

        row_names = [_name(lib.mps_row_name, i) for i in range(m)]
        col_names = [_name(lib.mps_col_name, i) for i in range(n)]
        n_int = lib.mps_num_integer_markers(handle)
        if n_int:
            import warnings

            warnings.warn(
                f"{path}: {n_int} integrality marker section(s) present; "
                "integrality is IGNORED -- this solves the LP relaxation",
                stacklevel=2,
            )
        return MPSProblem(
            name=lib.mps_problem_name(handle).decode(),
            maximize=bool(lib.mps_is_maximize(handle)),
            row_types=np.frombuffer(
                row_types_buf.raw[:m], dtype="S1"
            ).astype("U1"),
            A=A,
            rhs=rhs,
            ranges=ranges,
            c=c,
            lb=lb,
            ub=ub,
            row_names=row_names,
            col_names=col_names,
            n_integer_sections=n_int,
        )
    finally:
        lib.mps_close(handle)


def mps_to_solver_inputs(
    prob: MPSProblem,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
           Optional[np.ndarray], Optional[np.ndarray], np.ndarray, np.ndarray]:
    """Convert to ``SimplexSolver`` inputs ``(c, A, b, G, h, lb, ub)``."""
    c = -prob.c if prob.maximize else prob.c.copy()
    ranged = ~np.isnan(prob.ranges)
    # a ranged E row is NOT an equality: it becomes a two-sided interval
    # (standard MPS semantics below), so exclude it from the equality block
    eq = (prob.row_types == "E") & ~ranged
    le = prob.row_types == "L"
    ge = prob.row_types == "G"

    A_eq = prob.A[eq] if eq.any() else None
    b_eq = prob.rhs[eq] if eq.any() else None

    G_rows = []
    h_vals = []
    if le.any():
        G_rows.append(prob.A[le])
        h_vals.append(prob.rhs[le])
    if ge.any():
        G_rows.append(-prob.A[ge])
        h_vals.append(-prob.rhs[ge])
    # RANGES: row with range r gets a second-side constraint.
    for i in np.flatnonzero(ranged):
        t = prob.row_types[i]
        r = abs(prob.ranges[i])
        if t == "L":  # rhs - r <= a'x <= rhs
            G_rows.append(-prob.A[i][None, :])
            h_vals.append(np.array([-(prob.rhs[i] - r)]))
        elif t == "G":  # rhs <= a'x <= rhs + r
            G_rows.append(prob.A[i][None, :])
            h_vals.append(np.array([prob.rhs[i] + r]))
        elif t == "E":
            # sign(range) semantics: r > 0 -> rhs <= a'x <= rhs + |r|;
            # r < 0 -> rhs - |r| <= a'x <= rhs (both sides as G rows,
            # replacing the equality excluded above)
            if prob.ranges[i] >= 0:
                lo, hi = prob.rhs[i], prob.rhs[i] + r
            else:
                lo, hi = prob.rhs[i] - r, prob.rhs[i]
            G_rows.append(prob.A[i][None, :])
            h_vals.append(np.array([hi]))
            G_rows.append(-prob.A[i][None, :])
            h_vals.append(np.array([-lo]))
    G = np.concatenate(G_rows, axis=0) if G_rows else None
    h = np.concatenate(h_vals) if h_vals else None
    return c, A_eq, b_eq, G, h, prob.lb.copy(), prob.ub.copy()
