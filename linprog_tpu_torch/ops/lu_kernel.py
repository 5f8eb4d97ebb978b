"""The batched inverse and solve of float32 lanes up to ``m = 256`` in one
launch a call (``csrc/batched_lu.cu``).

Replaces no TPU kernel: the JAX package leaves ``jnp.linalg.inv`` to XLA.
:func:`engine.inv_or_nan` and :func:`engine.solve_or_nan` send float32
CUDA tensors whose ``m`` it takes (:func:`takes`) here; every other tensor
keeps ``torch.linalg``.

* :func:`inverse` -- ``M[B, m, m]`` -> ``M^-1``.
* :func:`solve` -- ``M[B, m, m], rhs[B, m]`` -> ``M^-1 rhs``, no inverse
  formed.

Both factor with partial pivoting (at step k the row of largest ``|a|``
in column k among the rows not yet pivoted, the lowest logical row --
LAPACK's order after its interchanges -- on a tie, so the pivots are
``getrf``'s), then run the two triangular solves: the forward elimination
carries the transform ``T`` (``T M = U``, U with a unit diagonal) or the
right-hand side, the back substitution forms ``U^-1 T`` or ``U^-1 T rhs``.
A lane whose pivot is 0 or not finite comes back all NaN (what a nonzero
LAPACK ``info`` gave the callers); a NaN entry fails the lane or spreads,
so non-finite input stays non-finite.  The plain version below runs the
same elimination one column at a time in torch ops; CPU tensors handed to
the wrapper take it.

Each launch is counted in :data:`launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_M = 256  # the largest m the kernel takes
launches = 0  # CUDA launches of either entry point


def takes(device_type: str, dtype, m: int) -> bool:
    """Whether the kernel serves a factorization of this kind: float32 on
    a CUDA device with ``1 <= m <= MAX_M``.  CPU tensors, float64 and
    larger m keep ``torch.linalg``."""
    return device_type == "cuda" and dtype == torch.float32 and \
        1 <= m <= MAX_M


def plan(m: int) -> dict:
    """The kernel's launch plan at this m: CTAs a lane (``cluster``) and
    shared-memory bytes a CTA (``smem_bytes``)."""
    lib = _build.library()
    cl, smem = ctypes.c_int(), ctypes.c_longlong()
    _build.check(lib.lp_batched_lu_plan(m, ctypes.byref(cl),
                                        ctypes.byref(smem)),
                 "batched LU plan")
    return {"cluster": cl.value, "smem_bytes": smem.value}


def _check(M, rhs=None):
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"batched LU: M must be [B, m, m], got "
                         f"{tuple(M.shape)}")
    B, m, _ = M.shape
    if rhs is not None and tuple(rhs.shape) != (B, m):
        raise ValueError(f"batched LU: rhs must be [{B}, {m}], got "
                         f"{tuple(rhs.shape)}")
    if M.device.type == "cpu":
        return False
    if not takes(M.device.type, M.dtype, m):
        raise ValueError(f"batched LU: the kernel takes float32 CUDA lanes "
                         f"of 1 <= m <= {MAX_M}, got {M.dtype} on "
                         f"{M.device} at m = {m}")
    if rhs is not None and (rhs.device != M.device
                            or rhs.dtype != torch.float32):
        raise ValueError(f"batched LU: rhs is {rhs.dtype} on {rhs.device}, "
                         f"expected float32 on {M.device}")
    return True


def _launch(M, rhs, out):
    global launches
    B, m, _ = M.shape
    if B == 0:
        return out
    rp, srb, sri = ((0, 0, 0) if rhs is None
                    else (rhs.data_ptr(), *rhs.stride()))
    code = _build.library().lp_batched_lu(
        M.data_ptr(), *M.stride(), rp, srb, sri, out.data_ptr(), B, m,
        torch.cuda.current_stream(M.device).cuda_stream)
    _build.check(code, "batched LU launch")
    launches += 1
    return out


def inverse(M):
    """``M[B, m, m]`` -> a new ``M^-1``; failed lanes all NaN.  A CUDA
    tensor takes the kernel (float32, ``m <= MAX_M``, any strides), whose
    output is laid out as ``torch.linalg.inv_ex``'s (each matrix
    column-major), so a caller's transposed copy stays free; a CPU tensor
    takes the plain version."""
    if not _check(M):
        return _plain(M)
    B, m, _ = M.shape
    out = torch.empty_strided((B, m, m), (m * m, 1, m), dtype=torch.float32,
                              device=M.device)
    return _launch(M, None, out)


def solve(M, rhs):
    """``M[B, m, m] x = rhs[B, m]`` -> a new contiguous ``x[B, m]``; failed
    lanes all NaN.  A CUDA tensor takes the kernel, a CPU tensor the plain
    version."""
    if not _check(M, rhs):
        return _plain(M, rhs)
    out = torch.empty(rhs.shape, dtype=torch.float32, device=M.device)
    return _launch(M, rhs, out)


def _eliminate(M, rhs=None):
    """The kernel's forward elimination (getf2's steps), one column at a
    time.  Returns ``(S, x, pos, failed)``: the lane's storage (U right of
    and on each pivot, the transform T with ``T M = U`` left of it: T is
    unit lower, its diagonal implicit; for ``rhs`` None), or the swept
    right-hand side ``x``, with rows physical; each row's logical position
    and the failed lanes."""
    B, m, _ = M.shape
    A = M.clone()
    x = None if rhs is None else rhs.clone()
    ar = torch.arange(B, device=M.device)
    rows = torch.arange(m, device=M.device)
    pos = rows.expand(B, m).clone()
    failed = torch.zeros((B,), dtype=torch.bool, device=M.device)
    for k in range(m):
        f = A[:, :, k].clone()
        v = torch.abs(f)
        v = torch.where(torch.isnan(v), torch.inf, v)
        v = torch.where(pos >= k, v, -1.0)
        best = v.max(dim=1).values
        # the largest |a|, then the lowest logical position
        ppos = torch.where(v == best[:, None], pos, m).min(dim=1).values
        p = torch.argmax((pos == ppos[:, None]).int(), dim=1)
        bad = ~(best > 0) | torch.isinf(best)
        failed |= bad
        # the multipliers of the rows below the pivot, by its reciprocal
        rcp = 1.0 / torch.where(bad, 1.0, A[ar, p, k])
        below = (pos >= k) & (rows != p[:, None])
        lk = torch.where(below, f * rcp[:, None], 0.0)
        u = A[ar, p, :]
        if x is None:
            A = torch.where(below[:, :, None],
                            A - lk[:, :, None] * u[:, None, :], A)
            A[:, :, k] = torch.where(below, -lk, A[:, :, k])
        else:
            A[:, :, k + 1:] = torch.where(
                below[:, :, None],
                A[:, :, k + 1:] - lk[:, :, None] * u[:, None, k + 1:],
                A[:, :, k + 1:])
            x = torch.where(below, x - lk * x[ar, p][:, None], x)
        q = torch.argmax((pos == k).int(), dim=1)  # the row at position k
        pos[ar, q] = ppos
        pos[ar, p] = k
    return A, x, pos, failed


def pivot_rows(M):
    """The plain version's pivot row of each step, ``[B, m]``: the row of
    ``M`` that LAPACK's interchanges bring to position k."""
    _, _, pos, _ = _eliminate(M)
    return torch.argsort(pos, dim=1)


def _plain(M, rhs=None):
    """The plain PyTorch version of :func:`inverse` (``rhs`` None) and
    :func:`solve`: the forward elimination, then the back substitution
    ``X = U^-1 T`` (or ``U^-1 x``) by logical rows, bottom up."""
    B, m, _ = M.shape
    S, x, pos, failed = _eliminate(M, rhs)
    row_at = torch.argsort(pos, dim=1)
    # the storage by logical row: U on and right of the diagonal
    L = torch.gather(S, 1, row_at[:, :, None].expand(B, m, m))
    upper = torch.triu(torch.ones((m, m), dtype=torch.bool,
                                  device=M.device), diagonal=1)
    U = torch.where(upper, L, 0.0)
    # a division by a pivot is the product with its reciprocal, as in the
    # forward elimination
    dinv = 1.0 / torch.diagonal(L, dim1=1, dim2=2)
    if rhs is not None:
        y = torch.gather(x, 1, row_at)
        for k in range(m - 1, -1, -1):
            y[:, k] = (y[:, k] - (U[:, k, k + 1:] * y[:, k + 1:]).sum(dim=1)
                       ) * dinv[:, k]
        return torch.where(failed[:, None], torch.nan, y)
    eye = torch.eye(m, dtype=torch.bool, device=M.device)
    X = torch.where(upper, 0.0, torch.where(eye, 1.0, L))  # T, by logical row
    for k in range(m - 1, -1, -1):
        X[:, k] = (X[:, k] - torch.einsum("bj,bjc->bc", U[:, k, k + 1:],
                                          X[:, k + 1:])) * dinv[:, k, None]
    # inverse[k][c] = X[k][pos[c]]
    out = torch.gather(X, 2, pos[:, None, :].expand(B, m, m))
    return torch.where(failed[:, None, None], torch.nan, out)
