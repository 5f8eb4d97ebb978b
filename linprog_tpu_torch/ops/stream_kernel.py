"""Whole-segment simplex kernel for large m: the counterpart of the Pallas
kernel ``linprog_tpu/ops/stream_kernel.py :: solve_segment_stream`` (body
``_stream_kernel``, helper ``_factor_rb``).

The TPU kernel exists because one lane's factor and A stop fitting in
VMEM: it DMAs ``B^-T`` into scratch, keeps Aᵀ resident or streams it in
``(n_blk, m)`` row blocks, and at the top of its range reads the factor in
``(RB, m)`` row slices.  Its iteration math is the one of
:mod:`linprog_tpu_torch.ops.solve_kernel`, minus devex, so the plain
version here reuses :func:`~linprog_tpu_torch.ops.solve_kernel
.solve_segment_plain`.  The one difference it reproduces is the
blocked-factor mode's summation order for the direction ``d = B^-1 a``.
``a_resident`` and ``n_blk`` choose VMEM choreography only: both versions
accept them and ignore them.  The port takes ``A[B, m, n]``, not the
reference's Aᵀ (which suits the TPU's sublane slices; on the card a copy
of Aᵀ would cost ``m n`` floats per lane).

On the H100 (``csrc/solve_segment_stream.cu``): one cluster of 8 thread
blocks per lane.  The blocks split the lane's columns of A and rows of
``B^-T``, and combine selections and vectors through distributed shared
memory, so a few large lanes still keep enough loads in flight and the
lane's vectors fit in shared memory up to m = 4096 and past it.  Each
primal pivot reads A once and ``B^-T`` four times (about 96 MiB per
lane-pivot at m = 2048, n = 4096): the kernel is bound by device-memory
bandwidth.
"""

from __future__ import annotations

import torch

from . import _build
from .solve_kernel import SegmentState, check_segment_args, solve_segment_plain

launches = 0  # CUDA launches of the kernel (never the plain version)

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use


def _factor_rb(m: int) -> int:
    """Row-block size of the blocked-factor mode (divides m)."""
    if m >= 4096 and m % 256 == 0:
        return 256
    if m >= 2048 and m % 512 == 0:
        return 512
    for rb in (8, 4, 2):
        if m % rb == 0 and rb < m:
            return rb
    return m


def _check_mode(pricing: int, dual: bool, factor_blocked: bool) -> None:
    if pricing not in (0, 1):
        raise ValueError(
            "solve_segment_stream: pricing must be bland (0) or dantzig (1); "
            "devex is not offered on the streaming kernel (its weight "
            "update would need a second pass over A)"
        )
    if factor_blocked and dual:
        raise ValueError("solve_segment_stream: the blocked-factor mode is "
                         "primal only")


def solve_segment_stream_plain(A, c, apen, maxiters: int,
                               state: SegmentState, *, seg_len: int,
                               pricing: int, opt_tol: float,
                               pivot_tol: float, dual: bool = False,
                               feas_tol: float = 1e-6, stall_limit: int = 0,
                               packed: bool = False, a_resident: bool = True,
                               n_blk: int = 256,
                               factor_blocked: bool = False) -> SegmentState:
    """The plain PyTorch version; updates ``state`` in place and returns
    it."""
    del a_resident, n_blk
    _check_mode(pricing, dual, factor_blocked)
    m = A.shape[1]
    return solve_segment_plain(
        A, c, apen, maxiters, state, seg_len=seg_len, pricing=pricing,
        opt_tol=opt_tol, pivot_tol=pivot_tol, dual=dual, feas_tol=feas_tol,
        stall_limit=stall_limit, packed=packed,
        factor_rb=_factor_rb(m) if factor_blocked else 0,
    )


def solve_segment_stream(A, c, apen, maxiters: int, state: SegmentState, *,
                         seg_len: int, pricing: int, opt_tol: float,
                         pivot_tol: float, dual: bool = False,
                         feas_tol: float = 1e-6, stall_limit: int = 0,
                         packed: bool = False, a_resident: bool = True,
                         n_blk: int = 256,
                         factor_blocked: bool = False) -> SegmentState:
    """Run up to ``seg_len`` simplex iterations per lane; updates ``state``
    in place and returns it.

    Arguments as :func:`linprog_tpu_torch.ops.solve_kernel.solve_segment`
    (``pricing`` 0 = bland, 1 = dantzig; devex raises ``ValueError``), plus
    the reference's mode switches: ``a_resident`` and ``n_blk`` are
    accepted and ignored, ``factor_blocked`` (primal only) sums the
    direction over row blocks of the factor in the plain version.  A CPU
    tensor takes the plain version; a CUDA tensor launches the cluster
    kernel, or raises for a lane too large for its shared memory.
    """
    global launches
    check_segment_args(A, c, apen, state, "solve_segment_stream")
    kw = dict(seg_len=seg_len, pricing=pricing, opt_tol=opt_tol,
              pivot_tol=pivot_tol, dual=dual, feas_tol=feas_tol,
              stall_limit=stall_limit, packed=packed,
              factor_blocked=factor_blocked)
    if A.device.type == "cpu":
        return solve_segment_stream_plain(A, c, apen, maxiters, state, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"solve_segment_stream: unsupported device {A.device}")
    _check_mode(pricing, dual, factor_blocked)
    B, m, n = A.shape
    lib = _build.library()
    need = lib.lp_solve_segment_stream_smem(m, n)
    if need > _SMEM_LIMIT - 1024:
        raise ValueError(
            f"solve_segment_stream: a lane of m={m}, n={n} needs {need} bytes "
            f"of shared memory per block, past the {_SMEM_LIMIT} a block of "
            "the card may hold"
        )
    if B == 0 or seg_len <= 0:
        return state
    stream = torch.cuda.current_stream(A.device).cuda_stream
    code = lib.lp_solve_segment_stream(
        A.data_ptr(), c.data_ptr(), apen.data_ptr(),
        state.invBT.data_ptr(), state.bfs.data_ptr(), state.cB.data_ptr(),
        state.basis.data_ptr(), state.pen.data_ptr(),
        state.iters.data_ptr(), state.status.data_ptr(),
        B, m, n, min(int(seg_len), 0x7FFFFFFF), int(maxiters),
        float(opt_tol), float(pivot_tol), float(feas_tol),
        int(bool(dual)), int(pricing), int(bool(packed)), int(stall_limit),
        stream,
    )
    _build.check(code, "solve_segment_stream launch")
    launches += 1
    return state
