"""The least time of a launch of a streaming segment kernel: kernel 1's
streaming branch (``csrc/solve_segment_large.cu``) and kernel 3
(``csrc/solve_segment_stream.cu``).

A streaming kernel keeps no part of a lane on chip between iterations:
every iteration of every lane moves A's ``m n`` entries once (the pricing
pass; in dual mode one pass gives both ``y A`` and the dual row) and the
transposed factor's ``m^2`` entries three times (the direction reads it,
the eta pass reads and writes it), as both sources' headers count them.
``lpbench/roofline.py :: launch_bound_s`` counts A read once a launch,
which suits a cluster that holds its lane in shared memory; here the
bytes are a pivot's.  A launch's least time is its pivots times the
larger of a pivot's bytes at the memory rate and its operations
(``pivot_flops``) at the f32 rate.  Not counted: a launch's first
iteration reads the factor once more (the standalone duals), and a lane's
last pricing pass finds no entering column and makes no pivot; so the
bound is low, never high.
"""

from __future__ import annotations

from .roofline import F32_FLOPS_PER_S, HBM_BYTES_PER_S, pivot_flops

FACTOR_PASSES = 3  # the direction's read, the eta pass's read and write


def pivot_bytes(m: int, n: int) -> int:
    """f32 bytes one pivot of one lane moves: A once, the factor three
    times."""
    return 4 * (m * n + FACTOR_PASSES * m * m)


def pivot_s(m: int, n: int) -> float:
    """The least seconds of one pivot of one lane."""
    return max(pivot_bytes(m, n) / HBM_BYTES_PER_S,
               pivot_flops(m, n) / F32_FLOPS_PER_S)


def launch_bound_s(m: int, n: int, pivots: float) -> float:
    """The least seconds of a launch that did ``pivots`` pivots in all (over
    its lanes) on lanes of ``m`` rows and ``n`` columns."""
    return pivots * pivot_s(m, n)
