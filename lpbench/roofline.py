"""Peaks of the card and the least time a segment launch could take.

The arithmetic is a copy of ``chip_smoke.py :: bound_ms`` and
``launch_bound_ms``, extended to the pivots a launch actually did: each
input byte read once and each output byte written once at the
device-memory rate, or the operations at the f32 rate, whichever is
larger.  Peaks are NVIDIA's published H100 SXM figures (dense, no
sparsity, at the 700 W limit); the run prints the card's own power limit
beside every share (:func:`power_limit`).
"""

from __future__ import annotations

import shutil
import subprocess

F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores (TF32 is off)
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least seconds: bytes at the memory rate or operations at the
    f32 rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S)


def pivot_flops(m: int, n: int) -> int:
    """Operations of one revised-simplex pivot with an explicit factor:
    pricing ``y'A`` (2mn), the duals ``c_B' B^-1``, the direction
    ``B^-1 a`` and the rank-1 eta update of ``B^-1`` (2m^2 each)."""
    return 2 * m * n + 6 * m * m


def segment_launch_bytes(lanes: int, m: int, n: int) -> int:
    """One whole-segment launch over ``lanes`` lanes, f32: A read once, the
    factor read and written once, the O(m + n) rows (costs, bounds or
    penalties, the basis, the basic values) read and written once."""
    return 4 * lanes * (m * n + 2 * m * m + 2 * (5 * m + 3 * n))


def launch_bound_s(lanes: int, m: int, n: int, pivots: int) -> float:
    """The least seconds of a launch that did ``pivots`` pivots in all over
    ``lanes`` running lanes."""
    return bound_s(segment_launch_bytes(lanes, m, n),
                   pivots * pivot_flops(m, n))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``"not read"``."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not read"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"
