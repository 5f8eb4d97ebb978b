"""Regime-boundary lookup (the lookup half of :mod:`linprog_tpu.calibration`).

The table below is the reference package's packaged ``"default"`` entry.
Those numbers were measured on a TPU v5e, not on an H100: they serve here
as parity constants so the port routes and segments exactly like the
reference, until a calibration on the H100 replaces them.
"""

from __future__ import annotations

# v5e values (the reference's data/calibration.json "default" entry)
_DEFAULT_TABLE = {
    "exact_simplex_max_m": 192,
    "moderate_simplex_max_m": 192,
    "pdhg_min_m": 4096,
    "exact_eps": 1e-05,
    "xover_pallas_max_m": 512,
    # rows [hi, seg]: refactor segment `seg` for m <= hi; hi == 0 is the rest
    "seg_by_m": [[384, 512], [768, 768], [1536, 1024], [0, 2048]],
}


def get_table() -> dict:
    """A fresh copy of the threshold table."""
    out = dict(_DEFAULT_TABLE)
    out["seg_by_m"] = [list(r) for r in _DEFAULT_TABLE["seg_by_m"]]
    return out


def seg_for_m(m: int) -> int:
    """Refactor-segment length for problem size ``m``."""
    for hi, seg in _DEFAULT_TABLE["seg_by_m"]:
        if hi == 0 or m <= hi:
            return int(seg)
    raise AssertionError("seg_by_m has no terminal row")
