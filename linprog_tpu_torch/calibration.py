"""Regime-boundary lookup (the lookup half of :mod:`linprog_tpu.calibration`).

The table below is the reference package's packaged ``"default"`` entry.
Those numbers were measured on a TPU v5e, not on an H100: they serve here
as parity constants so the port routes and segments exactly like the
reference, until a calibration on the H100 replaces them.

:func:`set_table` injects a table of the reference's schema (chip-kind
names and/or ``"default"`` mapped to threshold dicts) until
:func:`reset_table`.  The port has no per-card entries yet, so it reads
only the ``"default"`` entry of an injected table; keys that entry lacks
keep the packaged values.  The injection is plain module state.
"""

from __future__ import annotations

from typing import Optional

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

_override: Optional[dict] = None


def set_table(table: dict) -> None:
    """Use ``table["default"]`` over the packaged values until
    :func:`reset_table`."""
    global _override
    _override = table


def reset_table() -> None:
    """Drop any :func:`set_table` injection."""
    global _override
    _override = None


def get_table() -> dict:
    """A fresh copy of the threshold table."""
    out = dict(_DEFAULT_TABLE)
    if _override is not None:
        out.update(_override.get("default", {}))
    out["seg_by_m"] = [list(r) for r in out["seg_by_m"]]
    return out


def seg_for_m(m: int) -> int:
    """Refactor-segment length for problem size ``m``."""
    for hi, seg in get_table()["seg_by_m"]:
        if hi == 0 or m <= hi:
            return int(seg)
    raise AssertionError("seg_by_m has no terminal row")
