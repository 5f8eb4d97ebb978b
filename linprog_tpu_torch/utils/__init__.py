"""Numeric utilities (counterpart of :mod:`linprog_tpu.utils`)."""

from .math import dual_simplex_div, get_bounds_on_bfs, primal_simplex_div

__all__ = [
    "primal_simplex_div",
    "dual_simplex_div",
    "get_bounds_on_bfs",
]
