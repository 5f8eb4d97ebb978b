"""The NumPy pivot-path oracle (counterpart of :mod:`linprog_tpu.oracle`)."""

from .reference_impl import OracleSimplex, oracle_solve

__all__ = ["OracleSimplex", "oracle_solve"]
