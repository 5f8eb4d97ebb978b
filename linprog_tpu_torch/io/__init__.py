"""MPS input and output (counterpart of :mod:`linprog_tpu.io`)."""

from .mps import MPSProblem, mps_to_solver_inputs, read_mps
from .write_mps import write_mps

__all__ = ["read_mps", "MPSProblem", "mps_to_solver_inputs", "write_mps"]
