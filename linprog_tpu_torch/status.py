"""Per-lane status codes and the host-side exception taxonomy.

Counterpart of :mod:`linprog_tpu.status`.  The batched solvers compute a
status code per lane; a host wrapper re-raises the matching exception for
API parity with the single-problem reference library.
"""

from __future__ import annotations

import torch

# int32 per-lane codes.  RUNNING must be 0 so a zero-initialized lane is live.
RUNNING = 0
OPTIMAL = 1
ITER_LIMIT = 2
PRIMAL_UNBOUNDED = 3
PRIMAL_INFEASIBLE = 4
DUAL_UNBOUNDED = 5
DUAL_INFEASIBLE = 6
BASIS_PRIMAL_INFEASIBLE = 7
BASIS_DUAL_INFEASIBLE = 8
NUMERICAL_ERROR = 9

STATUS_NAMES = {
    RUNNING: "RUNNING",
    OPTIMAL: "OPTIMAL",
    ITER_LIMIT: "ITER_LIMIT",
    PRIMAL_UNBOUNDED: "PRIMAL_UNBOUNDED",
    PRIMAL_INFEASIBLE: "PRIMAL_INFEASIBLE",
    DUAL_UNBOUNDED: "DUAL_UNBOUNDED",
    DUAL_INFEASIBLE: "DUAL_INFEASIBLE",
    BASIS_PRIMAL_INFEASIBLE: "BASIS_PRIMAL_INFEASIBLE",
    BASIS_DUAL_INFEASIBLE: "BASIS_DUAL_INFEASIBLE",
    NUMERICAL_ERROR: "NUMERICAL_ERROR",
}


class LinProgError(Exception):
    """Base class for all solver errors."""


class BasisIsPrimalInfeasibleError(LinProgError):
    pass


class BasisIsDualInfeasibleError(LinProgError):
    pass


class PrimalIsUnboundedError(LinProgError):
    pass


class PrimalIsInfeasibleError(LinProgError):
    pass


class DualIsUnboundedError(LinProgError):
    pass


class DualIsInfeasibleError(LinProgError):
    pass


_STATUS_TO_EXC = {
    PRIMAL_UNBOUNDED: PrimalIsUnboundedError,
    PRIMAL_INFEASIBLE: PrimalIsInfeasibleError,
    DUAL_UNBOUNDED: DualIsUnboundedError,
    DUAL_INFEASIBLE: DualIsInfeasibleError,
    BASIS_PRIMAL_INFEASIBLE: BasisIsPrimalInfeasibleError,
    BASIS_DUAL_INFEASIBLE: BasisIsDualInfeasibleError,
}


def raise_for_status(status) -> int:
    """Raise the exception matching a terminal error status.

    ``OPTIMAL``, ``RUNNING`` and ``ITER_LIMIT`` are not errors.
    """
    code = int(status)
    exc = _STATUS_TO_EXC.get(code)
    if exc is not None:
        raise exc(STATUS_NAMES.get(code, str(code)))
    return code


def is_terminal(status):
    """True where a lane has stopped (any code but ``RUNNING``); works on
    ints and on tensors of codes."""
    return status != RUNNING


def status_name(status) -> str:
    return STATUS_NAMES.get(int(status), f"UNKNOWN({int(status)})")


def as_status(value):
    """``value`` as an int32 tensor of status codes (a tensor keeps its
    device)."""
    return torch.as_tensor(value, dtype=torch.int32)
