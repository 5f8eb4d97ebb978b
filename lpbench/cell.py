"""What a traffic driver hands the harness.

A driver (``lpbench/drivers/<driver>.py``) has one function,
``setup(config, traffic, seed, device) -> Cell``: it makes the cell's
inputs on the device from the seed, builds whatever the entry point needs
before the window, and warms up the cell's shapes with one call.  The
harness then calls :meth:`Cell.call` in a closed loop and, once the window
has closed, asks :meth:`Cell.problems` for the sampled LPs to hand the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# The program's per-lane status codes (linprog_tpu_torch/status.py), read
# as outcomes: OPTIMAL 1; PRIMAL_INFEASIBLE 4 and DUAL_UNBOUNDED 5 say the
# LP is infeasible; PRIMAL_UNBOUNDED 3 and DUAL_INFEASIBLE 6 that it is
# unbounded.  Every other code (a lane still running, an iteration limit,
# a numerical failure) gives no answer.
_OUTCOME = {1: "optimal", 4: "infeasible", 5: "infeasible",
            3: "unbounded", 6: "unbounded"}
ANSWER_CODES = tuple(_OUTCOME)


def outcomes(status: torch.Tensor) -> list:
    return [_OUTCOME.get(int(s), "none") for s in status.tolist()]


def no_answer(status: torch.Tensor) -> torch.Tensor:
    """Lanes that gave no answer, counted on the device."""
    codes = torch.tensor(ANSWER_CODES, dtype=status.dtype,
                         device=status.device)
    return (~torch.isin(status, codes)).sum()


class Answer(NamedTuple):
    """One call's result, on the device: ``status[B]``, ``x[B, k]``,
    ``cost[B]``, ``basis[B, m]``, ``iters[B]``, and host-side counts of the
    paths the call took (``info``)."""

    status: torch.Tensor
    x: torch.Tensor
    cost: torch.Tensor
    basis: torch.Tensor
    iters: torch.Tensor
    info: dict


class Problem(NamedTuple):
    """Sampled LPs for the reference, ``min c'z, A z = b, lb <= z <= ub``:
    columns ``slack_start ..`` are the rows' slack columns, and the
    program's ``x`` covers the first ``x_cols`` columns.  ``bounded``: the
    set of variables at their upper bound is compared too."""

    c: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    slack_start: int
    x_cols: int
    bounded: bool


class Cell:
    """The cell's state between set-up and the reference."""

    lanes: int = 0  # lanes a call

    def call(self, i: int) -> Answer:
        """The ``i``-th call of the window (the entry point on its
        batch)."""
        raise NotImplementedError

    def key(self, i: int) -> int:
        """Which input the ``i``-th call solves (the same key, the same
        LPs)."""
        raise NotImplementedError

    def problems(self, keys: torch.Tensor, lanes: torch.Tensor) -> Problem:
        """The LPs of ``(keys[s], lanes[s])``, made by the benchmark."""
        raise NotImplementedError

    def release(self) -> None:
        """Drop what the program made (set-up results, prepared state)."""
