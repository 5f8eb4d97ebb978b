"""Result types (counterpart of :mod:`linprog_tpu.results`):
:class:`LinProgResult` for one instance on the host, :class:`BatchResult`
for a batch on the device."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import status as st


@dataclasses.dataclass
class LinProgResult:
    """Single-instance result: ``x`` the full-length primal solution,
    ``basis`` the basic column indices (None where there is none), ``cost``
    the objective, ``iters`` the iteration count, ``optimum`` True iff the
    solve converged to an optimum, ``status`` its code and ``y`` the duals
    (simplex multipliers) where computed."""

    x: np.ndarray
    basis: Optional[np.ndarray]
    cost: float
    iters: int
    optimum: bool
    status: int = st.OPTIMAL
    y: Optional[np.ndarray] = None

    @property
    def status_name(self) -> str:
        return st.status_name(self.status)


class BatchResult(NamedTuple):
    """``x[B, n]``, ``basis[B, m]``, ``cost[B]``, ``iters[B]``, ``status[B]``,
    ``y[B, m]`` (duals at the terminal basis; a Farkas ray on
    ``PRIMAL_INFEASIBLE`` lanes).  Status codes are those of
    :mod:`linprog_tpu_torch.status`."""

    x: torch.Tensor
    basis: torch.Tensor
    cost: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor
    y: Optional[torch.Tensor] = None

    @property
    def optimum(self):
        return self.status == st.OPTIMAL
