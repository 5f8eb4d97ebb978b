"""Batched result type (counterpart of :class:`linprog_tpu.results.BatchResult`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import status as st


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
