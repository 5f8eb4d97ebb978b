"""Checkpoint and resume of solver state (counterpart of
:mod:`linprog_tpu.checkpoint`).

The solver states are explicit NamedTuples of tensors
(:class:`~linprog_tpu_torch.engine.SimplexState`,
:class:`~linprog_tpu_torch.bounded.BoundedState`,
:class:`~linprog_tpu_torch.pdhg.PDHGState`), so a checkpoint is their
fields, and a resume is exact because each state carries its whole
iteration context (PDHG: iterates, averages, restart anchors, the primal
weight).  Two formats:

* ``.npz`` -- :func:`save_state` / :func:`load_state`, the reference's
  layout (``__type__`` and one array a field; the field names are the
  same in both packages), so a file written by either package loads in
  the other;
* ``torch.save`` -- :func:`save_state_torch` / :func:`load_state_torch`,
  in place of the reference's orbax pair.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .bounded import BoundedState
from .engine import SimplexState
from .pdhg import PDHGState

_STATE_TYPES = {
    "SimplexState": SimplexState,
    "BoundedState": BoundedState,
    "PDHGState": PDHGState,
}
StateLike = Union[SimplexState, BoundedState, PDHGState]


def save_state(path: str, state: StateLike) -> None:
    """Write a solver state to ``.npz`` (batched or not)."""
    fields = {k: np.asarray(torch.as_tensor(v).detach().cpu())
              for k, v in state._asdict().items()}
    np.savez(path, __type__=type(state).__name__, **fields)


def load_state(path: str, device="cuda") -> StateLike:
    """Load a state saved by :func:`save_state` (of either package) onto
    ``device`` (a card by default; ``"cpu"`` on the host)."""
    from .ipm_sparse import resolve_device

    dev = resolve_device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        cls = _STATE_TYPES[str(data["__type__"])]
        return cls(**{k: torch.as_tensor(data[k], device=dev)
                      for k in cls._fields})


def save_state_torch(path: str, state: StateLike) -> None:
    """Write a solver state with ``torch.save`` (tensors keep their dtypes;
    devices are restored by :func:`load_state_torch`)."""
    torch.save({"__type__": type(state).__name__, **state._asdict()}, path)


def load_state_torch(path: str, device="cuda") -> StateLike:
    """Load a state written by :func:`save_state_torch` onto ``device``."""
    from .ipm_sparse import resolve_device

    data = torch.load(path, map_location=resolve_device(device),
                      weights_only=True)
    cls = _STATE_TYPES[data.pop("__type__")]
    return cls(**data)
