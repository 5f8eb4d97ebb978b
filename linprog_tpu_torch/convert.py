"""Carry the reference package's configuration and solver state across.

An LP solver has no weights: its state is the instance plus the basis,
factor and iterate.  These helpers move that state between the reference's
layouts (numpy arrays, e.g. ``np.asarray`` of its JAX arrays) and this
package's torch tensors on a device, so both packages can be fed the same
state.  None of them imports the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .bounded import BoundedState
from .config import SolverConfig
from .engine import SimplexState
from .ipm import IPMConfig, IPMState
from .pdhg import PDHGState
from .ops.bounded_kernel import BoundedSegmentState
from .ops.solve_kernel import SegmentState
from .results import BatchResult


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    raise TypeError(f"expected a dict or NamedTuple, got {type(obj)!r}")


def config_from_reference(d: dict):
    """A port config from a reference ``SolverConfig`` or ``IPMConfig``
    given as a dict (``dataclasses.asdict``).

    ``kernels="pallas"`` maps to ``"cuda"`` and ``kernels="xla"`` to
    ``"torch"`` (the per-step loop, which scales ``opt_tol`` by
    ``max(1, max|c|)`` as the reference's XLA path does, and the per-lane
    engines).  Every other field carries over as it is.
    """
    d = dict(d)
    if "eps_rel" in d:
        return IPMConfig(**d)
    kernels = d.pop("kernels", "xla")
    if kernels not in ("pallas", "xla"):
        raise ValueError(f"unknown reference kernels value {kernels!r}")
    return SolverConfig(kernels={"pallas": "cuda", "xla": "torch"}[kernels],
                        **d)


def _t(a, device, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)  # a copy


def _np(t):
    return t.detach().cpu().numpy()


def simplex_state_from_numpy(state, device="cpu", dtype=torch.float32
                             ) -> SimplexState:
    """Reference ``SimplexState`` -> port state (batched arrays stay
    batched; a single instance's state keeps its unbatched shapes, as the
    solver classes' ``state`` gives it), ``inv_B`` and ``bfs`` in
    ``dtype``."""
    f = _fields(state)
    return SimplexState(
        basis=_t(f["basis"], device, torch.int32),
        inv_B=_t(f["inv_B"], device, dtype),
        bfs=_t(f["bfs"], device, dtype),
        iters=_t(f["iters"], device, torch.int32),
        status=_t(f["status"], device, torch.int32),
    )


def simplex_state_to_numpy(state: SimplexState) -> dict:
    return {k: _np(v) for k, v in state._asdict().items()}


def ipm_state_from_numpy(state, device="cpu", dtype=torch.float32) -> IPMState:
    """Reference ``IPMState`` -> port state."""
    f = _fields(state)
    return IPMState(
        x=_t(f["x"], device, dtype),
        y=_t(f["y"], device, dtype),
        s=_t(f["s"], device, dtype),
        iters=_t(f["iters"], device, torch.int32),
        status=_t(f["status"], device, torch.int32),
    )


def ipm_state_to_numpy(state: IPMState) -> dict:
    return {k: _np(v) for k, v in state._asdict().items()}


def pdhg_state_from_numpy(state, device="cpu", dtype=torch.float32
                          ) -> PDHGState:
    """Reference ``PDHGState`` (batched arrays) -> port state: counters
    and status int32, ``halpern_off`` bool, the rest in ``dtype``."""
    f = _fields(state)
    ints = ("inner_count", "iters", "status")
    return PDHGState(**{
        k: _t(f[k], device, torch.int32 if k in ints else
              torch.bool if k == "halpern_off" else dtype)
        for k in PDHGState._fields})


def pdhg_state_to_numpy(state: PDHGState) -> dict:
    return {k: _np(v) for k, v in state._asdict().items()}


def batch_result_from_numpy(result, device="cpu", dtype=torch.float32
                            ) -> BatchResult:
    """Reference ``BatchResult`` -> the port's (``y`` stays None where the
    reference stored none)."""
    f = _fields(result)
    y = f.get("y")
    return BatchResult(
        x=_t(f["x"], device, dtype),
        basis=_t(f["basis"], device, torch.int32),
        cost=_t(f["cost"], device, dtype),
        iters=_t(f["iters"], device, torch.int32),
        status=_t(f["status"], device, torch.int32),
        y=None if y is None else _t(y, device, dtype),
    )


def batch_result_to_numpy(result: BatchResult) -> dict:
    return {k: None if v is None else _np(v)
            for k, v in result._asdict().items()}


def packed_from_numpy(packed, device="cpu"):
    """The reference kernel's packed layout -> ``(c, apen, SegmentState)``.

    ``packed`` is the 10-tuple of the reference's ``_pallas_pack``:
    ``(c_row[B,1,n], apen[B,1,n], invBT[B,m,m], bfs[B,1,m], cB[B,1,m],
    basis[B,1,m], pen[B,1,n], gamma[B,1,n], iters[B,1,1], status[B,1,1])``.
    The port drops the singleton row dimensions.
    """
    c_row, apen, invBT, bfs, cB, basis, pen, gamma, iters, status = (
        np.asarray(a) for a in packed
    )
    B = invBT.shape[0]
    f32 = torch.float32
    return (
        _t(c_row.reshape(B, -1), device, f32),
        _t(np.broadcast_to(apen, (B,) + apen.shape[1:]).reshape(B, -1),
           device, f32),
        SegmentState(
            invBT=_t(invBT, device, f32),
            bfs=_t(bfs.reshape(B, -1), device, f32),
            cB=_t(cB.reshape(B, -1), device, f32),
            basis=_t(basis.reshape(B, -1), device, torch.int32),
            pen=_t(pen.reshape(B, -1), device, f32),
            gamma=_t(gamma.reshape(B, -1), device, f32),
            iters=_t(iters.reshape(B), device, torch.int32),
            status=_t(status.reshape(B), device, torch.int32),
        ),
    )


def packed_to_numpy(c, apen, seg: SegmentState):
    """Inverse of :func:`packed_from_numpy`: the reference's 10-tuple."""
    B = seg.invBT.shape[0]
    row = lambda t: _np(t).reshape(B, 1, -1)  # noqa: E731
    return (row(c), row(apen), _np(seg.invBT), row(seg.bfs), row(seg.cB),
            row(seg.basis), row(seg.pen), row(seg.gamma),
            _np(seg.iters).reshape(B, 1, 1), _np(seg.status).reshape(B, 1, 1))


def bounded_state_from_numpy(state, device="cpu") -> BoundedState:
    """Reference ``BoundedState`` (batched arrays) -> port state."""
    f = _fields(state)
    return BoundedState(
        basis=_t(f["basis"], device, torch.int32),
        inv_B=_t(f["inv_B"], device, torch.float32),
        bfs=_t(f["bfs"], device, torch.float32),
        var_state=_t(f["var_state"], device, torch.int8),
        iters=_t(f["iters"], device, torch.int32),
        status=_t(f["status"], device, torch.int32),
    )


def bounded_state_to_numpy(state: BoundedState) -> dict:
    return {k: _np(v) for k, v in state._asdict().items()}


def bounded_packed_from_numpy(packed, device="cpu") -> BoundedSegmentState:
    """The reference bounded kernel's state layout -> the port's.

    ``packed`` is the 9-tuple that ``solve_bounded_segment`` takes and
    returns: ``(invBT[B,m,m], bfs[B,1,m], cB[B,1,m], basis[B,1,m],
    vstate[B,1,n] (f32 codes), lbB[B,1,m], ubB[B,1,m], iters[B,1,1],
    status[B,1,1])``.  The port drops the singleton row dimensions and
    carries the variable states as int8.
    """
    invBT, bfs, cB, basis, vstate, lbB, ubB, iters, status = (
        np.asarray(a) for a in packed
    )
    B = invBT.shape[0]
    f32, i32 = torch.float32, torch.int32
    return BoundedSegmentState(
        invBT=_t(invBT, device, f32),
        bfs=_t(bfs.reshape(B, -1), device, f32),
        cB=_t(cB.reshape(B, -1), device, f32),
        basis=_t(basis.reshape(B, -1), device, i32),
        vstate=_t(vstate.reshape(B, -1), device, torch.int8),
        lbB=_t(lbB.reshape(B, -1), device, f32),
        ubB=_t(ubB.reshape(B, -1), device, f32),
        iters=_t(iters.reshape(B), device, i32),
        status=_t(status.reshape(B), device, i32),
    )
