"""Data parallelism over a device mesh (counterpart of
:mod:`linprog_tpu.parallel.mesh`).

The scaling axis is data parallelism over independent LP instances: a 1-D
:class:`~torch.distributed.device_mesh.DeviceMesh` over dimension
``"batch"``, one process per device.  Every rank is handed the same global
batch (as JAX is handed a global array) or a ``DTensor`` sharded by
:func:`shard_batch`; it solves its contiguous block of ``B / D`` lanes on
its own device with the package's batched solver (the segment and panel
kernels on a card), and the fields of the result are ``all_gather``-ed, so
every rank returns the reference's global result.  The hot loop has no
traffic; only the gathers cross devices.

A gloo group moves a CUDA tensor to the host for its collective and back
(two processes that share one card run over gloo); the solves stay on the
card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..batch import solve_batch_two_phase
from ..config import DEFAULT_CONFIG, SolverConfig
from ..results import BatchResult
from . import distributed


def make_batch_mesh(n_devices: Optional[int] = None, devices=None):
    """1-D mesh over dimension ``"batch"``: every process, the first
    ``n_devices`` of them, or the ranks listed in ``devices``.  Every rank
    of the default group calls it."""
    if devices is None and n_devices is not None:
        devices = range(n_devices)
    return distributed.make_mesh(("batch",), ranks=devices)


def batch_sharding(mesh, ndim: int):
    """Placements that shard the leading (batch) dim over the mesh's
    ``"batch"`` dimension and replicate over any other: the counterpart of
    ``NamedSharding(mesh, P("batch", None, ...))`` for an ``ndim``-D
    array."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError("a batch-sharded array needs a leading batch dim")
    return tuple(Shard(0) if name == "batch" else Replicate()
                 for name in mesh.mesh_dim_names)


def shard_batch(mesh, *arrays):
    """``DTensor``s with their batch dim sharded over the mesh (a
    collective: every rank of the mesh calls it with the same arrays)."""
    from torch.distributed.tensor import distribute_tensor

    dev = distributed.solve_device(mesh)
    out = tuple(
        distribute_tensor(torch.as_tensor(a).to(dev), mesh,
                          batch_sharding(mesh, np.ndim(a)))
        for a in arrays
    )
    return out if len(out) > 1 else out[0]


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` from every rank of ``group``, concatenated along dim 0 in
    rank order (through the host where a gloo group meets a CUDA
    tensor)."""
    src = t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t
    flat = src.view(torch.uint8) if src.dtype == torch.bool else src
    flat = flat.contiguous()
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    out = torch.cat(parts, dim=0)
    if src.dtype == torch.bool:
        out = out.view(torch.bool)
    return out.to(t.device)


def _gather(out, group):
    """Every tensor field of ``out`` (a tensor, a tuple or a NamedTuple;
    None stays None) gathered along the batch dim."""
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return _all_gather(out, group)
    if isinstance(out, tuple):
        fields = [_gather(v, group) for v in out]
        return type(out)(*fields) if hasattr(out, "_fields") else tuple(fields)
    raise TypeError(f"cannot gather a {type(out).__name__}")


def _local_block(a, rank: int, per: int, dev) -> torch.Tensor:
    """This rank's lanes ``[rank * per, (rank + 1) * per)`` of the global
    batch ``a`` (a tensor, a host array, or a batch-sharded ``DTensor``)."""
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        return a.to_local().to(dev)
    return torch.as_tensor(a)[rank * per:(rank + 1) * per].to(dev)


def _batch_coords(mesh, dim: str):
    """(group, size, this rank's coordinate) of mesh dimension ``dim``."""
    if dim not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no {dim!r} dimension: "
                         f"{mesh.mesh_dim_names}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not part of the mesh")
    return (mesh.get_group(dim), mesh.size(mesh.mesh_dim_names.index(dim)),
            mesh.get_local_rank(dim))


def _solve_sharded(mesh, solve, *batched, dim: str = "batch"):
    """``solve(*local)`` on this rank's contiguous block of every array in
    ``batched`` (leading batch dims of one length B), on this rank's
    device; the result's tensor fields gathered over ``dim``, so every rank
    returns the global result.  Arguments that are not batched (a sparse
    pattern, a config) are closed over by ``solve`` and stay replicated.
    Raises the reference's ``ValueError`` when B does not divide."""
    group, D, rank = _batch_coords(mesh, dim)
    B = int(batched[0].shape[0])
    if B % D != 0:
        raise ValueError(f"batch size {B} not divisible by mesh size {D}")
    dev = distributed.solve_device(mesh)
    local = [_local_block(a, rank, B // D, dev) for a in batched]
    return _gather(solve(*local), group)


def sharded_two_phase_solve(
    mesh,
    c,
    A,
    b,
    maxiters1: int = 1000,
    maxiters2: int = 1000,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> BatchResult:
    """Two-phase batched solve with the batch dim sharded over ``mesh``
    (``c[B, n], A[B, m, n], b[B, m]``, B divisible by the mesh size).
    Every lane is independent: each rank runs its lanes through
    :func:`linprog_tpu_torch.batch.solve_batch_two_phase`, and only the
    result gather crosses devices."""
    return _solve_sharded(
        mesh, lambda c, A, b: solve_batch_two_phase(
            c, A, b, maxiters1=maxiters1, maxiters2=maxiters2, cfg=cfg),
        c, A, b)


def sharded_pdhg_batch_canonical(mesh, c, G, h,
                                 maxiters: int = 100_000, cfg=None):
    """Batched first-order solve with the batch dim sharded over ``mesh``:
    :func:`linprog_tpu_torch.pdhg.pdhg_solve_batch_canonical` on each
    rank's lanes.  Returns ``(x, cost, status, iters)`` in the original
    scaling, gathered."""
    from ..pdhg import DEFAULT_PDHG_CONFIG, pdhg_solve_batch_canonical

    cfg = cfg or DEFAULT_PDHG_CONFIG
    return _solve_sharded(
        mesh, lambda c, G, h: pdhg_solve_batch_canonical(
            c, G, h, maxiters=maxiters, cfg=cfg),
        c, G, h)


def sharded_ipm_batch_canonical(mesh, c, G, h, cfg=None) -> BatchResult:
    """Batched interior-point solve with the batch dim sharded over
    ``mesh``: :func:`linprog_tpu_torch.ipm.ipm_solve_batch_canonical` (the
    panel kernel on a card) on each rank's lanes, gathered."""
    from ..ipm import DEFAULT_IPM_CONFIG, ipm_solve_batch_canonical

    cfg = cfg or DEFAULT_IPM_CONFIG
    return _solve_sharded(
        mesh, lambda c, G, h: ipm_solve_batch_canonical(c, G, h, cfg),
        c, G, h)
