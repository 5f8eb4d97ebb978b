"""Multi-process bring-up on ``torch.distributed`` (counterpart of
:mod:`linprog_tpu.parallel.distributed`).

JAX compiles its collectives from shardings; here they are explicit calls
on a process group: NCCL between cards, gloo on the host.  One process
drives one device, and a mesh (:class:`~torch.distributed.device_mesh
.DeviceMesh`) names the process groups of its dimensions.

Typical launch (the same script in every process, e.g. under ``torchrun``,
which sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)::

    from linprog_tpu_torch.parallel import distributed
    distributed.initialize()                  # one process: a private group
    mesh = distributed.global_batch_mesh()    # every process
    res = sharded_two_phase_solve(mesh, c, A, b)

Every group is created with a timeout (60 s by default), so a rank that
dies makes the others fail instead of waiting forever.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0

# The device type of the meshes built here ("cuda" or "cpu"), set by
# :func:`initialize`.  Like the process group it goes with, it is state of
# the process.
_device_type: Optional[str] = None


def _local_cuda_index(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Create the default process group (idempotent).

    With no arguments and no launcher environment (``RANK`` and
    ``WORLD_SIZE`` unset) the group has one process and lives in an
    in-memory store: no port, no network.  ``coordinator_address`` is
    ``"host:port"`` (a TCP store on that host) or a ``file://`` path shared
    by the processes; without it but with ``num_processes`` or the launcher
    environment the group rendezvouses through ``env://``.

    ``device="cuda"`` (the default) solves on this process's card (``cuda:i``
    with ``i`` the local rank modulo the cards) over NCCL and raises where
    there is no card; ``device="cpu"`` solves on the host over gloo.
    ``backend`` overrides the choice: two processes that share one card
    need ``backend="gloo"``, since NCCL refuses two ranks on one device.
    """
    global _device_type
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the host")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and num_processes is None and not launched:
        rank, kw = 0, dict(store=dist.HashStore(), rank=0, world_size=1)
    else:
        if coordinator_address is None:
            init_method = "env://"
        elif "://" in coordinator_address:
            init_method = coordinator_address
        else:
            init_method = f"tcp://{coordinator_address}"
        rank = int(os.environ.get("RANK", -1)) if process_id is None \
            else process_id
        kw = dict(init_method=init_method, rank=rank,
                  world_size=-1 if num_processes is None else num_processes)
    if dev.type == "cuda":
        local = _local_cuda_index(max(rank, 0))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, timeout=timeout, **kw)
    _device_type = dev.type


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    global _device_type
    if dist.is_initialized():
        dist.destroy_process_group()
    _device_type = None


def device_type() -> str:
    """The device type of this process's meshes (``initialize()`` with its
    default device first if no group exists)."""
    if not dist.is_initialized():
        initialize()
    return _device_type or "cpu"


def solve_device(mesh) -> torch.device:
    """The device this process solves on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(names, shape=None, ranks=None):
    """A mesh of dimensions ``names`` over ``ranks`` (default: every rank,
    laid out in ``shape``; default shape: one dimension over the world).
    Every rank of the default group calls it, also a rank outside
    ``ranks``, which gets a mesh it is not part of."""
    from torch.distributed.device_mesh import DeviceMesh

    dt = device_type()
    world = dist.get_world_size()
    if ranks is None:
        ranks = list(range(world))
    grid = torch.tensor(list(ranks), dtype=torch.int64)
    grid = grid.reshape(shape if shape is not None else (grid.numel(),))
    return DeviceMesh(dt, grid, mesh_dim_names=tuple(names))


def global_batch_mesh(axis: str = "batch"):
    """1-D mesh over every process."""
    return make_mesh((axis,))


def global_2d_mesh(model_size: int, batch_axis: str = "batch",
                   model_axis: str = "model"):
    """2-D ``(batch, model)`` mesh: data parallel across, tensor parallel
    within.  ``model_size`` processes per model group (must divide the
    world); consecutive ranks share a model group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_size != 0:
        raise ValueError(
            f"{world} devices not divisible by model_size={model_size}"
        )
    return make_mesh((batch_axis, model_axis),
                     shape=(world // model_size, model_size))


def process_summary() -> dict:
    """This process's view of the group (observability): the reference's
    keys, one device per process."""
    init = dist.is_initialized()
    cuda = (_device_type if init else "cuda" if torch.cuda.is_available()
            else "cpu") == "cuda"
    world = dist.get_world_size() if init else 1
    return {
        "process_index": dist.get_rank() if init else 0,
        "process_count": world,
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "global_devices": world,
        "platform": "gpu" if cuda else "cpu",
    }
