"""Multi-device solving on ``torch.distributed`` (counterpart of
:mod:`linprog_tpu.parallel`): data parallelism over a batch mesh
(:mod:`.mesh`), column-sharded tensor parallelism (:mod:`.tp`), process
bring-up (:mod:`.distributed`) and the multi-process dry run
(:mod:`.dryrun`)."""

from . import distributed
from .mesh import (
    batch_sharding,
    make_batch_mesh,
    shard_batch,
    sharded_ipm_batch_canonical,
    sharded_pdhg_batch_canonical,
    sharded_two_phase_solve,
)
from .tp import make_model_mesh, tp_solve, tp_solve_batch

__all__ = [
    "make_batch_mesh",
    "batch_sharding",
    "shard_batch",
    "sharded_ipm_batch_canonical",
    "sharded_pdhg_batch_canonical",
    "sharded_two_phase_solve",
    "make_model_mesh",
    "tp_solve",
    "tp_solve_batch",
    "distributed",
]
