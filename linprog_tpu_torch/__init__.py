"""linprog_tpu_torch: the PyTorch / CUDA port of linprog_tpu.

Batched dense LP solving on an NVIDIA GPU.  :func:`solve_batch_auto` is
the front door: it routes a batch to the two-phase simplex, the batched IPM
with its straggler recovery, or the exact pipeline (batched IPM -> simplex
crossover -> two-phase fallback below m = 3072, a double-budget retry past
it -> dd-KKT certificate).  Beside it: warm re-solves
(``batch.reoptimize_batch_new_rhs``,
:func:`reoptimize_ipm_batch_canonical`), the standard-form IPM, rays and
Farkas vectors, bounded-variable batches (:func:`solve_batch_bounded`),
the per-step batched engine, the per-lane engines (``engine.run``,
``bounded.run_bounded``, ``bounded.solve_bounded_two_phase``),
``calibration.calibrate``, and the first-order and sparse families: PDHG
(dense, shared-pattern sparse, general form: :class:`PDHGSolver`; the
router's ``"pdhg"`` family; :func:`pdhg_crossover_batch_canonical`), the
shared-pattern sparse IPM with its straggler recovery
(:func:`ipm_solve_batch_sparse_canonical`,
:func:`recover_stragglers_sparse`) and the sparse front door
(:func:`solve_batch_auto_sparse`).  The general-form surface takes
single instances as host arrays and runs on a card by default
(``device="cuda"``; ``device="cpu"`` on the host): the reference's solver
classes (:class:`SimplexSolver`, the primal and dual naive and revised
classes, :class:`BoundedVariablePrimalSimplexSolver`,
:class:`PhaseOneSimplexSolver`) on the per-lane engines at a batch of
one, :class:`PrimalDualAlgorithm` (and ``primal_dual
.solve_primal_dual_batch``), :class:`IPMSolver`, :func:`ranging` /
:func:`ranging_batch`, the host presolve (:func:`presolve_problem`,
:func:`solve_with_presolve`) and ``batch.solve_batch_general``, which
pads heterogeneous instances into one batch for the two-phase kernels.
The package
has six hand-written CUDA kernels: the whole-segment simplex kernel
(``ops/solve_kernel.py``), its streaming counterpart for large m
(``ops/stream_kernel.py``), the panel inverse-Cholesky kernel
(``ops/cholinv_kernel.py``), the bounded-variable segment kernel
(``ops/bounded_kernel.py``) and the two per-step kernels
(``ops/step_kernels.py``).  Each kernel has a plain PyTorch version that a
CPU tensor takes; a CUDA tensor always launches the kernel.  The launch
plans of the three cluster kernels share ``ops/plans.py``.

f32 means IEEE f32: the package never enables TF32, which would break the
exact split products of the double-word arithmetic and pick wrong pivots.
"""

from .api import (
    BoundedVariablePrimalSimplexSolver,
    DualNaiveSimplexSolver,
    DualRevisedSimplexSolver,
    PhaseOneSimplexSolver,
    PrimalNaiveSimplexSolver,
    PrimalRevisedSimplexSolver,
    SimplexSolver,
)
from .batch import solve_batch_bounded, solve_batch_two_phase
from .certify import certificate_summary, certify_vertex_batch
from .config import DEFAULT_CONFIG, FAST_CONFIG, SolverConfig, tuned_config
from .crossover import (
    crossover_batch_canonical,
    ipm_crossover_batch_canonical,
    pdhg_crossover_batch_canonical,
)
from .engine import SimplexState
from .ipm import (
    DEFAULT_IPM_CONFIG,
    IPMConfig,
    IPMSolver,
    ipm_solve_batch_canonical,
    ipm_solve_batch_standard,
    recover_stragglers_pooled,
    reoptimize_ipm_batch_canonical,
    warm_start_point,
)
from .ipm_sparse import (
    SparsePattern,
    ipm_solve_batch_sparse_canonical,
    recover_stragglers_sparse,
)
from .pdhg import PDHGConfig, PDHGSolver
from .presolve_host import presolve_problem, solve_with_presolve
from .primal_dual import PrimalDualAlgorithm
from .ranging import RangingResult, ranging, ranging_batch
from .results import BatchResult, LinProgResult
from .router import (
    choose_family,
    choose_family_sparse,
    exact_cleanup_config,
    solve_batch_auto,
    solve_batch_auto_sparse,
    solve_batch_exact,
)
from .status import (
    BasisIsDualInfeasibleError,
    BasisIsPrimalInfeasibleError,
    DualIsInfeasibleError,
    DualIsUnboundedError,
    LinProgError,
    PrimalIsInfeasibleError,
    PrimalIsUnboundedError,
)

__all__ = [
    "BasisIsDualInfeasibleError",
    "BasisIsPrimalInfeasibleError",
    "BatchResult",
    "BoundedVariablePrimalSimplexSolver",
    "DEFAULT_CONFIG",
    "DEFAULT_IPM_CONFIG",
    "DualIsInfeasibleError",
    "DualIsUnboundedError",
    "DualNaiveSimplexSolver",
    "DualRevisedSimplexSolver",
    "FAST_CONFIG",
    "IPMConfig",
    "IPMSolver",
    "LinProgError",
    "LinProgResult",
    "PDHGConfig",
    "PDHGSolver",
    "PhaseOneSimplexSolver",
    "PrimalDualAlgorithm",
    "PrimalIsInfeasibleError",
    "PrimalIsUnboundedError",
    "PrimalNaiveSimplexSolver",
    "PrimalRevisedSimplexSolver",
    "RangingResult",
    "SimplexSolver",
    "SimplexState",
    "SolverConfig",
    "SparsePattern",
    "certificate_summary",
    "certify_vertex_batch",
    "choose_family",
    "choose_family_sparse",
    "crossover_batch_canonical",
    "exact_cleanup_config",
    "ipm_crossover_batch_canonical",
    "ipm_solve_batch_canonical",
    "ipm_solve_batch_sparse_canonical",
    "ipm_solve_batch_standard",
    "pdhg_crossover_batch_canonical",
    "presolve_problem",
    "ranging",
    "ranging_batch",
    "recover_stragglers_pooled",
    "recover_stragglers_sparse",
    "reoptimize_ipm_batch_canonical",
    "solve_batch_auto",
    "solve_batch_auto_sparse",
    "solve_batch_bounded",
    "solve_batch_exact",
    "solve_batch_two_phase",
    "solve_with_presolve",
    "tuned_config",
    "warm_start_point",
]
