"""Simplex solver configuration (counterpart of :mod:`linprog_tpu.config`).

The fields keep the reference's names, defaults and validation;
:func:`linprog_tpu_torch.convert.config_from_reference` carries every one
of them across.
"""

from __future__ import annotations

import dataclasses

from .calibration import seg_for_m


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration of the batched simplex engine.

    ``opt_tol`` is the ABSOLUTE optimality tolerance on reduced costs, as the
    segment kernel applies it (the reference's XLA path scales it by
    ``max(1, max|c|)``; the port follows the kernel).  ``feas_tol`` bounds
    basic-variable infeasibility, ``pivot_tol`` is the smallest accepted
    pivot element.  ``pricing`` is ``"bland"``, ``"dantzig"`` or ``"devex"``
    (the streaming kernel has no devex, as in the reference; the
    bounded-variable kernel always prices by Dantzig's rule).
    ``refactor_every`` is the
    segment length between exact refactorizations (0: one unbounded
    segment).  ``stall_limit`` pivots without objective progress switch a
    lane to Bland's rule.  ``unroll`` is accepted for parity and does not
    change results.  ``packed_select`` fuses min, argmin and eligibility
    into one integer min.  ``polish_pivots`` bounds the double-word terminal
    polish.  ``scaling`` turns on Ruiz equilibration in the two-phase
    pipeline (:mod:`linprog_tpu_torch.presolve`).  ``kernels`` is ``"cuda"`` (the hand-written kernels; the
    counterpart of the reference's ``"pallas"``) or ``"torch"`` (the
    per-step loop in plain PyTorch, primal only, with the optimality
    tolerance scaled by ``max(1, max|c|)`` per lane; the counterpart of the
    reference's ``"xla"``).  ``update`` is ``"eta"`` (rank-1 updates of the
    basis inverse, refactorized every ``refactor_every`` pivots) or
    ``"naive"`` (a fresh inversion at every pivot, no chunked
    refactorization); the per-lane engines and the per-step loop read it,
    the kernels always run eta updates, as the reference's do.  ``dtype``
    (``"float32"`` or ``"float64"``) is the working precision of the
    entry points that take host arrays (the solver classes,
    ``solve_batch_general``, ``presolve_host.solve_with_presolve``); the
    batched entry points compute in their tensors' dtype.

    ``split_pricing`` (kernel 1, primal mode, bland or dantzig, where the
    reference's kernel holds ``A^T``) prices with the bf16 halves of ``y``
    and ``A``: ``r = c - ((yh Ah + yh Al) + yl Ah) + pen``, every product of
    halves exact in f32 and only ``yl Al`` dropped.  ``partial_pricing``
    (kernel 3, primal mode, ``n`` a multiple of the section width: the
    streaming variant's ``n_blk``, 256 for the resident one) prices one
    section an iteration, stays in it while it yields an entering column
    and rotates when it is exhausted; a lane is OPTIMAL after every section
    came up empty under one basis.
    ``refactor_method`` is ``"inv"`` (exact inversion between segments) or
    ``"ns"`` (two Newton-Schulz steps, exact inversion only for lanes whose
    residual stays above 0.1, then a polish of at most three rounds of
    exact refactorization that reopens finished lanes).
    ``compact_refactor`` inverts only the running lanes between segments
    (False: the whole batch; the same bits on every running lane).
    """

    opt_tol: float = 1e-6
    feas_tol: float = 1e-6
    pivot_tol: float = 1e-7
    pricing: str = "bland"
    refactor_every: int = 0
    stall_limit: int = 24
    unroll: int = 1
    packed_select: bool = False
    polish_pivots: int = 0
    scaling: bool = False
    kernels: str = "cuda"
    update: str = "eta"
    dtype: str = "float32"
    split_pricing: bool = False
    partial_pricing: bool = False
    compact_refactor: bool = True
    refactor_method: str = "inv"

    def __post_init__(self):
        if self.pricing not in ("bland", "dantzig", "devex"):
            raise ValueError(f"unknown pricing rule: {self.pricing!r}")
        if self.kernels not in ("cuda", "torch"):
            raise ValueError(f"unknown kernels impl: {self.kernels!r}")
        if self.update not in ("eta", "naive"):
            raise ValueError(f"unknown update rule: {self.update!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype: {self.dtype!r}")
        if self.refactor_method not in ("inv", "ns"):
            raise ValueError(
                f"unknown refactor method: {self.refactor_method!r}")
        if self.unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {self.unroll}")

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SolverConfig()

# The reference's throughput configuration: dantzig pricing with stall
# escalation, a refactorization every 512 pivots, packed selection and the
# double-word polish.
FAST_CONFIG = SolverConfig(
    pricing="dantzig",
    refactor_every=512,
    polish_pivots=8,
    unroll=4,
    packed_select=True,
)


def tuned_config(m: int, **overrides) -> SolverConfig:
    """:data:`FAST_CONFIG` with the segment length for size ``m``
    (:func:`linprog_tpu_torch.calibration.seg_for_m`); ``overrides`` last."""
    seg = overrides.pop("refactor_every", seg_for_m(m))
    return FAST_CONFIG.replace(refactor_every=seg, **overrides)
