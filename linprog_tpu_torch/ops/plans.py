"""Launch plans of the cluster kernels 1 (:mod:`.solve_kernel`), 3
(:mod:`.stream_kernel`) and 4 (:mod:`.bounded_kernel`): what they share.

A plan lays one launch out: CTAs a lane, a CTA's dynamic shared memory
and, on a streaming branch, its ring (or scalar loads).  Each wrapper
lists its candidates, best first, and settles on one with a chooser here
and ``held(plan)``, its built kernel's occupancy query: the clusters of
``plan`` the card holds at once (< 0: a negated CUDA error).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
SMEM_PER_SM = 233472  # bytes of shared memory of one SM (228 KB)
SM_COUNT = 132  # SMs of an H100 SXM (the default of the plans)
RESIDENT_STATIC_BYTES = 1024  # a resident CTA's static shared memory, reserve
STREAM_STATIC_BYTES = 2048  # a streaming CTA's static shared memory, reserve
_BLOCK_RESERVE = 1024  # bytes of an SM the card reserves for each block
_BANDS = 16  # row bands of a resident lane (csrc/cluster_segment.cuh: kBands)
_STREAM_BANDS = 8  # row bands of a streamed lane (csrc/stream_ring.cuh)
_WARPS = 8  # warps of a streaming CTA (csrc/common.cuh: kThreads / 32)
# (stages of a warp's ring, floats per stage), largest ring first
_RINGS = ((4, 1024), (4, 768), (2, 1024), (2, 768), (2, 512), (2, 256))
_BLOCK_STAGES = 4  # stages of the same memory seen as the block's ring
# cluster sizes the resident branches of kernels 1 and 4 are built for
# (csrc/solve_segment.cu, csrc/solve_bounded_segment.cu: LP_CLUSTER_SIZES)
CLUSTERS = (1, 2, 4, 8, 16)


class SegmentPlan(NamedTuple):
    """How one launch of a cluster-resident branch is laid out."""

    cluster: int  # CTAs a lane
    smem_bytes: int  # dynamic shared memory per CTA


class StreamingPlan(NamedTuple):
    """How one launch of a streaming branch is laid out (kernel 3's C entry
    point takes the first seven fields; its plans are at one CTA an SM)."""

    cluster: int  # CTAs a lane
    aligned: bool  # bulk-copy rings (True) or scalar loads (False)
    stages: int  # block ring: stages (0 on the scalar branch)
    stage_floats: int  # block ring: floats per stage
    warp_stages: int  # warp rings: stages per warp
    chunk_floats: int  # warp rings: floats per stage (a chunk of a row)
    smem_bytes: int  # dynamic shared memory per CTA
    ctas_per_sm: int  # CTAs an SM the plan leaves room for


def slice_len(size: int, cluster: int) -> int:
    """Entries of a resident CTA's slice: bands of ``ceil(size / 16)``."""
    return (_BANDS // cluster) * -(-size // _BANDS)


def band_slice_len(size: int, cluster: int) -> int:
    """Entries of a streaming CTA's slice: bands of ``ceil(size / 8)``."""
    return (_STREAM_BANDS // cluster) * -(-size // _STREAM_BANDS)


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def slices_aligned(m: int, n: int) -> bool:
    """Every row of A and of ``B^-T`` starts on a multiple of 4 floats and
    is a multiple of 4 floats long, so each row segment a CTA streams (a
    slice is whole rows) can be a 16-byte-aligned bulk copy."""
    return m % 4 == 0 and n % 4 == 0


def ring_layout(m: int, vec_bytes: int, budget: int):
    """The largest ring of ``_RINGS`` that fits ``budget`` bytes of dynamic
    shared memory beside ``vec_bytes`` of vectors, as ``(stages,
    stage_floats, warp_stages, chunk_floats, smem_bytes)``, or None.  The
    warps' view: ``warp_stages`` chunks of a row of ``B^-T`` a warp; the
    block's view of the same memory: four stages, each as many row segments
    of a sweep as fit (a stage costs the same to turn over whatever its
    size, so few large ones)."""
    for warp_stages, chunk in _RINGS:
        chunk = min(chunk, m)
        ring = _WARPS * warp_stages * chunk
        smem = vec_bytes + 4 * ring
        if smem <= budget:
            stage = ring // _BLOCK_STAGES // 4 * 4
            return _BLOCK_STAGES, stage, warp_stages, chunk, smem
    return None


def streaming_plan(cluster: int, ctas_per_sm: int, vec_bytes: int, m: int,
                   aligned: bool, smem_limit: int = SMEM_LIMIT
                   ) -> Optional[StreamingPlan]:
    """A streaming branch at ``cluster`` CTAs a lane whose CTA keeps
    ``vec_bytes`` of vectors, sized for ``ctas_per_sm`` CTAs an SM: on the
    bulk-copy branch the largest ring that fits beside the vectors, on the
    scalar branch the vectors alone; None where they do not fit."""
    # the CTA's share of the SM's shared memory, its static part left out
    budget = (min(smem_limit, SMEM_PER_SM // ctas_per_sm - _BLOCK_RESERVE)
              - STREAM_STATIC_BYTES)
    if not aligned:
        if vec_bytes > budget:
            return None
        return StreamingPlan(cluster, False, 0, 0, 0, 0, vec_bytes,
                             ctas_per_sm)
    ring = ring_layout(m, vec_bytes, budget)
    if ring is None:
        return None
    return StreamingPlan(cluster, True, *ring, ctas_per_sm)


def packed_scalar_plan(cluster: int, max_ctas: int, vec_bytes: int,
                       smem_limit: int = SMEM_LIMIT
                       ) -> Optional[StreamingPlan]:
    """The scalar-load branch at ``cluster`` CTAs a lane, sized for as many
    CTAs an SM, up to ``max_ctas`` (the build's cap), as its vectors leave
    room for; None where they fit at none."""
    for ctas in range(max_ctas, 0, -1):
        plan = streaming_plan(cluster, ctas, vec_bytes, 0, False, smem_limit)
        if plan is not None:
            return plan
    return None


def plan_sms(plan: StreamingPlan, B: int, held: int,
             sm_count: int = SM_COUNT) -> int:
    """SMs a launch of ``B`` lanes under ``plan`` fills in its first wave
    when the card holds ``held`` of its clusters at once, its CTAs packed
    ``plan.ctas_per_sm`` to an SM."""
    ctas = min(B, held) * plan.cluster
    return min(sm_count, -(-ctas // plan.ctas_per_sm))


def rank_plans(plans, B: int, held, sm_count: int):
    """``plans`` best first: the fewest waves of resident clusters
    (``held(plan)`` of them at once), then the most SMs, then the listed
    order; plans the card cannot hold (``held <= 0``) are left out."""
    keyed = []
    for i, plan in enumerate(plans):
        h = held(plan)
        if h > 0:
            keyed.append(((-(-B // h), -plan_sms(plan, B, h, sm_count), i),
                          plan))
    return [plan for _, plan in sorted(keyed)]


def estimated_held(plan: StreamingPlan, sm_count: int = SM_COUNT) -> int:
    """Clusters of ``plan`` the card holds at once, estimated without it: a
    cluster lies within one GPC, which loses about one cluster across the
    card (an H100 SXM holds 15 clusters of 8 CTAs at one CTA an SM, not
    16).  The wrappers ask the built kernel instead."""
    return max(1, sm_count * plan.ctas_per_sm // plan.cluster - 1)


def resident(m: int, n: int, cbytes, smem_limit: int = SMEM_LIMIT) -> bool:
    """Whether a lane of (m, n) takes the cluster-resident branch: its A and
    ``B^-T`` fit the largest built cluster (``cbytes`` gives a CTA's
    bytes)."""
    return cbytes(m, n, CLUSTERS[-1]) + RESIDENT_STATIC_BYTES <= smem_limit


def resident_plans(B: int, m: int, n: int, cbytes, sm_count: int,
                   smem_limit: int) -> List[SegmentPlan]:
    """The cluster-resident candidates of a lane that :func:`resident` holds:
    the built cluster sizes whose CTA holds its share, first the largest
    that keeps the batch within the card's SMs, else the smallest that fits,
    then the others from the smallest up."""
    fits = [cl for cl in CLUSTERS
            if cbytes(m, n, cl) + RESIDENT_STATIC_BYTES <= smem_limit]
    wide = [cl for cl in fits if B * cl <= sm_count]
    first = wide[-1] if wide else fits[0]
    order = [first] + [cl for cl in fits if cl != first]
    return [SegmentPlan(cl, cbytes(m, n, cl)) for cl in order]


def built_streaming(what: str, m: int, n: int, plans: list,
                    scalar: list) -> List[StreamingPlan]:
    """A lane's streaming candidates, then the scalar-load ``scalar`` plans
    not among them; raises where the candidates are cluster-resident."""
    if not all(isinstance(p, StreamingPlan) for p in plans):
        raise ValueError(f"{what}: (m, n) = ({m}, {n}) takes the "
                         "cluster-resident branch")
    return plans + [p for p in scalar if p is not None and p not in plans]


def scalar_for_unaligned(plans: list, scalar: Callable) -> list:
    """``plans`` with each bulk-copy plan swapped for ``scalar(cluster)``,
    the scalar-load branch at its size (a bulk copy needs 16-byte-aligned
    pointers), sizes without one dropped, repeats dropped."""
    swapped = (p if not p.aligned else scalar(p.cluster) for p in plans)
    return list(dict.fromkeys(p for p in swapped if p is not None))


def cuda_index(device: torch.device) -> int:
    """The CUDA index of ``device`` (the current one where it names none)."""
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def aligned_pointers(A, invBT) -> bool:
    """Whether A and the factor start on 16 bytes, as a bulk copy needs."""
    return A.data_ptr() % 16 == 0 and invBT.data_ptr() % 16 == 0


def held_on(index: int, query: Callable) -> Callable:
    """``held(plan)`` for the choosers: the built kernel's occupancy query
    ``query(plan)``, asked of CUDA device ``index``."""
    def held(plan):
        with torch.cuda.device(index):  # the query asks the current device
            return query(plan)
    return held


# ---- the choosers: one candidate of a wrapper's list, by held(plan) -----


def fewest_waves(plans: list, B: int, held: Callable, what: str,
                 where: str = ""):
    """The first of ``plans`` that runs ``B`` lanes in the fewest waves of
    ``held(plan)`` clusters at once.  Kernels 1 and 4 take it on the
    cluster-resident branch, kernel 3 on its one branch: their candidates
    are a few cluster sizes, listed best first by the SMs a batch fills, and
    the query settles which are held and in how many waves they run."""
    best, best_waves, seen = None, None, []
    for plan in plans:
        h = held(plan)
        seen.append((plan.cluster, h))
        if h > 0 and (best is None or -(-B // h) < best_waves):
            best, best_waves = plan, -(-B // h)
    if best is None:
        raise RuntimeError(
            f"{what}: the device holds no cluster of any planned size{where}: "
            f"(cluster, resident or negated CUDA error) = {seen}")
    return best


def first_granted(plans: list, held: Callable, what: str, where: str = ""):
    """The first of ``plans`` the card holds at all.  Kernel 1 takes it on
    its streaming branch, whose candidates come ranked by
    :func:`estimated_held`, and not by the query's own count: the card
    holds 30 clusters of 8 CTAs two to an SM where the estimate says 32,
    yet 32 lanes of (1024, 2048) run faster on them (a tail of 2 lanes)
    than on the 64 SMs of one wave of 2 CTAs a lane."""
    seen = []
    for plan in plans:
        h = held(plan)
        if h > 0:
            return plan
        seen.append((plan, h))
    raise _none_held(what, where, seen)


def best_ranked(plans: list, B: int, held: Callable, sm_count: int,
                what: str, where: str = ""):
    """The first of ``plans`` by :func:`rank_plans` on the query's count:
    the fewest waves, then the most SMs, then the listed order.  Kernel 4
    takes it on its streaming branch, whose layouts differ in CTAs an SM
    as well as in size (at [16, 1280, 2560] 8 CTAs a lane two to an SM
    beat 4 one to an SM, both one wave on 64 SMs)."""
    seen = []

    def ask(plan):
        seen.append((plan, held(plan)))
        return seen[-1][1]

    ranked = rank_plans(plans, B, ask, sm_count)
    if not ranked:
        raise _none_held(what, where, seen)
    return ranked[0]


def _none_held(what: str, where: str, seen: list) -> RuntimeError:
    return RuntimeError(
        f"{what}: the device holds no cluster of any planned streaming "
        f"layout{where}: (plan, resident or negated CUDA error) = {seen}")
