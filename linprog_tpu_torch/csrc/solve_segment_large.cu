// Whole-segment revised simplex for lanes past the largest resident cluster
// (m ~ 512 to the block line at n = 2m): up to seg_len iterations per lane in
// one launch, one thread-block cluster of CL CTAs per lane, the lane's state
// updated in place. Kernel 1's streaming branch; its cluster-resident
// branch is solve_segment.cu.
//
// Replaces linprog_tpu/ops/solve_kernel.py :: solve_segment (Pallas) for
// those lanes, with every mode of the reference's kernel: primal and dual,
// bland / dantzig / devex pricing, packed keys, stall -> Bland, split-bf16
// pricing and the ablation switch.
//
// What bounds it: device-memory bandwidth. A lane's A[m, n] and transposed
// basis inverse invBT[m, m] stay in device memory (8 MB and 4 MB at m = 1024,
// n = 2048), and each primal pivot moves A once and invBT three times (the
// direction reads it, the eta pass reads and writes it): ~21 MB a lane,
// 1.34 GB for a batch of 64. One block per lane (the body this branch
// replaced) drew 0.73 TB/s on 64 SMs. So the lane is split over a cluster,
// in the design of kernel 3 (solve_segment_stream.cu) and kernel 4's
// streaming branch, whose row-split primitives it shares (stream_ring.cuh):
//   * CTA k owns contiguous whole bands of the lane's 8 fixed row bands of
//     ceil(m / 8) rows: those rows of A and invBT, and with them its entries
//     of y, bfs and the basis. c_B and d are kept whole in every CTA. Each
//     CTA also owns a slice of the columns: c, pen, r, the dual row and the
//     devex weights of that slice, so m = 1024, n = 2048 leaves room for a
//     ring.
//   * Every product over rows is a partial over the CTA's rows for every
//     column, added through distributed shared memory as one fixed tree over
//     the 8 band totals (tree_sum / reduce_slice): a lane gets the same bits
//     at every cluster size and layout the plan may pick, and on both load
//     branches. The direction sums with fused multiply-adds (as kernel 3,
//     the cluster-resident branch and the plain version's library GEMV do);
//     every other product rounds first (--fmad=false).
//   * Selections are per-CTA partials (packed key, or value and lowest
//     index) combined in rank order; the entering column's cost, reduced
//     cost and weight are read from their owner, the leaving row's bfs and
//     basis entry ride the owner's partial.
//   * A pivot rewrites the CTA's rows of invBT in one eta pass that also
//     yields the next duals (after c_B[leave] = c_enter); only a launch's
//     first iteration runs the standalone duals pass.
//   * Dual mode picks the leaving row first; one pass over A gives both
//     y A and the dual row B^-1[l, :] A, then the dual ratio test.
//   * Devex (kernel 3 has none): the weights need the pivot row of the OLD
//     tableau, w = (column l of invBT before the pivot) . A. The CTA keeps
//     its own entries of that column (s_colL), and w rides the next
//     iteration's pricing pass as a second sum, so a devex pivot costs no
//     pass over A of its own; the weights are updated right after that
//     pass's barrier, before they are read. The launch's last pending pivot
//     takes one standalone pass. In dual mode w is the dual row itself. The
//     rule is the reference's: gamma_j <- max(gamma_j, (w_j / d_l)^2
//     gamma_q) with gamma_q = max(gamma[enter], 1), the leaving column at
//     max(gamma_q / d_l^2, 1), everything capped at 1e12.
//   * Split pricing (split = 1, primal bland or dantzig) runs the three
//     partial sums yh Ah, yh Al, yl Ah of the bf16 halves in the pricing
//     pass's order (the halves taken in registers from the f32 A) and adds
//     their trees in the reference's order: r = (c - ((hh + hl) + lh)) + pen.
//   * The ablation switch (ablate = 1..7, profiling only) drops the stage
//     the cluster-resident branch drops (solve_segment.cu's header).
//   * Aligned shapes (m, n multiples of 4, 16-byte pointers) stream every
//     pass through a ring in shared memory filled by cp.async.bulk copies
//     on mbarriers; other shapes take ld.global.cg loads in the same kernel,
//     summed in the same order.
// Cluster barriers an iteration (the phases that read another CTA's shared
// memory):
//   primal: [y own rows: first iteration only; partial of y A (and of a
//           devex pivot's row)] (a) [the weights; r of own columns; entering
//           partial] (b) [the entering column's scalars from its owner;
//           partial of the direction] (c) [d of own rows; ratio partial] (d)
//           [gather d; the eta pass of own rows with the next y; states]
//   dual:   [leaving partial] (l) [partials of w A and y A] (a) [the dual
//           row and r of own columns; dual ratio partial] (b) [partial of
//           the direction] (c) [d of own rows] (d) [gather d; the weights;
//           the eta pass; states]
// A partial is rewritten only after a barrier that follows its last readers.
// Every CTA reduces the same partials in the same order, so all agree on
// every decision and take the same number of iterations.
//
// Semantics follow the Pallas kernel and the plain PyTorch version
// (linprog_tpu_torch/ops/solve_kernel.py), as on the cluster-resident
// branch: absolute opt_tol, packed keys with the index in the low bits
// (complemented for negative values, INT32_MAX for none, lowest index on
// exact ties), ratios clamped to +0.0 before packing, segment-local stall
// state, untouched non-RUNNING lanes.
//
// Builds: the bulk-copy branch at 2, 4 and 8 CTAs a lane here, the scalar
// branch at 4 and 8 in solve_segment_large_scalar.cu (the kernel template is
// solve_segment_large.cuh); the launch plan (cluster size, CTAs an SM, ring,
// load branch) is ops/solve_kernel.py :: segment_plans.

#include <cuda_runtime.h>
#include <stdint.h>

#include "solve_segment_large.cuh"

namespace lpl {
LP_LARGE_RING_BUILDS(LP_LARGE_DEFINE)
}  // namespace lpl

namespace {

bool built(int cluster, bool ring) {
#define LP_BUILT(CL, RING) \
  if (cluster == CL && ring == RING) return true;
  LP_LARGE_RING_BUILDS(LP_BUILT)
  LP_LARGE_SCALAR_BUILDS(LP_BUILT)
#undef LP_BUILT
  return false;
}

}  // namespace

// How many clusters of `cluster` CTAs of the streaming branch (`aligned`:
// the bulk-copy branch, else scalar loads) with `smem_bytes` of dynamic
// shared memory each the device holds at once; < 0 is a negated CUDA error
// (a cluster size the device does not grant, or one not built).
extern "C" int lp_solve_segment_large_max_clusters(int cluster, int aligned,
                                                   int smem_bytes) {
  if (smem_bytes < 0 || !built(cluster, aligned != 0))
    return -(int)cudaErrorInvalidValue;
#define LP_MAX(CL, RING)                                 \
  if (cluster == CL && (aligned != 0) == RING)           \
    return lpl::max_clusters_##CL##_##RING((size_t)smem_bytes);
  LP_LARGE_RING_BUILDS(LP_MAX)
  LP_LARGE_SCALAR_BUILDS(LP_MAX)
#undef LP_MAX
  return -(int)cudaErrorInvalidValue;
}

// The streaming branch under a launch plan (cluster .. smem_bytes) from
// ops/solve_kernel.py :: segment_plans, checked here against the shape and
// the modes before anything is launched.
extern "C" int lp_solve_segment_large(
    const float* A, const float* c, const float* apen, float* invBT,
    float* bfs, float* cB, int* basis, float* pen, float* gamma, int* iters,
    int* status, int B, int m, int n, int seg_len, int maxiters,
    float opt_tol, float pivot_tol, float feas_tol, int dual, int pricing,
    int packed, int stall_limit, int split, int ablate, int cluster,
    int aligned, int stages, int stage_floats, int warp_stages,
    int chunk_floats, int smem_bytes, void* stream) {
  if (pricing < 0 || pricing > 2 || m < 1 || n < 1 || B < 1 || ablate < 0 ||
      ablate > 7 || (split && (dual || pricing == 2)) ||
      !built(cluster, aligned != 0))
    return (int)cudaErrorInvalidValue;
  size_t ring = 0;
  if (aligned) {
    const bool ok =
        m % 4 == 0 && n % 4 == 0 && (uintptr_t)A % 16 == 0 &&
        (uintptr_t)invBT % 16 == 0 && stages >= 2 &&
        stages <= lps::kMaxStages && stage_floats >= 4 &&
        stage_floats % 4 == 0 && warp_stages >= 1 &&
        warp_stages <= lps::kMaxWarpStages && chunk_floats >= 4 &&
        chunk_floats % 4 == 0 && (chunk_floats >= m || chunk_floats % 32 == 0);
    if (!ok) return (int)cudaErrorInvalidValue;
    const size_t block_view = (size_t)stages * stage_floats;
    const size_t warp_view = (size_t)lp::kWarps * warp_stages * chunk_floats;
    ring = block_view > warp_view ? block_view : warp_view;
  }
  const size_t need =
      (lpl::vector_floats(m, n, cluster, pricing == 2) + ring) * sizeof(float);
  if (smem_bytes < 0 || (size_t)smem_bytes < need ||
      (size_t)smem_bytes + lpl::kStatic > lps::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const lpl::Args args{A, c, apen, invBT, bfs, cB, basis, pen, gamma, iters,
                       status, m, n, seg_len, maxiters, opt_tol, pivot_tol,
                       feas_tol, dual, pricing, packed, stall_limit, split,
                       ablate, stages, stage_floats, warp_stages,
                       chunk_floats};
  const cudaStream_t s = (cudaStream_t)stream;
#define LP_LAUNCH(CL, RING)                                       \
  if (cluster == CL && (aligned != 0) == RING)                    \
    return lpl::launch_##CL##_##RING(args, B, (size_t)smem_bytes, s);
  LP_LARGE_RING_BUILDS(LP_LAUNCH)
  LP_LARGE_SCALAR_BUILDS(LP_LAUNCH)
#undef LP_LAUNCH
  return (int)cudaErrorInvalidValue;
}
