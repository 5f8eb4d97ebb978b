// Whole-segment bounded-variable simplex (min c'x, Ax = b, lb <= x <= ub):
// up to seg_len iterations per lane in one launch, the lane's state updated
// in place.
//
// Replaces linprog_tpu/ops/bounded_kernel.py :: solve_bounded_segment
// (Pallas, body _bounded_kernel). Two branches, chosen by the lane's shape
// (m, n) alone (ops/bounded_kernel.py :: segment_plans):
//
// CLUSTER-RESIDENT (A and invBT fit a cluster of at most 16 CTAs), in the
// design of solve_segment.cu. One lane runs on a cluster of CL CTAs; each CTA
// loads its whole row bands of A and of invBT into shared memory once
// (cluster_segment.cuh), keeps the lane's O(m + n) vectors whole, and the
// segment runs on chip with two cluster barriers an iteration:
//   [partial of y A] (a) [rc of every column from the CTAs' partials; the
//   entering column; partial of the direction] (c) [d from the partials;
//   the three-way ratio test over whole vectors; bfs; a pivot's eta update
//   of own rows, which yields the next duals; states]
// Every CTA runs the same selections on the same whole vectors, so they
// agree without exchanging them. The bits do not depend on the cluster size
// (fixed row bands, one tree).
//
// STREAMING (lanes past the largest cluster), in the design of
// solve_segment_stream.cu, whose row-split primitives it shares
// (stream_ring.cuh). A lane's A[m, n] and invBT stay in device memory, and
// each pivot moves A once and invBT three times (the direction reads it, the
// eta pass reads and writes it): 32.8 MB a lane at m = 1280, n = 2560, so
// the branch is bound by device-memory bandwidth, and one block per lane
// (16 of 132 SMs at B = 16) cannot draw it. So one cluster of CL CTAs runs a
// lane:
//   * CTA k owns contiguous whole bands of the lane's 8 fixed row bands of
//     ceil(m / 8) rows: those rows of A and invBT, and with them its entries
//     of y, bfs, lbB, ubB and the basis. c_B is kept whole in every CTA (the
//     eta pass sums over it). Each CTA also owns a slice of the columns:
//     c, lb, ub, the reduced costs and the variable states of that slice.
//   * Pricing sum_own y_j A[j, k] and the direction sum_own a[j] invBT[j, i]
//     are partials over the CTA's rows for every column, added through
//     distributed shared memory as one fixed tree over the 8 band totals:
//     a lane gets the same bits at every cluster size and on both load
//     branches. The direction sums with fused multiply-adds (as the
//     cluster-resident branch and the plain version's library GEMV do);
//     every other product rounds first (--fmad=false).
//   * The entering column is a per-CTA selection over its column slice
//     (packed key, or value and lowest index), combined in rank order; its
//     state, bounds and cost are read from their owner. The three-way ratio
//     test is two per-CTA selections over own rows (g1: a basic variable
//     drops to its lower bound; g2: it rises to its upper bound), combined
//     in rank order; each partial carries its local winner's basis entry
//     and, in packed mode, the exact ratio there, so the step length is
//     re-read at the chosen row.
//   * A pivot rewrites the CTA's rows of invBT in one eta pass, which also
//     yields the next duals of those rows (after c_B[leave] = c_enter); only
//     a launch's first iteration reads the factor for the duals alone. A
//     bound flip leaves the factor and c_B, and so the duals, as they are.
//   * Aligned shapes (m, n multiples of 4, 16-byte pointers) stream every
//     pass through a ring in shared memory filled by cp.async.bulk copies
//     on mbarriers; other shapes take ld.global.cg loads in the same kernel,
//     summed in the same order.
// Four cluster barriers an iteration separate the phases that read another
// CTA's shared memory:
//   [y own rows: first iteration only; partial of y A] (a) [rc of own
//   columns; entering partial] (b) [the entering column, read from its
//   owner; partial of the direction] (c) [d of own rows; the two ratio
//   partials] (d) [the ratio test; bfs of own rows; a pivot: gather d, the
//   eta pass of own rows with the next y; states of own rows and columns]
// Every CTA reduces the same partials in the same order, so all agree on
// every decision and take the same number of iterations. The launch plan
// (cluster size, ring, load branch) is ops/bounded_kernel.py ::
// segment_plans.
//
// Semantics follow the Pallas kernel and the plain PyTorch version
// (linprog_tpu_torch/ops/bounded_kernel.py): Dantzig pricing on the
// bound-aware reduced costs with the absolute opt_tol, no stall escalation;
// the rooms bfs - lbB and ubB - bfs clamp to +0.0; infinite bounds pass
// through (gamma3 = ub_e - lb_e may be inf; the step length is selected,
// never multiplied by a flag); packed mode compares the two ratio KEYS to
// pick the bound the leaving variable lands on and re-reads the step length
// exactly at the chosen row, unpacked mode compares the two values; a flip
// counts as an iteration; a lane that is not RUNNING is untouched. The
// variable states are int8 in device memory and ints in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_segment.cuh"
#include "common.cuh"
#include "stream_ring.cuh"

namespace {

using lp::bits_for;
using lp::block_min;
using lp::block_min2;
using lp::kIntMax;
using lp::kOptimal;
using lp::kPrimalUnbounded;
using lp::kRunning;
using lp::kThreads;
using lp::nan_min;
using lp::nonneg;
using lp::pack_key;
using lp::Scratch;

constexpr int kAtLb = 0, kAtUb = 1, kBasic = 2;

// The two ratio rows at basis position i: g1 (the basic variable drops to
// its lower bound) and g2 (it rises to its upper bound); inf where the
// direction does not move it that way.
__device__ __forceinline__ float2 ratios(float sigma, float d, float bfs,
                                         float lbB, float ubB,
                                         float pivot_tol) {
  const float sd = sigma * d;
  const float g1 = sd > pivot_tol ? nonneg(bfs - lbB) / sd : INFINITY;
  const float g2 = -sd > pivot_tol ? nonneg(ubB - bfs) / -sd : INFINITY;
  return make_float2(g1, g2);
}

namespace cg = cooperative_groups;

// ===== streaming branch =====================================================

// CTAs an SM every instantiation of the streaming branch is built for (its
// register cap): a plan may put one or two on an SM by its ring.
constexpr int kStreamCtas = 2;

// Floats of one CTA's vectors on the streaming branch at `cl` CTAs a lane:
// d, u and c_B whole; the CTA's partial of y A over n columns, which the
// partial of the direction over m reuses; seven slices of m (y, the entering
// column, invBT's column at the leaving row, bfs, lbB, ubB, the basis) and
// five of n (c, lb, ub, the reduced costs, the variable states as ints).
__host__ __device__ size_t stream_vector_floats(int m, int n, int cl) {
  constexpr int kB = lps::kBands;
  const size_t ml = (size_t)(kB / cl) * ((m + kB - 1) / kB);
  const size_t nl = (size_t)(kB / cl) * ((n + kB - 1) / kB);
  const size_t part = (size_t)(n > m ? n : m);
  return lpc::round4(3 * (size_t)m + part + 7 * ml + 5 * nl);
}

// The entering column, broadcast by thread 0 after (b).
struct Enter {
  int enter, eligible, vs_enter;
  float lb_e, ub_e, c_e;
};

// The ratio test's outcome, broadcast by thread 0 after (d).
struct Leave {
  int leave, to_lb, leaving_col;
  float delta;
};

template <int CL, bool RING>
__global__ void __launch_bounds__(kThreads, kStreamCtas)
    solve_bounded_stream_kernel(
        const float* __restrict__ A_all, const float* __restrict__ c_all,
        const float* __restrict__ lb_all, const float* __restrict__ ub_all,
        float* invBT_all, float* bfs_all, float* cB_all, int* basis_all,
        signed char* vstate_all, float* lbB_all, float* ubB_all,
        int* iters_all, int* status_all, int m, int n, int seg_len,
        int maxiters, float opt_tol, float pivot_tol, int packed, int stages,
        int stage_floats, int warp_stages, int chunk_floats) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x / CL;
  int status = status_all[lane];
  int iters = iters_all[lane];
  // a lane that may not act is left untouched: every CTA of its cluster
  // reads the same status and leaves before any cluster barrier
  if (seg_len <= 0 || status != kRunning || iters >= maxiters) return;

  extern __shared__ __align__(16) float smem[];
  __shared__ Scratch red;
  __shared__ lps::Part s_part[3];  // [0] entering, [1] g1, [2] g2
  __shared__ Enter s_enter;
  __shared__ Leave s_leave;
  __shared__ __align__(8) unsigned long long s_bbar[lps::kMaxStages];
  __shared__ __align__(8) unsigned long long s_ebar[lps::kMaxStages];
  __shared__ __align__(8) unsigned long long
      s_wbar[lp::kWarps * lps::kMaxWarpStages];

  constexpr int NB = lps::kBands / CL;  // row bands of one CTA
  const lps::Range rows = lps::slice_of<CL>(rank, m);  // own rows
  const lps::Range cols = lps::slice_of<CL>(rank, n);  // own columns
  const int nrows = rows.hi - rows.lo;
  const int ml = lps::slice_len<CL>(m), nl = lps::slice_len<CL>(n);
  const int band = ml / NB;  // rows of a band
  const float* A = A_all + lane * m * n;
  float* invBT = invBT_all + lane * m * m;
  const float* A_own = A + (size_t)rows.lo * n;
  float* invBT_own = invBT + (size_t)rows.lo * m;

  // whole vectors (indexed globally)
  float* s_d = smem;       // d; own slice reduced here, the rest gathered
  float* s_u = s_d + m;    // the eta vector
  float* s_cB = s_u + m;   // c_B, an identical copy in every CTA
  float* s_pp = s_cB + m;  // the CTA's partial of y A, then of the direction
  // own rows (indexed from rows.lo)
  float* s_y = s_pp + (n > m ? n : m);
  float* s_col = s_y + ml;     // entering column
  float* s_colL = s_col + ml;  // invBT[j, leave]
  float* s_bfs = s_colL + ml;
  float* s_lbB = s_bfs + ml;
  float* s_ubB = s_lbB + ml;
  int* s_basis = reinterpret_cast<int*>(s_ubB + ml);
  // own columns (indexed from cols.lo)
  float* s_c = reinterpret_cast<float*>(s_basis + ml);
  float* s_lb = s_c + nl;
  float* s_ub = s_lb + nl;
  float* s_rc = s_ub + nl;
  int* s_vs = reinterpret_cast<int*>(s_rc + nl);

  lps::Pipe pp;
  pp.ring = smem + stream_vector_floats(m, n, CL);
  pp.bbar = s_bbar;
  pp.ebar = s_ebar;
  pp.wbar = s_wbar;
  pp.bphase = pp.wphase = 0u;
  pp.S = stages;
  pp.stage_floats = stage_floats;
  pp.D = warp_stages;
  pp.C = chunk_floats;
  if (RING && tid == 0) {
    for (int s = 0; s < lps::kMaxStages; ++s) {
      lps::mbar_init(s_bbar + s, 1);
      lps::mbar_init(s_ebar + s, lp::kWarps);
    }
    for (int s = 0; s < lp::kWarps * lps::kMaxWarpStages; ++s)
      lps::mbar_init(s_wbar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  for (int i = tid; i < m; i += kThreads) s_cB[i] = cB_all[lane * m + i];
  for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
    s_bfs[i - rows.lo] = bfs_all[lane * m + i];
    s_lbB[i - rows.lo] = lbB_all[lane * m + i];
    s_ubB[i - rows.lo] = ubB_all[lane * m + i];
    s_basis[i - rows.lo] = basis_all[lane * m + i];
  }
  for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
    s_c[k - cols.lo] = c_all[lane * n + k];
    s_lb[k - cols.lo] = lb_all[lane * n + k];
    s_ub[k - cols.lo] = ub_all[lane * n + k];
    s_vs[k - cols.lo] = vstate_all[lane * n + k];
  }
  __syncthreads();

  const int bits_n = bits_for(n), bits_m = bits_for(m);
  const int lo_n = (1 << bits_n) - 1, lo_m = (1 << bits_m) - 1;

  for (int seg = 0; seg < seg_len && status == kRunning && iters < maxiters;
       ++seg) {
    // ---- duals of own rows (later: from the eta pass of each pivot; a
    // bound flip changes neither c_B nor the factor) -----------------------
    if (seg == 0) {
      lps::row_pass<RING, false>(invBT, s_cB, nullptr, nullptr, s_y, m, rows,
                                 pp);
      __syncthreads();
    }

    // ---- bound-aware pricing: partial of y A over own rows, then rc of own
    // columns (z - c at a lower bound, c - z at an upper) -----------------
    lps::col_pass<RING, 1, false, NB>(A_own, n, n, nrows, band, s_y, nullptr,
                                      s_pp, nullptr, pp);
    cl.sync();  // (a)
    {
      // the entering partial: the largest rc above opt_tol (packed), or
      // the max of rc as the min of -rc and its lowest index (unpacked)
      int key = kIntMax, hot = n;
      float val = INFINITY;
      for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
        const float zc = lps::tree_sum<0, CL>(cl, s_pp, k) - s_c[k - cols.lo];
        const int vs = s_vs[k - cols.lo];
        const float rc = vs == kBasic ? -INFINITY : (vs == kAtUb ? -zc : zc);
        s_rc[k - cols.lo] = rc;
        if (packed) {
          if (rc > opt_tol) key = min(key, pack_key(-rc, k, bits_n, true));
        } else {
          val = nan_min(val, -rc);
        }
      }
      if (packed) {
        key = block_min2(key, kIntMax, red).x;
      } else {
        val = block_min(val, red);
        for (int k = cols.lo + tid; k < cols.hi; k += kThreads)
          if (-s_rc[k - cols.lo] == val) hot = min(hot, k);
        hot = block_min2(hot, kIntMax, red).x;
      }
      if (tid == 0) s_part[0] = lps::Part{key, n, hot, 0, val, 0.0f};
    }
    cl.sync();  // (b)
    if (tid == 0) {
      const lps::Sel s = lps::combine<CL>(cl, &s_part[0], n);
      Enter e;
      if (packed) {
        e.eligible = s.key != kIntMax;
        e.enter = e.eligible ? (s.key & lo_n) : 0;
      } else {
        e.eligible = -s.val > opt_tol;
        e.enter = e.eligible ? s.hot : 0;
      }
      // the owner changes its states only after (d)
      const int o = lps::owner_of<CL>(e.enter, n);
      const int off = e.enter - lps::slice_of<CL>(o, n).lo;
      e.vs_enter = cl.map_shared_rank(s_vs, o)[off];
      e.lb_e = cl.map_shared_rank(s_lb, o)[off];
      e.ub_e = cl.map_shared_rank(s_ub, o)[off];
      e.c_e = cl.map_shared_rank(s_c, o)[off];
      s_enter = e;
    }
    __syncthreads();
    const int enter = s_enter.enter;
    const bool eligible = s_enter.eligible != 0;
    const int vs_enter = s_enter.vs_enter;
    // scalars read as the reference's masked sums read them (-0.0 -> +0.0,
    // inf passes through)
    const float lb_e = s_enter.lb_e + 0.0f;
    const float ub_e = s_enter.ub_e + 0.0f;
    const float c_e = s_enter.c_e + 0.0f;
    const float sigma = vs_enter == kAtLb ? 1.0f : -1.0f;

    // ---- direction: partial over own rows, then d of own rows ------------
    for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
      s_col[j - rows.lo] = __ldg(A + (size_t)j * n + enter);
    __syncthreads();
    lps::col_pass<RING, 1, true, NB>(invBT_own, m, m, nrows, band, s_col,
                                     nullptr, s_pp, nullptr, pp);
    cl.sync();  // (c)
    lps::reduce_slice<CL>(cl, s_pp, s_d + rows.lo, rows);
    __syncthreads();

    // ---- the two ratio partials over own rows ----------------------------
    {
      lps::Part q1{kIntMax, m, m, 0, INFINITY, 0.0f};
      lps::Part q2 = q1;
      if (packed) {
        int k1 = kIntMax, k2 = kIntMax;
        for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
          const int r = i - rows.lo;
          const float sd = sigma * s_d[i];
          const float2 g =
              ratios(sigma, s_d[i], s_bfs[r], s_lbB[r], s_ubB[r], pivot_tol);
          if (sd > pivot_tol) k1 = min(k1, pack_key(g.x, i, bits_m, false));
          if (-sd > pivot_tol) k2 = min(k2, pack_key(g.y, i, bits_m, false));
        }
        const int2 km = block_min2(k1, k2, red);
        q1.key = km.x;
        q2.key = km.y;
        if (tid == 0) {
          // the local winners' basis entries and exact step lengths
          if (km.x != kIntMax) {
            const int w = (km.x & lo_m) - rows.lo;
            q1.basis = s_basis[w];
            q1.bfs = ratios(sigma, s_d[rows.lo + w], s_bfs[w], s_lbB[w],
                            s_ubB[w], pivot_tol).x;
          }
          if (km.y != kIntMax) {
            const int w = (km.y & lo_m) - rows.lo;
            q2.basis = s_basis[w];
            q2.bfs = ratios(sigma, s_d[rows.lo + w], s_bfs[w], s_lbB[w],
                            s_ubB[w], pivot_tol).y;
          }
        }
      } else {
        float p1 = INFINITY, p2 = INFINITY;
        for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
          const int r = i - rows.lo;
          const float2 g =
              ratios(sigma, s_d[i], s_bfs[r], s_lbB[r], s_ubB[r], pivot_tol);
          p1 = nan_min(p1, g.x);
          p2 = nan_min(p2, g.y);
        }
        q1.val = block_min(p1, red);
        q2.val = block_min(p2, red);
        int l1 = m, l2 = m;
        for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
          const int r = i - rows.lo;
          const float2 g =
              ratios(sigma, s_d[i], s_bfs[r], s_lbB[r], s_ubB[r], pivot_tol);
          if (g.x == q1.val) l1 = min(l1, i);
          if (g.y == q2.val) l2 = min(l2, i);
        }
        const int2 lm = block_min2(l1, l2, red);
        q1.hot = lm.x;
        q2.hot = lm.y;
        if (tid == 0) {
          if (lm.x < m) q1.basis = s_basis[lm.x - rows.lo];
          if (lm.y < m) q2.basis = s_basis[lm.y - rows.lo];
        }
      }
      if (tid == 0) {
        s_part[1] = q1;
        s_part[2] = q2;
      }
    }
    cl.sync();  // (d)
    if (tid == 0) {
      const lps::Sel s1 = lps::combine<CL>(cl, &s_part[1], m);
      const lps::Sel s2 = lps::combine<CL>(cl, &s_part[2], m);
      Leave v;
      bool keyed = false;  // packed mode with an eligible row
      if (packed) {
        v.to_lb = s1.key < s2.key;
        const int ksel = min(s1.key, s2.key);
        v.leave = ksel & lo_m;
        v.delta = INFINITY;
        keyed = ksel != kIntMax;
      } else {
        v.delta = nan_min(s1.val, s2.val);
        v.to_lb = s1.val < s2.val;
        v.leave = v.to_lb ? s1.hot : s2.hot;
      }
      v.leaving_col = 0;
      if (v.leave < m) {
        // the owner's partial: its local winner is the chosen row
        const lps::Part w = *cl.map_shared_rank(
            &s_part[v.to_lb ? 1 : 2], lps::owner_of<CL>(v.leave, m));
        v.leaving_col = w.basis;
        // the step length exactly at the chosen row, not the key's
        // truncated mantissa
        if (keyed) v.delta = w.bfs + 0.0f;
      }
      s_leave = v;
    }
    __syncthreads();
    int leave = s_leave.leave;
    const bool leave_to_lb = s_leave.to_lb != 0;
    const int leaving_col = s_leave.leaving_col;
    const float delta = s_leave.delta;
    const float gamma3 = ub_e - lb_e;

    const bool unbounded = eligible && isinf(delta) && isinf(gamma3);
    const bool traverse = gamma3 <= delta;
    const bool flip = eligible && !unbounded && traverse;
    const bool piv = eligible && !unbounded && !traverse;
    if (!piv) leave = 0;
    // with a NaN ratio no row equals the minimum (leave == m): then no slot
    // is seated, as the reference's all-false row mask does
    const bool seat = piv && leave < m;
    const int row_l = min(leave, m - 1);
    const float step_len = flip ? gamma3 : (piv ? delta : 0.0f);
    const float enter_val = (sigma > 0.0f ? lb_e : ub_e) + sigma * delta;

    // ---- incremental bfs of own rows: every basic moves by -step * sd; a
    // pivot then seats the entering variable's value in the leaving slot
    for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
      const float moved = s_bfs[i - rows.lo] - step_len * (sigma * s_d[i]);
      s_bfs[i - rows.lo] = (seat && i == leave) ? enter_val : moved;
    }
    if (piv) {
      // ---- eta update of own rows, which yields the next duals ----------
      lps::gather<CL>(cl, s_d, m, rank);
      __syncthreads();
      const float d_l = leave < m ? s_d[leave] + 0.0f : 0.0f;
      const float safe = d_l == 0.0f ? 1.0f : d_l;
      for (int i = tid; i < m; i += kThreads)
        s_u[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
      for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
        s_colL[j - rows.lo] = lps::ldcg(invBT + (size_t)j * m + row_l);
      // c_B of the new basis: the eta pass's dot products are the next duals
      if (tid == 0 && seat) s_cB[leave] = c_e;
      __syncthreads();
      lps::row_pass<RING, true>(invBT, s_cB, s_u, s_colL, s_y, m, rows, pp);
      // the rows this CTA wrote are next read by its own bulk copies: order
      // the generic-proxy writes before them (a block barrier follows)
      if (RING) lps::fence_proxy_async();
      if (tid == 0) {
        if (seat && leave >= rows.lo && leave < rows.hi) {
          s_basis[leave - rows.lo] = enter;
          s_lbB[leave - rows.lo] = lb_e;
          s_ubB[leave - rows.lo] = ub_e;
        }
        if (enter >= cols.lo && enter < cols.hi)
          s_vs[enter - cols.lo] = kBasic;
        if (leaving_col >= cols.lo && leaving_col < cols.hi)
          s_vs[leaving_col - cols.lo] = leave_to_lb ? kAtLb : kAtUb;
      }
    } else if (flip && tid == 0 && enter >= cols.lo && enter < cols.hi) {
      s_vs[enter - cols.lo] = 1 - vs_enter;
    }
    status = !eligible ? kOptimal : (unbounded ? kPrimalUnbounded : kRunning);
    iters += 1;
    __syncthreads();
  }

  for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
    bfs_all[lane * m + i] = s_bfs[i - rows.lo];
    cB_all[lane * m + i] = s_cB[i];
    lbB_all[lane * m + i] = s_lbB[i - rows.lo];
    ubB_all[lane * m + i] = s_ubB[i - rows.lo];
    basis_all[lane * m + i] = s_basis[i - rows.lo];
  }
  for (int k = cols.lo + tid; k < cols.hi; k += kThreads)
    vstate_all[lane * n + k] = (signed char)s_vs[k - cols.lo];
  if (rank == 0 && tid == 0) {
    status_all[lane] = status;
    iters_all[lane] = iters;
  }
  cl.sync();  // no CTA exits while another may read its shared memory
}

// Static shared memory of the streaming kernel, with a reserve.
constexpr size_t kStreamStatic =
    sizeof(Scratch) + 3 * sizeof(lps::Part) + sizeof(Enter) + sizeof(Leave) +
    8 * (2 * lps::kMaxStages + lp::kWarps * lps::kMaxWarpStages) + 64;

// (cluster, ring) instantiations of the streaming branch: what the plans
// launch (ops/bounded_kernel.py :: STREAM_CLUSTERS), on both load branches.
#define LP_STREAM_SIZES(X) X(4, true) X(8, true) X(4, false) X(8, false)

__host__ bool stream_built(int cluster) {
  return cluster == 4 || cluster == 8;
}


// ===== cluster-resident branch ==============================================

using lpc::Pick;

// Floats of one CTA's dynamic shared memory at `cl` CTAs a lane before the
// variable states: its rows of A and of invBT; d, u, c_B, bfs, lbB, ubB and
// the basis whole; c, lb and ub whole; the CTA's partials over n (pricing)
// and over m (the direction); three slices of m.
__host__ __device__ size_t cluster_floats(int m, int n, int cl) {
  const size_t ml = (size_t)(lpc::kBands / cl) * ((m + lpc::kBands - 1) / lpc::kBands);
  return lpc::round4(ml * n) + lpc::round4(ml * m) +
         lpc::round4(8 * (size_t)m + 4 * (size_t)n + 3 * ml);
}

// Bytes of it: the floats, then the variable states whole as int8.
size_t cluster_bytes(int m, int n, int cl) {
  return cluster_floats(m, n, cl) * sizeof(float) + ((size_t)n + 15) / 16 * 16;
}

template <int CL>
__global__ void __launch_bounds__(lpc::kThreads, 1) solve_bounded_cluster_kernel(
    const float* __restrict__ A_all, const float* __restrict__ c_all,
    const float* __restrict__ lb_all, const float* __restrict__ ub_all,
    float* invBT_all, float* bfs_all, float* cB_all, int* basis_all,
    signed char* vstate_all, float* lbB_all, float* ubB_all, int* iters_all,
    int* status_all, int m, int n, int seg_len, int maxiters, float opt_tol,
    float pivot_tol, int packed, int aligned) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x / CL;
  int status = status_all[lane];
  int iters = iters_all[lane];
  // a lane that may not act is left untouched: every CTA of its cluster
  // reads the same status and leaves before any cluster barrier
  if (seg_len <= 0 || status != kRunning || iters >= maxiters) return;

  extern __shared__ __align__(16) float smem[];
  __shared__ lpc::PickScratch ps;
  __shared__ __align__(8) unsigned long long s_bar;

  constexpr int NB = lpc::kBands / CL;  // row bands of one CTA
  const lpc::Range rows = lpc::slice_of<CL>(rank, m);  // own rows
  const lpc::Range cols = lpc::slice_of<CL>(rank, n);  // entries written back
  const int nrows = rows.hi - rows.lo;
  const int ml = lpc::slice_len<CL>(m);
  const int band = lpc::band_len(m);
  const float* A = A_all + lane * m * n;
  float* invBT = invBT_all + lane * m * m;

  float* sA = smem;                               // own rows of A
  float* sB = sA + lpc::round4((size_t)ml * n);   // own rows of invBT
  // whole vectors, identical in every CTA
  float* s_d = sB + lpc::round4((size_t)ml * m);  // the direction
  float* s_u = s_d + m;    // the eta vector
  float* s_cB = s_u + m;
  float* s_bfs = s_cB + m;
  float* s_lbB = s_bfs + m;
  float* s_ubB = s_lbB + m;
  int* s_basis = reinterpret_cast<int*>(s_ubB + m);
  float* s_c = reinterpret_cast<float*>(s_basis + m);
  float* s_lb = s_c + n;
  float* s_ub = s_lb + n;
  // the CTA's partials, read by every CTA of the cluster
  float* s_p1 = s_ub + n;  // of y A
  float* s_p2 = s_p1 + n;  // of the direction
  // own rows
  float* s_y = s_p2 + m;
  float* s_col = s_y + ml;     // entering column, own rows
  float* s_colL = s_col + ml;  // invBT[j, leave], own rows
  // the variable states, whole
  signed char* s_vs =
      reinterpret_cast<signed char*>(smem + cluster_floats(m, n, CL));

  if (tid == 0) {
    lpc::mbar_init(&s_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  lpc::load_resident(sA, A + (size_t)rows.lo * n, nrows * n, sB,
                     invBT + (size_t)rows.lo * m, nrows * m, aligned != 0,
                     &s_bar);
  for (int i = tid; i < m; i += lpc::kThreads) {
    s_cB[i] = cB_all[lane * m + i];
    s_bfs[i] = bfs_all[lane * m + i];
    s_lbB[i] = lbB_all[lane * m + i];
    s_ubB[i] = ubB_all[lane * m + i];
    s_basis[i] = basis_all[lane * m + i];
  }
  for (int k = tid; k < n; k += lpc::kThreads) {
    s_c[k] = c_all[lane * n + k];
    s_lb[k] = lb_all[lane * n + k];
    s_ub[k] = ub_all[lane * n + k];
    s_vs[k] = vstate_all[lane * n + k];
  }
  __syncthreads();

  const int bits_n = bits_for(n), bits_m = bits_for(m);
  const int lo_n = (1 << bits_n) - 1, lo_m = (1 << bits_m) - 1;
  // entry k of a product: the CTAs' partials added in the band tree
  auto sum = [&](float* part, int k) {
    return lpc::tree_sum<0, CL>(cl, part, k);
  };

  cl.sync();  // every CTA of the cluster runs
  for (int seg = 0; seg < seg_len && status == kRunning && iters < maxiters;
       ++seg) {
    // ---- duals of own rows (later: from the eta pass of each pivot; a
    // bound flip changes neither c_B nor the factor) -----------------------
    if (seg == 0) {
      lpc::row_pass<false>(sB, s_cB, nullptr, nullptr, s_y, m, nrows);
      __syncthreads();
    }

    // ---- bound-aware pricing: z - c at a lower bound, c - z at an upper;
    // the entering column is the largest rc above opt_tol -----------------
    lpc::col_pass<1, false, NB, 2>(sA, n, n, nrows, band, s_y, nullptr, s_p1,
                                   nullptr);
    cl.sync();  // (a)
    Pick p = lpc::pick_init(n);
    for (int k = tid; k < n; k += lpc::kThreads) {
      const float zc = sum(s_p1, k) - s_c[k];
      const int vs = s_vs[k];
      const float rc = vs == kBasic ? -INFINITY : (vs == kAtUb ? -zc : zc);
      if (packed) {
        if (rc > opt_tol) p.key = min(p.key, pack_key(-rc, k, bits_n, true));
      } else {
        lpc::amin(p, -rc, k, n);  // the max of rc as the min of -rc
      }
    }
    p = lpc::block_pick(p, n, ps);
    bool eligible;
    int enter;
    if (packed) {
      eligible = p.key != kIntMax;
      enter = eligible ? (p.key & lo_n) : 0;
    } else {
      eligible = -p.v > opt_tol;
      enter = eligible ? p.i : 0;
    }
    // scalars read as the reference's masked sums read them (-0.0 -> +0.0,
    // inf passes through)
    const int vs_enter = s_vs[enter];
    const float lb_e = s_lb[enter] + 0.0f;
    const float ub_e = s_ub[enter] + 0.0f;
    const float c_e = s_c[enter] + 0.0f;
    const float sigma = vs_enter == kAtLb ? 1.0f : -1.0f;

    // ---- direction: partial over own rows, then all of d ----------------
    for (int j = tid; j < nrows; j += lpc::kThreads)
      s_col[j] = sA[(size_t)j * n + enter];
    __syncthreads();
    lpc::col_pass<1, true, NB, 1>(sB, m, m, nrows, band, s_col, nullptr, s_p2,
                                  nullptr);
    cl.sync();  // (c)
    for (int i = tid; i < m; i += lpc::kThreads) s_d[i] = sum(s_p2, i);
    __syncthreads();

    // ---- three-way ratio test ---------------------------------------------
    const float gamma3 = ub_e - lb_e;
    float delta;
    bool leave_to_lb;
    int leave;
    if (packed) {
      // the key of the second ratio row rides in `first`: both are
      // integer minima
      Pick g = lpc::pick_init(kIntMax);
      for (int i = tid; i < m; i += lpc::kThreads) {
        const float sd = sigma * s_d[i];
        const float2 r =
            ratios(sigma, s_d[i], s_bfs[i], s_lbB[i], s_ubB[i], pivot_tol);
        if (sd > pivot_tol) g.key = min(g.key, pack_key(r.x, i, bits_m, false));
        if (-sd > pivot_tol)
          g.first = min(g.first, pack_key(r.y, i, bits_m, false));
      }
      g = lpc::block_pick(g, kIntMax, ps);
      const int k1 = g.key, k2 = g.first;
      leave_to_lb = k1 < k2;
      const int ksel = min(k1, k2);
      leave = ksel & lo_m;
      delta = INFINITY;
      if (ksel != kIntMax) {
        // the step length exactly at the chosen row, not the key's
        // truncated mantissa
        const float2 r = ratios(sigma, s_d[leave], s_bfs[leave], s_lbB[leave],
                                s_ubB[leave], pivot_tol);
        delta = (leave_to_lb ? r.x : r.y) + 0.0f;
      }
    } else {
      Pick g1 = lpc::pick_init(m), g2 = lpc::pick_init(m);
      for (int i = tid; i < m; i += lpc::kThreads) {
        const float2 g =
            ratios(sigma, s_d[i], s_bfs[i], s_lbB[i], s_ubB[i], pivot_tol);
        lpc::amin(g1, g.x, i, m);
        lpc::amin(g2, g.y, i, m);
      }
      g1 = lpc::block_pick(g1, m, ps);
      g2 = lpc::block_pick(g2, m, ps);
      delta = nan_min(g1.v, g2.v);
      leave_to_lb = g1.v < g2.v;
      leave = leave_to_lb ? g1.i : g2.i;
    }

    const bool unbounded = eligible && isinf(delta) && isinf(gamma3);
    const bool traverse = gamma3 <= delta;
    const bool flip = eligible && !unbounded && traverse;
    const bool piv = eligible && !unbounded && !traverse;
    if (!piv) leave = 0;
    // with a NaN ratio no row equals the minimum (leave == m): then no slot
    // is seated, as the reference's all-false row mask does
    const bool seat = piv && leave < m;
    const int row_l = min(leave, m - 1);
    const float d_l = leave < m ? s_d[leave] + 0.0f : 0.0f;
    const int leaving_col = leave < m ? s_basis[leave] : 0;
    const float step_len = flip ? gamma3 : (piv ? delta : 0.0f);
    const float enter_val = (sigma > 0.0f ? lb_e : ub_e) + sigma * delta;
    const float safe = d_l == 0.0f ? 1.0f : d_l;
    __syncthreads();  // every thread has read its scalars

    // ---- incremental bfs: every basic moves by -step * sd; a pivot then
    // seats the entering variable's value in the leaving slot
    for (int i = tid; i < m; i += lpc::kThreads) {
      const float moved = s_bfs[i] - step_len * (sigma * s_d[i]);
      s_bfs[i] = (seat && i == leave) ? enter_val : moved;
    }
    if (piv) {
      // ---- eta update of own rows, which yields the next duals ----------
      for (int i = tid; i < m; i += lpc::kThreads)
        s_u[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
      for (int j = tid; j < nrows; j += lpc::kThreads)
        s_colL[j] = sB[(size_t)j * m + row_l];
      // c_B of the new basis: the eta pass's dot products are the next duals
      if (tid == 0 && seat) s_cB[leave] = c_e;
      __syncthreads();
      lpc::row_pass<true>(sB, s_cB, s_u, s_colL, s_y, m, nrows);
      if (tid == 0) {
        if (seat) {
          s_basis[leave] = enter;
          s_lbB[leave] = lb_e;
          s_ubB[leave] = ub_e;
        }
        s_vs[enter] = kBasic;
        s_vs[leaving_col] = leave_to_lb ? kAtLb : kAtUb;
      }
    } else if (flip && tid == 0) {
      s_vs[enter] = (signed char)(1 - vs_enter);
    }
    status = !eligible ? kOptimal : (unbounded ? kPrimalUnbounded : kRunning);
    iters += 1;
    __syncthreads();
  }

  lpc::store_rows(invBT + (size_t)rows.lo * m, sB, nrows * m, aligned != 0);
  for (int i = rows.lo + tid; i < rows.hi; i += lpc::kThreads) {
    bfs_all[lane * m + i] = s_bfs[i];
    cB_all[lane * m + i] = s_cB[i];
    lbB_all[lane * m + i] = s_lbB[i];
    ubB_all[lane * m + i] = s_ubB[i];
    basis_all[lane * m + i] = s_basis[i];
  }
  for (int k = cols.lo + tid; k < cols.hi; k += lpc::kThreads)
    vstate_all[lane * n + k] = (signed char)s_vs[k];
  if (rank == 0 && tid == 0) {
    status_all[lane] = status;
    iters_all[lane] = iters;
  }
  cl.sync();  // no CTA exits while another may read its shared memory
}

// Static shared memory of the cluster kernel, with a reserve.
constexpr size_t kClusterStatic = sizeof(lpc::PickScratch) + 64;

#define LP_CLUSTER_SIZES(X) X(1) X(2) X(4) X(8) X(16)

}  // namespace

// How many clusters of `cluster` CTAs with `smem_bytes` of dynamic shared
// memory each the device holds at once on the cluster-resident branch; < 0
// is a negated CUDA error.
extern "C" int lp_solve_bounded_cluster_max_clusters(int cluster,
                                                     int smem_bytes) {
  if (smem_bytes < 0 || !lpc::cluster_built(cluster))
    return -(int)cudaErrorInvalidValue;
#define LP_MAX(CL) \
  if (cluster == CL) \
    return lpc::max_clusters(solve_bounded_cluster_kernel<CL>, CL, (size_t)smem_bytes);
  LP_CLUSTER_SIZES(LP_MAX)
#undef LP_MAX
  return -(int)cudaErrorInvalidValue;
}

// The cluster-resident branch under a launch plan (cluster, aligned,
// smem_bytes) from ops/bounded_kernel.py :: segment_plans, checked here
// against the shape before anything is launched.
extern "C" int lp_solve_bounded_cluster(
    const float* A, const float* c, const float* lb, const float* ub,
    float* invBT, float* bfs, float* cB, int* basis, signed char* vstate,
    float* lbB, float* ubB, int* iters, int* status, int B, int m, int n,
    int seg_len, int maxiters, float opt_tol, float pivot_tol, int packed,
    int cluster, int aligned, int smem_bytes, void* stream) {
  if (m < 1 || n < 1 || B < 1 || !lpc::cluster_built(cluster))
    return (int)cudaErrorInvalidValue;
  if (aligned && !(m % 4 == 0 && n % 4 == 0 && (uintptr_t)A % 16 == 0 &&
                   (uintptr_t)invBT % 16 == 0))
    return (int)cudaErrorInvalidValue;
  const size_t need = cluster_bytes(m, n, cluster);
  if (smem_bytes < 0 || (size_t)smem_bytes < need ||
      (size_t)smem_bytes + kClusterStatic > lpc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LP_LAUNCH(CL)                                                       \
  if (cluster == CL)                                                        \
    return lpc::launch(solve_bounded_cluster_kernel<CL>, CL, B,             \
                       (size_t)smem_bytes, s, A, c, lb, ub, invBT, bfs, cB, \
                       basis, vstate, lbB, ubB, iters, status, m, n,        \
                       seg_len, maxiters, opt_tol, pivot_tol, packed,       \
                       aligned);
  LP_CLUSTER_SIZES(LP_LAUNCH)
#undef LP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cluster` CTAs of the streaming branch (`aligned`:
// the bulk-copy branch, else scalar loads) with `smem_bytes` of dynamic
// shared memory each the device holds at once; < 0 is a negated CUDA error
// (a cluster size the device does not grant, or one not built).
extern "C" int lp_solve_bounded_stream_max_clusters(int cluster, int aligned,
                                         int smem_bytes) {
  if (smem_bytes < 0 || !stream_built(cluster))
    return -(int)cudaErrorInvalidValue;
#define LP_MAX(CL, RING)                                                   \
  if (cluster == CL && (aligned != 0) == RING)                             \
    return lpc::max_clusters<lp::kThreads>(                                \
        solve_bounded_stream_kernel<CL, RING>, CL, (size_t)smem_bytes);
  LP_STREAM_SIZES(LP_MAX)
#undef LP_MAX
  return -(int)cudaErrorInvalidValue;
}

// The streaming branch under a launch plan (cluster .. smem_bytes) from
// ops/bounded_kernel.py :: segment_plans, checked here against the shape
// before anything is launched.
extern "C" int lp_solve_bounded_stream(
    const float* A, const float* c, const float* lb, const float* ub,
    float* invBT, float* bfs, float* cB, int* basis, signed char* vstate,
    float* lbB, float* ubB, int* iters, int* status, int B, int m, int n,
    int seg_len, int maxiters, float opt_tol, float pivot_tol, int packed,
    int cluster, int aligned, int stages, int stage_floats, int warp_stages,
    int chunk_floats, int smem_bytes, void* stream) {
  if (m < 1 || n < 1 || B < 1 || !stream_built(cluster))
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
      (stream_vector_floats(m, n, cluster) + ring) * sizeof(float);
  if (smem_bytes < 0 || (size_t)smem_bytes < need ||
      (size_t)smem_bytes + kStreamStatic > lpc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LP_LAUNCH(CL, RING)                                                  \
  if (cluster == CL && (aligned != 0) == RING)                               \
    return lpc::launch<lp::kThreads>(                                        \
        solve_bounded_stream_kernel<CL, RING>, CL, B, (size_t)smem_bytes, s, \
        A, c, lb, ub, invBT, bfs, cB, basis, vstate, lbB, ubB, iters, status, \
        m, n, seg_len, maxiters, opt_tol, pivot_tol, packed, stages,         \
        stage_floats, warp_stages, chunk_floats);
  LP_STREAM_SIZES(LP_LAUNCH)
#undef LP_LAUNCH
  return (int)cudaErrorInvalidValue;
}
