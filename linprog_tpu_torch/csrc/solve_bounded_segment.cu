// Whole-segment bounded-variable simplex (min c'x, Ax = b, lb <= x <= ub):
// up to seg_len iterations per lane in one launch, the lane's state updated
// in place.
//
// Replaces linprog_tpu/ops/bounded_kernel.py :: solve_bounded_segment
// (Pallas, body _bounded_kernel). Two branches, chosen by the lane's shape
// (m, n) alone (ops/bounded_kernel.py :: segment_plans), in the design of
// solve_segment.cu:
//
// CLUSTER-RESIDENT (A and invBT fit a cluster of at most 16 CTAs). One lane
// runs on a cluster of CL CTAs; each CTA loads its whole row bands of A and
// of invBT into shared memory once (cluster_segment.cuh), keeps the lane's
// O(m + n) vectors whole, and the segment runs on chip with two cluster
// barriers an iteration:
//   [partial of y A] (a) [rc of every column from the CTAs' partials; the
//   entering column; partial of the direction] (c) [d from the partials;
//   the three-way ratio test over whole vectors; bfs; a pivot's eta update
//   of own rows, which yields the next duals; states]
// Every CTA runs the same selections on the same whole vectors, so they
// agree without exchanging them. A bound flip changes neither c_B nor the
// factor, so the duals stand. The bits do not depend on the cluster size
// (fixed row bands, one tree).
//
// BLOCK PER LANE (lanes past the largest cluster). A[m, n] and invBT stay in
// device memory; the O(m + n) vectors (c, lb, ub, vstate, rc, y, d, u, bfs,
// cB, lbB, ubB, basis) live in shared memory. Per iteration the block
// streams A once and invBT up to four times, so it is bound by
// device-memory bandwidth:
//   y   = c_B B^-1              warp per row of invBT
//   rc  = +-(y A - c)           thread per column of A (coalesced)
//   entering column             block-wide min (packed key) or max + index
//   d   = B^-1 A[:, enter]      thread per column of invBT (coalesced)
//   three-way ratio test        block-wide mins over the two ratio rows
//   bfs -= step * sigma * d     a bound flip stops here
//   invBT += invBT[:, l] u      warp per row (a pivot only)
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

#include "cluster_segment.cuh"
#include "common.cuh"

namespace {

using lp::block_min;
using lp::block_min2;
using lp::bits_for;
using lp::direction;
using lp::duals;
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

__global__ void __launch_bounds__(kThreads) solve_bounded_segment_kernel(
    const float* __restrict__ A_all, const float* __restrict__ c_all,
    const float* __restrict__ lb_all, const float* __restrict__ ub_all,
    float* invBT_all, float* bfs_all, float* cB_all, int* basis_all,
    signed char* vstate_all, float* lbB_all, float* ubB_all, int* iters_all,
    int* status_all, int m, int n, int seg_len, int maxiters, float opt_tol,
    float pivot_tol, int packed) {
  extern __shared__ float smem[];
  __shared__ Scratch red;
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x;
  const float* A = A_all + lane * m * n;
  float* invBT = invBT_all + lane * m * m;

  float* s_bfs = smem;
  float* s_cB = s_bfs + m;
  float* s_lbB = s_cB + m;
  float* s_ubB = s_lbB + m;
  int* s_basis = reinterpret_cast<int*>(s_ubB + m);
  float* s_y = reinterpret_cast<float*>(s_basis + m);
  float* s_d = s_y + m;
  float* s_u = s_d + m;
  float* s_col = s_u + m;
  float* s_c = s_col + m;
  float* s_lb = s_c + n;
  float* s_ub = s_lb + n;
  float* s_rc = s_ub + n;
  int* s_vs = reinterpret_cast<int*>(s_rc + n);

  for (int i = tid; i < m; i += kThreads) {
    s_bfs[i] = bfs_all[lane * m + i];
    s_cB[i] = cB_all[lane * m + i];
    s_lbB[i] = lbB_all[lane * m + i];
    s_ubB[i] = ubB_all[lane * m + i];
    s_basis[i] = basis_all[lane * m + i];
  }
  for (int k = tid; k < n; k += kThreads) {
    s_c[k] = c_all[lane * n + k];
    s_lb[k] = lb_all[lane * n + k];
    s_ub[k] = ub_all[lane * n + k];
    s_vs[k] = vstate_all[lane * n + k];
  }
  int status = status_all[lane];
  int iters = iters_all[lane];
  __syncthreads();

  const int bits_n = bits_for(n), bits_m = bits_for(m);
  const int lo_n = (1 << bits_n) - 1, lo_m = (1 << bits_m) - 1;

  for (int seg = 0; seg < seg_len && status == kRunning && iters < maxiters;
       ++seg) {
    // ---- bound-aware pricing: z - c at a lower bound, c - z at an upper --
    duals(invBT, s_cB, s_y, m);
    __syncthreads();
    for (int k = tid; k < n; k += kThreads) {
      float ay = 0.0f;
#pragma unroll 4
      for (int j = 0; j < m; ++j) ay += s_y[j] * __ldg(A + (size_t)j * n + k);
      const float zc = ay - s_c[k];
      const int vs = s_vs[k];
      s_rc[k] = vs == kBasic ? -INFINITY : (vs == kAtUb ? -zc : zc);
    }
    __syncthreads();

    // ---- entering column: the largest rc above opt_tol -------------------
    bool eligible;
    int enter;
    if (packed) {
      int key = kIntMax;
      for (int k = tid; k < n; k += kThreads) {
        const float rc = s_rc[k];
        if (rc > opt_tol) key = min(key, pack_key(-rc, k, bits_n, true));
      }
      const int kr = block_min2(key, kIntMax, red).x;
      eligible = kr != kIntMax;
      enter = eligible ? (kr & lo_n) : 0;
    } else {
      float part = INFINITY;  // the max of rc as the min of -rc
      for (int k = tid; k < n; k += kThreads) part = nan_min(part, -s_rc[k]);
      const float best = -block_min(part, red);
      eligible = best > opt_tol;
      int hot = n;
      for (int k = tid; k < n; k += kThreads)
        if (s_rc[k] == best) hot = min(hot, k);
      enter = block_min2(hot, kIntMax, red).x;
      if (!eligible) enter = 0;
    }
    // scalars read as the reference's masked sums read them (-0.0 -> +0.0,
    // inf passes through)
    const int vs_enter = s_vs[enter];
    const float lb_e = s_lb[enter] + 0.0f;
    const float ub_e = s_ub[enter] + 0.0f;
    const float c_e = s_c[enter] + 0.0f;
    const float sigma = vs_enter == kAtLb ? 1.0f : -1.0f;

    direction(A, invBT, s_col, s_d, m, n, enter);

    // ---- three-way ratio test ---------------------------------------------
    const float gamma3 = ub_e - lb_e;
    float delta;
    bool leave_to_lb;
    int leave;
    if (packed) {
      int k1 = kIntMax, k2 = kIntMax;
      for (int i = tid; i < m; i += kThreads) {
        const float sd = sigma * s_d[i];
        const float2 g =
            ratios(sigma, s_d[i], s_bfs[i], s_lbB[i], s_ubB[i], pivot_tol);
        if (sd > pivot_tol) k1 = min(k1, pack_key(g.x, i, bits_m, false));
        if (-sd > pivot_tol) k2 = min(k2, pack_key(g.y, i, bits_m, false));
      }
      const int2 km = block_min2(k1, k2, red);
      leave_to_lb = km.x < km.y;
      const int ksel = min(km.x, km.y);
      leave = ksel & lo_m;
      delta = INFINITY;
      if (ksel != kIntMax) {
        // the step length exactly at the chosen row, not the key's
        // truncated mantissa
        const float2 g = ratios(sigma, s_d[leave], s_bfs[leave], s_lbB[leave],
                                s_ubB[leave], pivot_tol);
        delta = (leave_to_lb ? g.x : g.y) + 0.0f;
      }
    } else {
      float p1 = INFINITY, p2 = INFINITY;
      for (int i = tid; i < m; i += kThreads) {
        const float2 g =
            ratios(sigma, s_d[i], s_bfs[i], s_lbB[i], s_ubB[i], pivot_tol);
        p1 = nan_min(p1, g.x);
        p2 = nan_min(p2, g.y);
      }
      const float g1 = block_min(p1, red);
      const float g2 = block_min(p2, red);
      delta = nan_min(g1, g2);
      leave_to_lb = g1 < g2;
      int l1 = m, l2 = m;
      for (int i = tid; i < m; i += kThreads) {
        const float2 g =
            ratios(sigma, s_d[i], s_bfs[i], s_lbB[i], s_ubB[i], pivot_tol);
        if (g.x == g1) l1 = min(l1, i);
        if (g.y == g2) l2 = min(l2, i);
      }
      const int2 lm = block_min2(l1, l2, red);
      leave = leave_to_lb ? lm.x : lm.y;
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
    for (int i = tid; i < m; i += kThreads) {
      const float moved = s_bfs[i] - step_len * (sigma * s_d[i]);
      s_bfs[i] = (seat && i == leave) ? enter_val : moved;
    }

    if (piv) {
      // ---- rank-1 eta update of invBT (column l staged first: its rows
      // are rewritten below) ------------------------------------------------
      for (int i = tid; i < m; i += kThreads) {
        s_u[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
        s_col[i] = invBT[(size_t)i * m + row_l];
      }
      __syncthreads();
      lp::eta_update(invBT, s_col, s_u, m);
      if (tid == 0) {
        if (seat) {
          s_basis[leave] = enter;
          s_cB[leave] = c_e;
          s_lbB[leave] = lb_e;
          s_ubB[leave] = ub_e;
        }
        s_vs[enter] = kBasic;
        s_vs[leaving_col] = leave_to_lb ? kAtLb : kAtUb;
      }
    } else if (flip && tid == 0) {
      s_vs[enter] = 1 - vs_enter;
    }
    status = !eligible ? kOptimal : (unbounded ? kPrimalUnbounded : kRunning);
    iters += 1;
    __syncthreads();
  }

  for (int i = tid; i < m; i += kThreads) {
    bfs_all[lane * m + i] = s_bfs[i];
    cB_all[lane * m + i] = s_cB[i];
    lbB_all[lane * m + i] = s_lbB[i];
    ubB_all[lane * m + i] = s_ubB[i];
    basis_all[lane * m + i] = s_basis[i];
  }
  for (int k = tid; k < n; k += kThreads)
    vstate_all[lane * n + k] = (signed char)s_vs[k];
  if (tid == 0) {
    status_all[lane] = status;
    iters_all[lane] = iters;
  }
}


// ===== cluster-resident branch ==============================================

namespace cg = cooperative_groups;
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

extern "C" int lp_solve_bounded_segment(
    const float* A, const float* c, const float* lb, const float* ub,
    float* invBT, float* bfs, float* cB, int* basis, signed char* vstate,
    float* lbB, float* ubB, int* iters, int* status, int B, int m, int n,
    int seg_len, int maxiters, float opt_tol, float pivot_tol, int packed,
    void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(9 * m + 5 * n) * sizeof(float);
  // always: static shared memory counts against the 48 KB default too
  const cudaError_t e = cudaFuncSetAttribute(
      solve_bounded_segment_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  solve_bounded_segment_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      A, c, lb, ub, invBT, bfs, cB, basis, vstate, lbB, ubB, iters, status, m,
      n, seg_len, maxiters, opt_tol, pivot_tol, packed);
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs with `smem_bytes` of dynamic shared
// memory each the device holds at once; < 0 is a negated CUDA error.
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
