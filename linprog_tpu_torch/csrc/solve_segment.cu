// Whole-segment revised simplex: up to seg_len iterations per lane in one
// launch, the lane's state updated in place.
//
// Replaces linprog_tpu/ops/solve_kernel.py :: solve_segment (Pallas). Two
// branches, chosen by the lane's shape (m, n) alone (ops/solve_kernel.py ::
// segment_plans): the cluster-resident branch here, and past the largest
// cluster the streaming branch (solve_segment_large.cu).
//
// CLUSTER-RESIDENT (every lane whose A and invBT fit a cluster of at most 16
// CTAs: m up to ~512 at n = 2m). One lane runs on a cluster of CL CTAs (1,
// 2, 4, 8 or 16, by the launch plan); CTA k owns kBands / CL of the lane's
// 16 fixed row bands: its rows of A[m, n] and of the transposed basis
// inverse invBT[m, m], loaded into shared memory ONCE at launch by bulk
// copies, and the duals y of those rows. Every iteration runs on chip: a
// lane's 768 KB at m = 256, n = 512 would otherwise cross device memory
// about five times an iteration (A once, invBT four times: duals,
// direction, the eta read and write), as it did in the first port's block
// per lane (~0.65 ms a batch-iteration). Each pass over a resident matrix
// yields the CTA's partial over its rows for all columns:
//   pricing    p1[k] = sum_{j own} y[j] A[j, k]
//   dual row   pw[k] = sum_{j own} invBT[j, l] A[j, k]   (with pricing)
//   direction  p2[i] = sum_{j own} a[j] invBT[j, i]      (fused multiply-adds)
//   devex row  pw[k] as the dual row, for the weights (primal mode)
// After a cluster barrier every CTA adds up the partials of ALL entries it
// needs through distributed shared memory, in the fixed band tree of
// cluster_segment.cuh (so a lane's bits do not depend on the cluster size),
// and runs each selection over whole vectors (c, pen, bfs, the basis, the
// weights: identical copies in every CTA) in one block reduction. So the
// CTAs agree without exchanging selections, and an iteration has two
// cluster barriers:
//   primal: [partial of y A] (a) [devex: weights of the last pivot; r and
//           the entering column; partial of the direction] (c) [d; ratio
//           test; eta update of own rows with the next y; bfs; devex row]
//   dual:   [leaving row; partials of w A and y A] (a) [dual ratio test;
//           partial of the direction] (c) [d; eta update; bfs; devex
//           weights, then one more barrier before w's partials are reused]
// A partial is rewritten only after the barrier that follows its last
// readers: p1 and pw after (c), p2 after the next (a). The eta pass over
// the own rows of invBT also yields the next iteration's duals
// y'_j = row'_j . c_B' (after c_B[leave] = c_enter), so only a launch's
// first iteration runs the duals pass. invBT is written back once at exit.
// What bounds it: the latency of an iteration (two barriers, two rounds of
// remote reads, three block reductions, the shared-memory passes), with a
// batch larger than the resident clusters run in waves.
//
// The unit layout (n_d < n): where the trailing columns n_d .. n - 1 of
// every lane hold one nonzero each (the slack and artificial columns of a
// standard form), the CTAs hold only their rows of the leading n_d columns
// and every lane's unit columns come as a row and a value. A pass gives a
// unit column the partial col_pass would (lpc::unit_pass: +0 + v_r a in
// the CTA that owns row r, +0 elsewhere, NaN where an own v off row r is
// not finite), and an entering unit column's entries are a at its row, 0
// elsewhere, so every bit is the dense launch's. At m = 256 the two-phase
// simplex's [G | I | I] (n = 768) then fits 4 CTAs a lane, not 8, and the
// card holds 30 lanes at once instead of 15; the driver takes the layout
// only where it saves CTAs (solve_kernel.unit_pays).
//
// Dual mode picks the leaving row first, prices the row B^-1[l, :] A and
// r = c - y A in one pass over A, and takes the dual ratio test. Devex
// pricing (pricing = 2) keeps the reference weights gamma[n]: the entering
// column maximises r^2 / gamma over r < -opt_tol (first index on ties; a
// stalled lane takes Bland's column instead), and each pivot's weights come
// from the pivot row w = B^-1[l, :] A of the old tableau (the dual row
// itself in dual mode): gamma_j <- max(gamma_j, (w_j / d_l)^2 gamma_q) with
// gamma_q = max(gamma[enter], 1); the leaving column re-enters at
// max(gamma_q / d_l^2, 1); everything is capped at 1e12.
//
// Split pricing (split = 1: primal mode, bland or dantzig) prices with the
// bf16 halves of y and of A, r = (c - ((yh Ah + yh Al) + yl Ah)) + pen: the
// three partial sums run in the pricing pass's own order and are added in
// the reference's; the halves are taken in registers (__float2bfloat16_rn)
// from the f32 A the kernel holds anyway, so the mode reads no more bytes
// and the plans do not change. Each product of halves is exact in f32, and
// only the lo * lo term is dropped.
//
// The ablation switch (ablate = 1..7, profiling only, the reference's modes)
// drops one stage of the iteration so that its share of the time can be
// read: 1 the pricing product (r = (c - sum y) + pen), 4 the entering
// selection (enter = seg % n), 2 the direction product (d = a), 5 the
// ratio-test reductions (leave = seg % m), 6 the masked scalar extracts
// (d_l = 1, the rest 0), 3 the O(m^2) update of the factor (the next duals
// still come from the unchanged rows), 7 the bookkeeping writes (basis,
// c_B, penalty). Modes 1, 2, 4 and 5 touch the primal iteration only.
// ablate = 0 runs the kernel as it is.
//
// Semantics follow the Pallas kernel and the plain PyTorch version
// (linprog_tpu_torch/ops/solve_kernel.py): absolute opt_tol, packed keys
// with the index in the low bits (complemented for negative values,
// INT32_MAX for "none", lowest index on exact ties), ratios clamped to +0.0
// before packing, segment-local stall state, untouched non-RUNNING lanes.
// The reference's `unroll` never changed results; this kernel has none.

#include <cuda_runtime.h>
#include <math.h>

#include "cluster_segment.cuh"
#include "common.cuh"

namespace {

using lp::bits_for;
using lp::kDualUnbounded;
using lp::kIntMax;
using lp::kOptimal;
using lp::kPrimalUnbounded;
using lp::kRunning;
using lp::nonneg;
using lp::pack_key;
using lp::unpack_value;

// ===== cluster-resident branch ==============================================

namespace cg = cooperative_groups;
using lp::nan_max;
using lpc::Pick;

// Floats of one CTA's dynamic shared memory at `cl` CTAs a lane: its rows of
// the leading n_d columns of A and of invBT; d, u, c_B, bfs and the basis
// whole; c, pen and the devex weights whole; the CTA's partials over n
// (pricing, the dual or devex row) and over m (the direction); three slices
// of m; the row and value of each of the n - n_d unit columns.
size_t cluster_floats(int m, int n, int cl, int n_d) {
  const size_t ml = (size_t)(lpc::kBands / cl) * ((m + lpc::kBands - 1) / lpc::kBands);
  return lpc::round4(ml * n_d) + lpc::round4(ml * m) +
         lpc::round4(6 * (size_t)m + 5 * (size_t)n + 3 * ml) +
         lpc::round4(2 * (size_t)(n - n_d));
}

template <int CL>
__global__ void __launch_bounds__(lpc::kThreads, 1) solve_segment_cluster_kernel(
    const float* __restrict__ A_all, const float* __restrict__ c_all,
    const float* __restrict__ apen_all, float* invBT_all, float* bfs_all,
    float* cB_all, int* basis_all, float* pen_all, float* gamma_all,
    int* iters_all, int* status_all, const int* __restrict__ urow_all,
    const float* __restrict__ uval_all, int m, int n, int n_d, int seg_len,
    int maxiters, float opt_tol, float pivot_tol, float feas_tol, int dual,
    int pricing, int packed, int stall_limit, int aligned, int split,
    int ablate) {
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
  __shared__ lpc::SumScratch red;
  __shared__ lpc::PickScratch ps;
  __shared__ __align__(8) unsigned long long s_bar;

  constexpr int NB = lpc::kBands / CL;  // row bands of one CTA
  const lpc::Range rows = lpc::slice_of<CL>(rank, m);  // own rows
  const lpc::Range cols = lpc::slice_of<CL>(rank, n);  // entries written back
  const int nrows = rows.hi - rows.lo;
  const int ml = lpc::slice_len<CL>(m);
  const int band = lpc::band_len(m);
  const float* A = A_all + lane * m * n;
  const float* apen = apen_all + lane * n;
  float* invBT = invBT_all + lane * m * m;
  const bool devex = pricing == 2;
  // the unit layout: columns n_d .. n - 1 hold one nonzero each, kept as
  // its row and value; shared memory holds the leading n_d columns
  const bool unit = n_d < n;
  const int n_u = n - n_d;

  float* sA = smem;                                // own rows of A[:, :n_d]
  float* sB = sA + lpc::round4((size_t)ml * n_d);  // own rows of invBT
  // whole vectors, identical in every CTA
  float* s_d = sB + lpc::round4((size_t)ml * m);  // the direction
  float* s_u = s_d + m;    // the eta vector
  float* s_cB = s_u + m;
  float* s_bfs = s_cB + m;
  int* s_basis = reinterpret_cast<int*>(s_bfs + m);
  float* s_c = reinterpret_cast<float*>(s_basis + m);
  float* s_pen = s_c + n;
  float* s_gamma = s_pen + n;
  // the CTA's partials, read by every CTA of the cluster
  // split pricing (never with devex or in dual mode) keeps its three
  // partials of y A in s_p1 (yh Ah), s_pw (yh Al) and s_gamma (yl Ah)
  float* s_p1 = s_gamma + n;  // of y A
  float* s_pw = s_p1 + n;     // of the dual row, or of the devex pivot row
  float* s_p2 = s_pw + n;     // of the direction (m entries)
  // own rows
  float* s_y = s_p2 + m;
  float* s_col = s_y + ml;     // entering column, own rows
  float* s_colL = s_col + ml;  // invBT[j, leave], own rows
  int* s_urow = reinterpret_cast<int*>(s_colL + ml);  // unit columns' rows
  float* s_uval = reinterpret_cast<float*>(s_urow + n_u);  // and values

  if (tid == 0) {
    lpc::mbar_init(&s_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (unit) {
    lpc::load_resident_rows(sA, A + (size_t)rows.lo * n, nrows, n, n_d, sB,
                            invBT + (size_t)rows.lo * m, nrows * m,
                            aligned != 0, &s_bar);
    for (int u = tid; u < n_u; u += lpc::kThreads) {
      s_urow[u] = urow_all[lane * n_u + u];
      s_uval[u] = uval_all[lane * n_u + u];
    }
  } else {
    lpc::load_resident(sA, A + (size_t)rows.lo * n, nrows * n, sB,
                       invBT + (size_t)rows.lo * m, nrows * m, aligned != 0,
                       &s_bar);
  }
  for (int i = tid; i < m; i += lpc::kThreads) {
    s_cB[i] = cB_all[lane * m + i];
    s_bfs[i] = bfs_all[lane * m + i];
    s_basis[i] = basis_all[lane * m + i];
  }
  for (int k = tid; k < n; k += lpc::kThreads) {
    s_c[k] = c_all[lane * n + k];
    s_pen[k] = pen_all[lane * n + k];
    if (devex) s_gamma[k] = gamma_all[lane * n + k];
  }
  __syncthreads();

  const bool dantzig = pricing >= 1;
  const bool track = stall_limit > 0 && pricing >= 1;
  const int bits_n = bits_for(n), bits_m = bits_for(m);
  const int lo_n = (1 << bits_n) - 1, lo_m = (1 << bits_m) - 1;

  // segment-local stall state; the entry objective in the band tree
  const float z0 = track ? lpc::lane_objective(s_cB, s_bfs, m, band, red)
                         : 0.0f;
  float z = z0;
  float dz_prev = INFINITY;
  int stall = 0;
  bool bland = false;

  // entry k of a product: the CTAs' partials added in the band tree
  auto sum = [&](float* part, int k) {
    return lpc::tree_sum<0, CL>(cl, part, k);
  };
  // the CTA's partials of v0 A over its rows: the unit columns from their
  // map, the held columns by col_pass
  auto a_pass1 = [&](const float* v0, float* out0) {
    if (unit)
      lpc::unit_pass<1>(s_urow, s_uval, n_d, n, rows.lo, nrows, v0, nullptr,
                        out0, nullptr);
    lpc::col_pass<1, false, NB, 2>(sA, n_d, n_d, nrows, band, v0, nullptr,
                                   out0, nullptr);
  };
  // the entering column's entries in own rows
  auto load_col = [&](int k) {
    if (k < n_d) {
      for (int j = tid; j < nrows; j += lpc::kThreads)
        s_col[j] = sA[(size_t)j * n_d + k];
    } else {
      const int r = s_urow[k - n_d] - rows.lo;
      const float a = s_uval[k - n_d];
      for (int j = tid; j < nrows; j += lpc::kThreads)
        s_col[j] = j == r ? a : 0.0f;
    }
  };
  // devex weights from the pivot row w (the partials in s_pw)
  auto devex_update = [&](float safe, float gq, int lcol) {
    const float g_leave = nan_max(gq / (safe * safe), 1.0f);
    for (int k = tid; k < n; k += lpc::kThreads) {
      const float ws = sum(s_pw, k) / safe;
      float g = nan_max(s_gamma[k], (ws * ws) * gq);
      if (k == lcol) g = g_leave;
      s_gamma[k] = lp::nan_min(g, 1e12f);
    }
  };
  // a primal devex pivot's weights wait for the next cluster barrier, after
  // which its row's partials (s_pw) are summed
  bool pend = false;
  float pend_safe = 1.0f, pend_gq = 1.0f;
  int pend_lcol = 0;

  cl.sync();  // every CTA of the cluster runs
  for (int seg = 0; seg < seg_len && status == kRunning && iters < maxiters;
       ++seg) {
    if (track) {
      const bool progressed = fabsf(dz_prev) > 1e-6f * (fabsf(z) + 1.0f);
      stall = progressed ? 0 : stall + 1;
      bland = !progressed && (stall >= stall_limit || bland);
    }
    const bool use_bland = track && bland;
    int enter = 0, leave = 0, stop_status, leaving_col;
    bool do_pivot;
    float ratio, bfs_l, c_enter, r_enter = 0.0f, g_enter = 0.0f;

    // ---- duals of own rows (later iterations: from the eta pass) --------
    if (seg == 0) {
      lpc::row_pass<false>(sB, s_cB, nullptr, nullptr, s_y, m, nrows);
      __syncthreads();
    }

    if (dual) {
      // ---- leaving row: most infeasible (dantzig) or first (bland) ------
      Pick p = lpc::pick_init(m);
      for (int i = tid; i < m; i += lpc::kThreads) {
        const float b = s_bfs[i];
        if (b < -feas_tol) {
          if (dantzig && packed) p.key = min(p.key, pack_key(b, i, bits_m, true));
          p.first = min(p.first, i);
        }
        if (dantzig && !packed) lpc::amin(p, b, i, m);
      }
      p = lpc::block_pick(p, m, ps);
      bool viable;
      if (dantzig && packed) {
        viable = p.key != kIntMax;
        leave = use_bland ? p.first : (p.key & lo_m);
      } else if (dantzig) {
        viable = p.v < -feas_tol;
        leave = use_bland ? p.first : p.i;
      } else {
        leave = p.first;
        viable = leave < m;
      }
      if (!viable) leave = 0;
      bfs_l = s_bfs[leave] + 0.0f;
      leaving_col = s_basis[leave];

      // ---- partials of urow = B^-1[leave, :] A and of y A, own rows ----
      for (int j = tid; j < nrows; j += lpc::kThreads)
        s_colL[j] = sB[(size_t)j * m + leave];
      __syncthreads();
      if (unit)
        lpc::unit_pass<2>(s_urow, s_uval, n_d, n, rows.lo, nrows, s_colL,
                          s_y, s_pw, s_p1);
      lpc::col_pass<2, false, NB, 1>(sA, n_d, n_d, nrows, band, s_colL, s_y,
                                     s_pw, s_p1);
      cl.sync();  // (a)

      // ---- dual ratio test over urow < -pivot_tol, pen == 0 ------------
      Pick q = lpc::pick_init(n);
      for (int k = tid; k < n; k += lpc::kThreads) {
        const float uk = sum(s_pw, k);
        const float rk = s_c[k] - sum(s_p1, k);
        if (uk < -pivot_tol && s_pen[k] == 0.0f) {
          const float t = -rk / uk;
          if (packed)
            q.key = min(q.key, pack_key(nonneg(t), k, bits_n, false));
          else
            lpc::amin(q, t, k, n);
        }
      }
      q = lpc::block_pick(q, n, ps);
      bool any_cand;
      if (packed) {
        any_cand = q.key != kIntMax;
        enter = any_cand ? (q.key & lo_n) : 0;
        ratio = any_cand ? unpack_value(q.key, bits_n) : INFINITY;
      } else {
        ratio = q.v;
        any_cand = ratio < INFINITY;
        enter = any_cand ? q.i : 0;
      }
      do_pivot = viable && any_cand;
      stop_status = !viable ? kOptimal
                            : (!any_cand ? kDualUnbounded : kRunning);
    } else {
      // ---- partial of y A over own rows ---------------------------------
      if (ablate == 1) {  // the pricing product dropped: the sum of y
        float part = 0.0f;
        for (int j = tid; j < nrows; j += lpc::kThreads) part += s_y[j];
        part = lpc::block_sum(part, red);
        if (tid == 0) s_p1[0] = part;
        __syncthreads();
      } else if (split) {  // never with the unit layout
        lpc::col_pass_split<NB>(sA, n, n, nrows, band, s_y, s_p1, s_pw,
                                s_gamma);
      } else {
        a_pass1(s_y, s_p1);
      }
      cl.sync();  // (a)
      if (pend) {  // the weights of the last pivot, before they are read
        devex_update(pend_safe, pend_gq, pend_lcol);
        pend = false;
        __syncthreads();
      }

      // ---- pricing r = (c - y A) + pen and the entering column ----------
      const float ysum = ablate == 1 ? sum(s_p1, 0) : 0.0f;
      auto price = [&](int k) {
        const float ya =
            ablate == 1 ? ysum
            : split     ? (sum(s_p1, k) + sum(s_pw, k)) + sum(s_gamma, k)
                        : sum(s_p1, k);
        return (s_c[k] - ya) + s_pen[k];
      };
      const bool pk = packed && pricing == 1;
      Pick p = lpc::pick_init(n);
      if (ablate != 4)
        for (int k = tid; k < n; k += lpc::kThreads) {
          const float r = price(k);
          if (r < -opt_tol) {
            if (pk) p.key = min(p.key, pack_key(r, k, bits_n, true));
            if (devex) lpc::amin(p, -((r * r) / s_gamma[k]), k, n);
            p.first = min(p.first, k);
          }
          if (dantzig && !pk && !devex) lpc::amin(p, r, k, n);
        }
      p = lpc::block_pick(p, n, ps);
      bool eligible;
      if (ablate == 4) {  // the entering selection skipped
        eligible = true;
        enter = seg % n;
      } else if (pk) {
        eligible = p.key != kIntMax;
        enter = use_bland ? p.first : (p.key & lo_n);
      } else if (devex) {
        eligible = p.v < INFINITY;  // false for a NaN score
        enter = use_bland ? p.first : p.i;
      } else if (dantzig) {
        eligible = p.v < -opt_tol;
        enter = use_bland ? p.first : p.i;
      } else {
        enter = p.first;
        eligible = enter < n;
      }
      if (!eligible) enter = 0;
      // the same expression as in the selection, so the same bits
      r_enter = price(enter) + 0.0f;

      // ---- partial of the direction over own rows ------------------------
      if (ablate == 2) {  // the direction product dropped: d = a
        cl.sync();  // (c)
        for (int i = tid; i < m; i += lpc::kThreads)
          s_d[i] = __ldg(A + (size_t)i * n + enter);
      } else {
        load_col(enter);
        __syncthreads();
        lpc::col_pass<1, true, NB, 1>(sB, m, m, nrows, band, s_col, nullptr,
                                      s_p2, nullptr);
        cl.sync();  // (c)
        for (int i = tid; i < m; i += lpc::kThreads) s_d[i] = sum(s_p2, i);
      }
      __syncthreads();

      // ---- primal ratio test over d > pivot_tol ------------------------
      Pick q = lpc::pick_init(m);
      if (ablate != 5)
      for (int i = tid; i < m; i += lpc::kThreads) {
        const float di = s_d[i];
        if (di > pivot_tol) {
          const float t = nonneg(s_bfs[i]) / di;
          if (packed)
            q.key = min(q.key, pack_key(t, i, bits_m, false));
          else
            lpc::amin(q, t, i, m);
        }
      }
      q = lpc::block_pick(q, m, ps);
      bool any_pos;
      if (ablate == 5) {  // the ratio-test reductions skipped
        any_pos = true;
        leave = seg % m;
        ratio = 0.0f;
      } else if (packed) {
        any_pos = q.key != kIntMax;
        leave = any_pos ? (q.key & lo_m) : 0;
        ratio = any_pos ? unpack_value(q.key, bits_m) : INFINITY;
      } else {
        ratio = q.v;
        any_pos = ratio < INFINITY;
        leave = any_pos ? q.i : 0;
      }
      bfs_l = s_bfs[leave] + 0.0f;
      leaving_col = s_basis[leave];
      do_pivot = eligible && any_pos;
      stop_status = !eligible ? kOptimal
                              : (!any_pos ? kPrimalUnbounded : kRunning);
    }
    c_enter = s_c[enter] + 0.0f;
    if (devex) g_enter = s_gamma[enter];
    if (ablate == 6) {  // the masked scalar extracts skipped
      bfs_l = 0.0f;
      leaving_col = 0;
      c_enter = 0.0f;
      r_enter = 0.0f;
    }

    if (dual) {
      // ---- the direction: partial over own rows, then all of d ---------
      load_col(enter);
      __syncthreads();
      lpc::col_pass<1, true, NB, 1>(sB, m, m, nrows, band, s_col, nullptr,
                                    s_p2, nullptr);
      cl.sync();  // (c)
      for (int i = tid; i < m; i += lpc::kThreads) s_d[i] = sum(s_p2, i);
      __syncthreads();
    }

    // ---- pivot: eta update of own rows (with the next iteration's duals),
    // bfs, weights and bookkeeping -----------------------------------------
    float dz = 0.0f;
    if (do_pivot) {
      // scalars read as the reference's masked sums read them (-0.0 -> +0.0)
      const float d_l = ablate == 6 ? 1.0f : s_d[leave] + 0.0f;
      const float safe = d_l == 0.0f ? 1.0f : d_l;
      const float gamma_q = devex ? nan_max(g_enter + 0.0f, 1.0f) : 1.0f;
      for (int i = tid; i < m; i += lpc::kThreads)
        s_u[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
      if (!dual)  // dual mode staged it for the dual row
        for (int j = tid; j < nrows; j += lpc::kThreads)
          s_colL[j] = sB[(size_t)j * m + leave];
      __syncthreads();  // every thread has read c_B, bfs and the basis
      // c_B of the new basis: the eta pass's dot products are the next duals
      if (tid == 0 && ablate != 7) s_cB[leave] = c_enter;
      if (devex && dual) {
        // w is the dual row; its partials are rewritten after the next
        // (l)-free start of an iteration, so the cluster waits for every
        // reader below
        devex_update(safe, gamma_q, leaving_col);
      } else if (devex) {
        // the pivot row of the OLD tableau, summed after the next barrier
        a_pass1(s_colL, s_pw);
        pend = true;
        pend_safe = safe;
        pend_gq = gamma_q;
        pend_lcol = leaving_col;
      }
      __syncthreads();
      if (ablate == 3)  // the factor's update skipped; duals from its rows
        lpc::row_pass<false>(sB, s_cB, nullptr, nullptr, s_y, m, nrows);
      else
        lpc::row_pass<true>(sB, s_cB, s_u, s_colL, s_y, m, nrows);
      for (int i = tid; i < m; i += lpc::kThreads)
        s_bfs[i] = s_bfs[i] + s_u[i] * bfs_l;
      __syncthreads();
      if (tid == 0 && ablate != 7) {
        s_basis[leave] = enter;
        s_pen[leaving_col] = apen[leaving_col];
        s_pen[enter] = INFINITY;
      }
      if (devex && dual) cl.sync();  // before anyone rewrites s_pw
      if (track) dz = dual ? -ratio * bfs_l : ratio * r_enter;
    }
    status = stop_status;
    iters += 1;
    z = z + dz;
    dz_prev = dz;
    __syncthreads();
  }
  if (pend) {  // the last pivot's weights
    cl.sync();
    devex_update(pend_safe, pend_gq, pend_lcol);
    __syncthreads();
  }

  lpc::store_rows(invBT + (size_t)rows.lo * m, sB, nrows * m, aligned != 0);
  for (int i = rows.lo + tid; i < rows.hi; i += lpc::kThreads) {
    cB_all[lane * m + i] = s_cB[i];
    bfs_all[lane * m + i] = s_bfs[i];
    basis_all[lane * m + i] = s_basis[i];
  }
  for (int k = cols.lo + tid; k < cols.hi; k += lpc::kThreads) {
    pen_all[lane * n + k] = s_pen[k];
    if (devex) gamma_all[lane * n + k] = s_gamma[k];
  }
  if (rank == 0 && tid == 0) {
    status_all[lane] = status;
    iters_all[lane] = iters;
  }
  cl.sync();  // no CTA exits while another may read its shared memory
}

// Static shared memory of the cluster kernel, with a reserve.
constexpr size_t kClusterStatic =
    sizeof(lpc::SumScratch) + sizeof(lpc::PickScratch) + 64;

#define LP_CLUSTER_SIZES(X) X(1) X(2) X(4) X(8) X(16)

}  // namespace

extern "C" const char* lp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// How many clusters of `cluster` CTAs with `smem_bytes` of dynamic shared
// memory each the device holds at once (a batch of more lanes runs in
// several waves); < 0 is a negated CUDA error (a size that is not built, or
// one the device does not grant).
extern "C" int lp_solve_segment_cluster_max_clusters(int cluster,
                                                     int smem_bytes) {
  if (smem_bytes < 0 || !lpc::cluster_built(cluster))
    return -(int)cudaErrorInvalidValue;
#define LP_MAX(CL) \
  if (cluster == CL) \
    return lpc::max_clusters(solve_segment_cluster_kernel<CL>, CL, (size_t)smem_bytes);
  LP_CLUSTER_SIZES(LP_MAX)
#undef LP_MAX
  return -(int)cudaErrorInvalidValue;
}

// The cluster-resident branch under a launch plan (cluster, aligned,
// smem_bytes) from ops/solve_kernel.py :: segment_plans, checked here
// against the shape before anything is launched.
//
// The unit layout (n_d < n): every lane's columns n_d .. n - 1 hold one
// nonzero each, at row urow[b, k - n_d] with value uval[b, k - n_d]
// ([B, n - n_d] each); the CTAs hold only the leading n_d columns of A.
// Never with split pricing or an ablation mode. With n_d == n (urow and
// uval unused) the lane is held whole.
extern "C" int lp_solve_segment_cluster(
    const float* A, const float* c, const float* apen, float* invBT,
    float* bfs, float* cB, int* basis, float* pen, float* gamma, int* iters,
    int* status, int B, int m, int n, int seg_len, int maxiters,
    float opt_tol, float pivot_tol, float feas_tol, int dual, int pricing,
    int packed, int stall_limit, int split, int ablate, const int* urow,
    const float* uval, int n_d, int cluster, int aligned, int smem_bytes,
    void* stream) {
  if (pricing < 0 || pricing > 2 || m < 1 || n < 1 || B < 1 ||
      !lpc::cluster_built(cluster) || ablate < 0 || ablate > 7 ||
      (split && (dual || pricing == 2)) || n_d < 0 || n_d > n ||
      (n_d < n && (split || ablate || urow == nullptr || uval == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (aligned && !(m % 4 == 0 && n % 4 == 0 && n_d % 4 == 0 &&
                   (uintptr_t)A % 16 == 0 && (uintptr_t)invBT % 16 == 0))
    return (int)cudaErrorInvalidValue;
  const size_t need = cluster_floats(m, n, cluster, n_d) * sizeof(float);
  if (smem_bytes < 0 || (size_t)smem_bytes < need ||
      (size_t)smem_bytes + kClusterStatic > lpc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LP_LAUNCH(CL)                                                        \
  if (cluster == CL)                                                         \
    return lpc::launch(solve_segment_cluster_kernel<CL>, CL, B,              \
                       (size_t)smem_bytes, s, A, c, apen, invBT, bfs, cB,    \
                       basis, pen, gamma, iters, status, urow, uval, m, n,   \
                       n_d, seg_len, maxiters, opt_tol, pivot_tol, feas_tol, \
                       dual, pricing, packed, stall_limit, aligned, split,   \
                       ablate);
  LP_CLUSTER_SIZES(LP_LAUNCH)
#undef LP_LAUNCH
  return (int)cudaErrorInvalidValue;
}
