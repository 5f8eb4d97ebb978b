// Kernel 1's streaming branch (lanes past the largest resident cluster): the
// kernel template and its launchers, built in solve_segment_large.cu (the
// bulk-copy rings) and solve_segment_large_scalar.cu (scalar loads), two
// nvcc processes that run side by side. The design is in
// solve_segment_large.cu's header.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_segment.cuh"
#include "common.cuh"
#include "stream_ring.cuh"

namespace lpl {

namespace cg = cooperative_groups;
using namespace lps;  // the row-split primitives (stream_ring.cuh)

using lp::bits_for;
using lp::block_min;
using lp::block_min2;
using lp::block_sum;
using lp::kDualUnbounded;
using lp::kIntMax;
using lp::kOptimal;
using lp::kPrimalUnbounded;
using lp::kRunning;
using lp::kThreads;
using lp::kWarps;
using lp::nan_max;
using lp::nan_min;
using lp::nonneg;
using lp::pack_key;
using lp::Scratch;
using lp::unpack_value;

// CTAs an SM every build is capped for (its registers): a plan puts one or
// two on an SM by its ring.
constexpr int kCtas = 2;

// Floats of one CTA's vectors at `cl` CTAs a lane: d, u and c_B whole; the
// CTA's partials over max(m, n) (y A, then the direction) and over n twice
// (the dual row, the devex row or split pricing's second product; split
// pricing's third); five slices of m (y, the entering column, the factor's
// column at the leaving row, bfs, the basis) and four of n (c, pen, r, the
// dual row), five with the devex weights.
__host__ __device__ inline size_t vector_floats(int m, int n, int cl,
                                                int devex) {
  const size_t ml = (size_t)(kBands / cl) * ((m + kBands - 1) / kBands);
  const size_t nl = (size_t)(kBands / cl) * ((n + kBands - 1) / kBands);
  const size_t part = (size_t)(n > m ? n : m);
  const size_t v = 3 * (size_t)m + part + 2 * (size_t)n + 5 * ml +
                   (devex ? 5 : 4) * nl;
  return (v + 3) / 4 * 4;
}

// The launch's arguments: the lane state (in place), the settings, the ring.
struct Args {
  const float* A;
  const float* c;
  const float* apen;
  float* invBT;
  float* bfs;
  float* cB;
  int* basis;
  float* pen;
  float* gamma;
  int* iters;
  int* status;
  int m, n, seg_len, maxiters;
  float opt_tol, pivot_tol, feas_tol;
  int dual, pricing, packed, stall_limit, split, ablate;
  int stages, stage_floats, warp_stages, chunk_floats;
};

// The entering column and what its owner holds of it, broadcast by thread 0.
struct Enter {
  int enter, ok;
  float ratio, c, r, g;
};

// The leaving row and what its owner holds of it, broadcast by thread 0.
struct Leave {
  int leave, ok, col;
  float ratio, bfs;
};

// Static shared memory of the kernel, with a reserve.
constexpr size_t kStatic = sizeof(Scratch) + 3 * sizeof(Part) + sizeof(Enter) +
                           sizeof(Leave) + 2 * kBands * sizeof(float) +
                           8 * (2 * kMaxStages + kWarps * kMaxWarpStages) + 64;

template <int CL, bool RING>
__global__ void __launch_bounds__(kThreads, kCtas)
    solve_segment_large_kernel(const Args a) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x / CL;
  const int m = a.m, n = a.n;
  int status = a.status[lane];
  int iters = a.iters[lane];
  // a lane that may not act is left untouched: every CTA of its cluster
  // reads the same status and leaves before any cluster barrier
  if (a.seg_len <= 0 || status != kRunning || iters >= a.maxiters) return;

  extern __shared__ __align__(16) float smem[];
  __shared__ Scratch red;
  __shared__ Part s_part[3];  // [0] leaving (dual), [1] entering, [2] ratio
  __shared__ Enter s_enter;
  __shared__ Leave s_leave;
  __shared__ float s_zband[kBands];  // entry objective, by own band
  __shared__ float s_yband[kBands];  // ablate 1: the sum of y, by own band
  __shared__ __align__(8) unsigned long long s_bbar[kMaxStages];
  __shared__ __align__(8) unsigned long long s_ebar[kMaxStages];
  __shared__ __align__(8) unsigned long long s_wbar[kWarps * kMaxWarpStages];

  constexpr int NB = kBands / CL;  // row bands of one CTA
  const Range rows = slice_of<CL>(rank, m);  // own rows
  const Range cols = slice_of<CL>(rank, n);  // own columns
  const int nrows = rows.hi - rows.lo;
  const int ml = slice_len<CL>(m), nl = slice_len<CL>(n);
  const int band = ml / NB;  // rows of a band
  const float* A = a.A + lane * m * n;
  const float* apen = a.apen + lane * n;
  float* invBT = a.invBT + lane * m * m;
  const float* A_own = A + (size_t)rows.lo * n;
  float* invBT_own = invBT + (size_t)rows.lo * m;
  const bool devex = a.pricing == 2;

  // whole vectors (indexed globally)
  float* s_d = smem;       // d; own slice reduced here, the rest gathered
  float* s_u = s_d + m;    // the eta vector
  float* s_cB = s_u + m;   // c_B, an identical copy in every CTA
  float* s_pp = s_cB + m;  // partial of y A (split: yh Ah), then of d
  float* s_pp2 = s_pp + (n > m ? n : m);  // of the dual or devex row (split:
                                          // yh Al)
  float* s_pp3 = s_pp2 + n;               // split: yl Ah
  // own rows (indexed from rows.lo)
  float* s_y = s_pp3 + n;
  float* s_col = s_y + ml;     // entering column
  float* s_colL = s_col + ml;  // invBT[j, leave] (of the factor before the
                               // pivot: a devex pivot's row is priced with it)
  float* s_bfs = s_colL + ml;
  int* s_basis = reinterpret_cast<int*>(s_bfs + ml);
  // own columns (indexed from cols.lo)
  float* s_c = reinterpret_cast<float*>(s_basis + ml);
  float* s_pen = s_c + nl;
  float* s_r = s_pen + nl;
  float* s_urow = s_r + nl;    // the dual row
  float* s_gamma = s_urow + nl;  // the devex weights (devex only)

  Pipe pp;
  pp.ring = smem + vector_floats(m, n, CL, devex);
  pp.bbar = s_bbar;
  pp.ebar = s_ebar;
  pp.wbar = s_wbar;
  pp.bphase = pp.wphase = 0u;
  pp.S = a.stages;
  pp.stage_floats = a.stage_floats;
  pp.D = a.warp_stages;
  pp.C = a.chunk_floats;
  if (RING && tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(s_bbar + s, 1);
      mbar_init(s_ebar + s, kWarps);
    }
    for (int s = 0; s < kWarps * kMaxWarpStages; ++s) mbar_init(s_wbar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  for (int i = tid; i < m; i += kThreads) s_cB[i] = a.cB[lane * m + i];
  for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
    s_bfs[i - rows.lo] = a.bfs[lane * m + i];
    s_basis[i - rows.lo] = a.basis[lane * m + i];
  }
  for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
    s_c[k - cols.lo] = a.c[lane * n + k];
    s_pen[k - cols.lo] = a.pen[lane * n + k];
    if (devex) s_gamma[k - cols.lo] = a.gamma[lane * n + k];
  }
  __syncthreads();

  const bool dantzig = a.pricing >= 1;
  const bool track = a.stall_limit > 0 && a.pricing >= 1;
  const int bits_n = bits_for(n), bits_m = bits_for(m);
  const int lo_n = (1 << bits_n) - 1, lo_m = (1 << bits_m) - 1;
  const float opt_tol = a.opt_tol, pivot_tol = a.pivot_tol;

  // A sum over the lane's rows of own-row values: band by band, then the
  // balanced tree over the 8 band totals (read after the next cluster
  // barrier), whatever the cluster size.
  auto band_sums = [&](float* out, auto value) {
    for (int b = 0; b < NB; ++b) {
      const int lo = min(rows.lo + b * band, rows.hi);
      const int hi = min(lo + band, rows.hi);
      float part = 0.0f;
      for (int i = lo + tid; i < hi; i += kThreads) part += value(i);
      part = block_sum(part, red);
      if (tid == 0) out[b] = part;
    }
  };
  auto band_tree = [&](float* bands) {
    float v[kBands];
#pragma unroll
    for (int g = 0; g < kBands; ++g)
      v[g] = cl.map_shared_rank(bands, g / NB)[g % NB];
    return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
  };
  // entry k of a product: the CTAs' partials added in the band tree
  auto ts = [&](float* part, int k) { return tree_sum<0, CL>(cl, part, k); };
  // devex weights of own columns from the pivot row w (w_of(k))
  auto devex_update = [&](auto w_of, float safe, float gq, int lcol) {
    const float g_leave = nan_max(gq / (safe * safe), 1.0f);
    for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
      const float ws = w_of(k) / safe;
      float g = nan_max(s_gamma[k - cols.lo], (ws * ws) * gq);
      if (k == lcol) g = g_leave;
      s_gamma[k - cols.lo] = nan_min(g, 1e12f);
    }
  };

  // segment-local stall state: the entry objective in the band tree
  band_sums(s_zband, [&](int i) {
    return track ? s_cB[i] * s_bfs[i - rows.lo] : 0.0f;
  });
  cl.sync();  // every CTA has started and published its partials
  float z = track ? band_tree(s_zband) : 0.0f;
  float dz_prev = INFINITY;
  int stall = 0;
  bool bland = false;
  // a primal devex pivot's row w = (old column l of invBT) . A rides the
  // next iteration's pricing pass as a second sum (its partials in s_pp2);
  // the launch's last one takes a pass of its own
  bool pend = false;
  float pend_safe = 1.0f, pend_gq = 1.0f;
  int pend_lcol = 0;

  for (int seg = 0; seg < a.seg_len && status == kRunning && iters < a.maxiters;
       ++seg) {
    if (track) {
      const bool progressed = fabsf(dz_prev) > 1e-6f * (fabsf(z) + 1.0f);
      stall = progressed ? 0 : stall + 1;
      bland = !progressed && (stall >= a.stall_limit || bland);
    }
    const bool use_bland = track && bland;
    int enter, leave, leaving_col, stop_status;
    bool do_pivot;
    float ratio, bfs_l, c_enter, r_enter = 0.0f, g_enter;

    // ---- duals of own rows (later iterations: from the eta pass) --------
    if (seg == 0) {
      row_pass<RING, false>(invBT, s_cB, nullptr, nullptr, s_y, m, rows, pp);
      __syncthreads();
    }

    if (a.dual) {
      // ---- leaving partial over the own bfs slice ----------------------
      {
        int key = kIntMax, first = m, hot = m;
        float val = INFINITY;
        for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
          const float b = s_bfs[i - rows.lo];
          if (b < -a.feas_tol) {
            if (dantzig && a.packed) key = min(key, pack_key(b, i, bits_m, true));
            first = min(first, i);
          }
          val = nan_min(val, b);
        }
        const int2 kf = block_min2(key, first, red);
        if (dantzig && !a.packed) {
          val = block_min(val, red);
          for (int i = rows.lo + tid; i < rows.hi; i += kThreads)
            if (s_bfs[i - rows.lo] == val) hot = min(hot, i);
          hot = block_min2(hot, kIntMax, red).x;
        }
        if (tid == 0) s_part[0] = Part{kf.x, kf.y, hot, 0, val, 0.0f};
      }
      cl.sync();  // (l)
      if (tid == 0) {
        const Sel s = combine<CL>(cl, &s_part[0], m);
        Leave v;
        if (dantzig && a.packed) {
          v.ok = s.key != kIntMax;
          v.leave = use_bland ? s.first : (s.key & lo_m);
        } else if (dantzig) {
          v.ok = s.val < -a.feas_tol;
          v.leave = use_bland ? s.first : s.hot;
        } else {
          v.leave = s.first;
          v.ok = v.leave < m;
        }
        if (!v.ok) v.leave = 0;
        // the owner changes its bfs and basis only after (d)
        const int o = owner_of<CL>(v.leave, m);
        const int off = v.leave - slice_of<CL>(o, m).lo;
        v.bfs = cl.map_shared_rank(s_bfs, o)[off];
        v.col = cl.map_shared_rank(s_basis, o)[off];
        v.ratio = 0.0f;
        s_leave = v;
      }
      __syncthreads();
      leave = s_leave.leave;
      const bool viable = s_leave.ok != 0;
      bfs_l = s_leave.bfs + 0.0f;
      leaving_col = s_leave.col;

      // ---- partials of urow = B^-1[leave, :] A and of y A, own rows ----
      for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
        s_colL[j - rows.lo] = ldcg(invBT + (size_t)j * m + leave);
      __syncthreads();
      col_pass<RING, 2, false, NB>(A_own, n, n, nrows, band, s_colL, s_y,
                                   s_pp2, s_pp, pp);
      cl.sync();  // (a)
      for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
        s_urow[k - cols.lo] = ts(s_pp2, k);
        s_r[k - cols.lo] = s_c[k - cols.lo] - ts(s_pp, k);
      }
      __syncthreads();

      // ---- dual ratio partial over urow < -pivot_tol, pen == 0 ---------
      {
        int key = kIntMax, hot = n;
        float val = INFINITY;
        for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
          const float uk = s_urow[k - cols.lo];
          if (uk < -pivot_tol && s_pen[k - cols.lo] == 0.0f) {
            const float t = -s_r[k - cols.lo] / uk;
            if (a.packed)
              key = min(key, pack_key(nonneg(t), k, bits_n, false));
            else
              val = nan_min(val, t);
          }
        }
        if (a.packed) {
          key = block_min2(key, kIntMax, red).x;
        } else {
          val = block_min(val, red);
          for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
            const float uk = s_urow[k - cols.lo];
            if (uk < -pivot_tol && s_pen[k - cols.lo] == 0.0f &&
                -s_r[k - cols.lo] / uk == val)
              hot = min(hot, k);
          }
          hot = block_min2(hot, kIntMax, red).x;
        }
        if (tid == 0) s_part[1] = Part{key, n, hot, 0, val, 0.0f};
      }
      cl.sync();  // (b)
      if (tid == 0) {
        const Sel s = combine<CL>(cl, &s_part[1], n);
        Enter e;
        if (a.packed) {
          e.ok = s.key != kIntMax;
          e.enter = e.ok ? (s.key & lo_n) : 0;
          e.ratio = e.ok ? unpack_value(s.key, bits_n) : INFINITY;
        } else {
          e.ratio = s.val;
          e.ok = e.ratio < INFINITY;
          e.enter = e.ok ? s.hot : 0;
        }
        // the owner changes its weights only after (d)
        const int o = owner_of<CL>(e.enter, n);
        const int off = e.enter - slice_of<CL>(o, n).lo;
        e.c = cl.map_shared_rank(s_c, o)[off];
        e.r = 0.0f;
        e.g = devex ? cl.map_shared_rank(s_gamma, o)[off] : 0.0f;
        s_enter = e;
      }
      __syncthreads();
      enter = s_enter.enter;
      const bool any_cand = s_enter.ok != 0;
      ratio = s_enter.ratio;
      c_enter = s_enter.c + 0.0f;
      g_enter = s_enter.g;
      do_pivot = viable && any_cand;
      stop_status = !viable ? kOptimal : (!any_cand ? kDualUnbounded : kRunning);

      // ---- partial of the direction over own rows, then own slice ------
      for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
        s_col[j - rows.lo] = __ldg(A + (size_t)j * n + enter);
      __syncthreads();
      col_pass<RING, 1, true, NB>(invBT_own, m, m, nrows, band, s_col, nullptr,
                                  s_pp, nullptr, pp);
      cl.sync();  // (c)
      reduce_slice<CL>(cl, s_pp, s_d + rows.lo, rows);
      cl.sync();  // (d)
    } else {
      // ---- partial of y A over own rows (and of a devex pivot's row) ------
      const bool wrow = devex && pend;
      if (a.ablate == 1) {  // the pricing product dropped: the sum of y
        band_sums(s_yband, [&](int i) { return s_y[i - rows.lo]; });
        if (wrow)
          col_pass<RING, 1, false, NB>(A_own, n, n, nrows, band, s_colL,
                                       nullptr, s_pp2, nullptr, pp);
      } else if (a.split) {
        col_pass<RING, 3, false, NB>(A_own, n, n, nrows, band, s_y, nullptr,
                                     s_pp, s_pp2, pp, s_pp3);
      } else if (wrow) {
        col_pass<RING, 2, false, NB>(A_own, n, n, nrows, band, s_y, s_colL,
                                     s_pp, s_pp2, pp);
      } else {
        col_pass<RING, 1, false, NB>(A_own, n, n, nrows, band, s_y, nullptr,
                                     s_pp, nullptr, pp);
      }
      cl.sync();  // (a)
      if (wrow) {  // the weights of the last pivot, before they are read
        devex_update([&](int k) { return ts(s_pp2, k); }, pend_safe, pend_gq,
                     pend_lcol);
        pend = false;
        __syncthreads();
      }

      // ---- r = (c - y A) + pen of own columns; the entering partial -------
      const float ysum = a.ablate == 1 ? band_tree(s_yband) : 0.0f;
      const bool pk = a.packed && a.pricing == 1;
      // the devex score, as the min of its negative
      auto score = [&](float r, int k) {
        return -((r * r) / s_gamma[k - cols.lo]);
      };
      {
        int key = kIntMax, first = n, hot = n;
        float val = INFINITY;
        for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
          const float ya =
              a.ablate == 1 ? ysum
              : a.split     ? (ts(s_pp, k) + ts(s_pp2, k)) + ts(s_pp3, k)
                            : ts(s_pp, k);
          const float r = (s_c[k - cols.lo] - ya) + s_pen[k - cols.lo];
          s_r[k - cols.lo] = r;
          if (r < -opt_tol) {
            if (pk) key = min(key, pack_key(r, k, bits_n, true));
            if (devex) val = nan_min(val, score(r, k));
            first = min(first, k);
          }
          if (!devex) val = nan_min(val, r);
        }
        const int2 kf = block_min2(key, first, red);
        if (dantzig && !pk) {
          val = block_min(val, red);
          for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
            const float r = s_r[k - cols.lo];
            const bool at = devex ? (r < -opt_tol && score(r, k) == val)
                                  : r == val;
            if (at) hot = min(hot, k);
          }
          hot = block_min2(hot, kIntMax, red).x;
        }
        if (tid == 0) s_part[1] = Part{kf.x, kf.y, hot, 0, val, 0.0f};
      }
      cl.sync();  // (b)
      if (tid == 0) {
        const Sel s = combine<CL>(cl, &s_part[1], n);
        Enter e;
        if (a.ablate == 4) {  // the entering selection skipped
          e.ok = true;
          e.enter = seg % n;
        } else if (pk) {
          e.ok = s.key != kIntMax;
          e.enter = use_bland ? s.first : (s.key & lo_n);
        } else if (devex) {
          e.ok = s.val < INFINITY;  // false for a NaN score
          e.enter = use_bland ? s.first : s.hot;
        } else if (dantzig) {
          e.ok = s.val < -opt_tol;
          e.enter = use_bland ? s.first : s.hot;
        } else {
          e.enter = s.first;
          e.ok = e.enter < n;
        }
        if (!e.ok) e.enter = 0;
        // the owner rewrites r and its weights only after the next (a)
        const int o = owner_of<CL>(e.enter, n);
        const int off = e.enter - slice_of<CL>(o, n).lo;
        e.c = cl.map_shared_rank(s_c, o)[off];
        e.r = cl.map_shared_rank(s_r, o)[off];
        e.g = devex ? cl.map_shared_rank(s_gamma, o)[off] : 0.0f;
        e.ratio = 0.0f;
        s_enter = e;
      }
      __syncthreads();
      enter = s_enter.enter;
      const bool eligible = s_enter.ok != 0;
      c_enter = s_enter.c + 0.0f;
      r_enter = s_enter.r + 0.0f;
      g_enter = s_enter.g;

      // ---- the direction of own rows: its partial, then own slice ---------
      if (a.ablate == 2) {  // the direction product dropped: d = a
        for (int i = rows.lo + tid; i < rows.hi; i += kThreads)
          s_d[i] = __ldg(A + (size_t)i * n + enter);
      } else {
        for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
          s_col[j - rows.lo] = __ldg(A + (size_t)j * n + enter);
        __syncthreads();
        col_pass<RING, 1, true, NB>(invBT_own, m, m, nrows, band, s_col,
                                    nullptr, s_pp, nullptr, pp);
        cl.sync();  // (c)
        reduce_slice<CL>(cl, s_pp, s_d + rows.lo, rows);
      }
      __syncthreads();

      // ---- ratio partial over own rows with d > pivot_tol ----------------
      {
        int key = kIntMax, hot = m, win = m;
        float val = INFINITY;
        if (a.ablate == 5) {  // the ratio-test reductions skipped
          win = seg % m;
        } else {
          for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
            const float di = s_d[i];
            if (di > pivot_tol) {
              const float t = nonneg(s_bfs[i - rows.lo]) / di;
              if (a.packed)
                key = min(key, pack_key(t, i, bits_m, false));
              else
                val = nan_min(val, t);
            }
          }
          if (a.packed) {
            key = block_min2(key, kIntMax, red).x;
            win = key != kIntMax ? (key & lo_m) : m;
          } else {
            val = block_min(val, red);
            for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
              const float di = s_d[i];
              if (di > pivot_tol && nonneg(s_bfs[i - rows.lo]) / di == val)
                hot = min(hot, i);
            }
            hot = block_min2(hot, kIntMax, red).x;
            win = hot;
          }
        }
        if (tid == 0) {
          // the local winner's basis entry and bfs ride the partial
          const bool mine = win >= rows.lo && win < rows.hi;
          s_part[2] = Part{key, m, hot, mine ? s_basis[win - rows.lo] : 0, val,
                           mine ? s_bfs[win - rows.lo] : 0.0f};
        }
      }
      cl.sync();  // (d)
      if (tid == 0) {
        Sel s = combine<CL>(cl, &s_part[2], m);
        Leave v;
        if (a.ablate == 5) {
          v.ok = true;
          v.leave = seg % m;
          v.ratio = 0.0f;
        } else if (a.packed) {
          v.ok = s.key != kIntMax;
          v.leave = v.ok ? (s.key & lo_m) : 0;
          v.ratio = v.ok ? unpack_value(s.key, bits_m) : INFINITY;
        } else {
          v.ratio = s.val;
          v.ok = v.ratio < INFINITY;
          v.leave = v.ok ? s.hot : 0;
        }
        take_winner<CL>(cl, &s_part[2], v.leave, m, s);
        v.bfs = s.bfs;
        v.col = s.basis;
        s_leave = v;
      }
      __syncthreads();
      leave = s_leave.leave;
      const bool any_pos = s_leave.ok != 0;
      ratio = s_leave.ratio;
      bfs_l = s_leave.bfs + 0.0f;
      leaving_col = s_leave.col;
      do_pivot = eligible && any_pos;
      stop_status = !eligible ? kOptimal
                              : (!any_pos ? kPrimalUnbounded : kRunning);
    }
    if (a.ablate == 6) {  // the masked scalar extracts skipped
      bfs_l = 0.0f;
      leaving_col = 0;
      c_enter = 0.0f;
      r_enter = 0.0f;
    }

    // ---- pivot: eta update of own rows (with the next iteration's duals),
    // bfs slice, weights and bookkeeping ---------------------------------
    gather<CL>(cl, s_d, m, rank);
    __syncthreads();
    float dz = 0.0f;
    if (do_pivot) {
      // scalars read as the reference's masked sums read them (-0.0 -> +0.0)
      const float d_l = a.ablate == 6 ? 1.0f : s_d[leave] + 0.0f;
      const float safe = d_l == 0.0f ? 1.0f : d_l;
      const float gamma_q = devex ? nan_max(g_enter + 0.0f, 1.0f) : 1.0f;
      for (int i = tid; i < m; i += kThreads)
        s_u[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
      if (!a.dual)  // dual mode staged it for the dual row
        for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
          s_colL[j - rows.lo] = ldcg(invBT + (size_t)j * m + leave);
      if (devex && a.dual) {
        // w is the dual row, whose own entries this CTA holds
        devex_update([&](int k) { return s_urow[k - cols.lo]; }, safe,
                     gamma_q, leaving_col);
      } else if (devex) {
        pend = true;
        pend_safe = safe;
        pend_gq = gamma_q;
        pend_lcol = leaving_col;
      }
      __syncthreads();  // every thread has read c_B
      // c_B of the new basis: the eta pass's dot products are the next duals
      if (tid == 0 && a.ablate != 7) s_cB[leave] = c_enter;
      __syncthreads();
      if (a.ablate == 3)  // the factor's update skipped; duals from its rows
        row_pass<RING, false>(invBT, s_cB, nullptr, nullptr, s_y, m, rows, pp);
      else
        row_pass<RING, true>(invBT, s_cB, s_u, s_colL, s_y, m, rows, pp);
      // the rows this CTA wrote are next read by its own bulk copies: order
      // the generic-proxy writes before them (a block barrier follows)
      if (RING) fence_proxy_async();
      for (int i = rows.lo + tid; i < rows.hi; i += kThreads)
        s_bfs[i - rows.lo] = s_bfs[i - rows.lo] + s_u[i] * bfs_l;
      __syncthreads();
      if (tid == 0 && a.ablate != 7) {
        if (leave >= rows.lo && leave < rows.hi)
          s_basis[leave - rows.lo] = enter;
        if (leaving_col >= cols.lo && leaving_col < cols.hi)
          s_pen[leaving_col - cols.lo] = apen[leaving_col];
        if (enter >= cols.lo && enter < cols.hi)
          s_pen[enter - cols.lo] = INFINITY;
      }
      if (track) dz = a.dual ? -ratio * bfs_l : ratio * r_enter;
    }
    status = stop_status;
    iters += 1;
    z = z + dz;
    dz_prev = dz;
    __syncthreads();
  }
  if (pend) {  // the launch's last devex pivot: its row in a pass of its own
    col_pass<RING, 1, false, NB>(A_own, n, n, nrows, band, s_colL, nullptr,
                                 s_pp2, nullptr, pp);
    cl.sync();
    devex_update([&](int k) { return ts(s_pp2, k); }, pend_safe, pend_gq,
                 pend_lcol);
    __syncthreads();
  }

  for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
    a.cB[lane * m + i] = s_cB[i];
    a.bfs[lane * m + i] = s_bfs[i - rows.lo];
    a.basis[lane * m + i] = s_basis[i - rows.lo];
  }
  for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
    a.pen[lane * n + k] = s_pen[k - cols.lo];
    if (devex) a.gamma[lane * n + k] = s_gamma[k - cols.lo];
  }
  if (rank == 0 && tid == 0) {
    a.status[lane] = status;
    a.iters[lane] = iters;
  }
  cl.sync();  // no CTA exits while another may read its shared memory
}

// The builds (CTAs a lane, bulk-copy ring or scalar loads): what the plans
// of ops/solve_kernel.py :: segment_plans launch (LARGE_LAYOUTS,
// LARGE_SCALAR_CLUSTERS). Each is launched and queried through a function
// of its own, defined in the source that builds it.
#define LP_LARGE_RING_BUILDS(X) X(2, true) X(4, true) X(8, true)
#define LP_LARGE_SCALAR_BUILDS(X) X(4, false) X(8, false)

#define LP_LARGE_DECLARE(CL, RING)                                       \
  int launch_##CL##_##RING(const Args& a, int lanes, size_t smem,       \
                           cudaStream_t stream);                        \
  int max_clusters_##CL##_##RING(size_t smem);
LP_LARGE_RING_BUILDS(LP_LARGE_DECLARE)
LP_LARGE_SCALAR_BUILDS(LP_LARGE_DECLARE)
#undef LP_LARGE_DECLARE

#define LP_LARGE_DEFINE(CL, RING)                                            \
  int launch_##CL##_##RING(const Args& a, int lanes, size_t smem,           \
                           cudaStream_t stream) {                           \
    return lpc::launch<kThreads>(solve_segment_large_kernel<CL, RING>, CL,   \
                                 lanes, smem, stream, a);                   \
  }                                                                         \
  int max_clusters_##CL##_##RING(size_t smem) {                             \
    return lpc::max_clusters<kThreads>(solve_segment_large_kernel<CL, RING>, \
                                       CL, smem);                           \
  }

}  // namespace lpl
