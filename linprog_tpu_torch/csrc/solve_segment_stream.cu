// Whole-segment revised simplex for large m: up to seg_len iterations per
// lane in one launch, one thread-block CLUSTER of 8 or 2 CTAs per lane, the
// lane's state updated in place.
//
// Replaces linprog_tpu/ops/stream_kernel.py :: solve_segment_stream
// (Pallas; body _stream_kernel). Its iteration math is the one of
// solve_segment.cu; what differs is the size of a lane. At m = 2048,
// n = 4096 a primal pivot reads A once (32 MiB), reads the transposed basis
// inverse invBT twice (direction, eta update) and writes it once (16 MiB
// each): 80 MiB per lane-pivot, so the kernel is bound by device-memory
// bandwidth. The card needs megabytes of loads in flight to reach its
// 3.35 TB/s, and a lane's vectors leave one block little room at m = 4096.
//
// What the design does about it:
//   * The CTAs of a cluster split the lane BY ROWS. CTA k owns a contiguous
//     block of rows of A and the same rows of invBT, and with them the
//     entries of y, bfs and the basis of that index range. It never reads
//     or writes another CTA's rows, so every global access of a CTA is a
//     whole row or a long piece of one. Each pass over a matrix gives a
//     partial result over the CTA's rows for ALL columns:
//       pricing    pp[k] = sum_{j own} y[j] A[j, k]          (k < n)
//       dual row   pp2[k] = sum_{j own} invBT[j, l] A[j, k]  (dual mode)
//       direction  pp[i] = sum_{j own} a[j] invBT[j, i]      (i < m)
//     and after a cluster barrier each CTA adds up the partials of all CTAs
//     for its own slice of the columns (c, pen, r) or of d, through
//     distributed shared memory. The order of these sums is fixed by 8 row
//     bands of ceil(m / 8) rows, whatever the cluster size: a CTA owns whole
//     bands, sums the rows of a band in order, and the 8 band totals are
//     added as one balanced tree, within a CTA and then across the CTAs. So
//     a lane gets the same bits in a batch of 8 (8 CTAs a lane) as in a
//     batch of 64 (2 CTAs a lane).
//   * On shapes whose rows are 16-byte aligned (m, n multiples of 4) every
//     pass streams through a ring in shared memory filled by asynchronous
//     bulk copies (cp.async.bulk, completion on an mbarrier) and consumed
//     from shared memory. The card turns a stage of the ring over in about
//     the same time whatever it holds (a few hundred cycles for the
//     barrier round trip), so the ring is a few LARGE stages: 4 of 32 KB
//     where one CTA has an SM to itself. Column passes use the ring
//     block-wide, in sweeps of 2048 columns (8 per thread): warp 0 issues
//     one 8 KB copy per row of a stage, all threads consume a stage (thread
//     per column, the rows in order), each warp arrives on the stage's
//     `empty` barrier when it has read it, and warp 0 refills the stage
//     one tile later: no block barrier per stage. Row passes (duals, the
//     eta update) split the same memory into one ring per warp: the warp
//     streams its own rows in 4 KB chunks and lane 0 refills a stage as
//     soon as the warp has read it. Other shapes (n = 2999) take scalar
//     ld.global.cg loads in the same kernel, built for kScalarCtas CTAs an
//     SM; both branches sum in the same order and give the same bits.
//   * The cluster size is a launch parameter. The launch plan
//     (ops/stream_kernel.py) takes the size that runs the whole batch in
//     one wave with one CTA on an SM: 8 CTAs a lane for the fallback's
//     bucket of 8 lanes, 2 for a batch of 64 (a cluster must lie within a
//     GPC: the card holds 15 clusters of 8 and 66 of 2). Only the sizes
//     that a route launches are built: bulk-copy branch 8 and 2, scalar
//     branch 8.
//   * The duals of the next iteration come out of the eta pass: the warp
//     that rewrites row j of invBT also accumulates y[j] = sum_i cB[i]
//     row_new[i], after cB[leave] = c_enter, in the order the standalone
//     pass uses. Only a launch's first iteration runs the standalone pass.
//     y is recomputed from the factor each iteration, as the reference
//     does; and since pricing needs y only on the CTA's own rows, y is
//     never gathered.
//   * Sectional pricing (partial = 1, primal only, n % n_blk == 0) prices
//     one section of n_blk columns an iteration: each CTA's pricing pass
//     streams only the section's columns of its rows (an S-th of A, S =
//     n / n_blk) and reduces r on its slice of the section; the entering
//     column is the section's by its local index (packed keys in
//     bits_for(n_blk) bits, a stalled lane's first eligible entry of the
//     section). The lane stays in a section while it yields a column, moves
//     to the next when it comes up empty (an iteration without direction,
//     ratio test or pivot), and is OPTIMAL after S empty sections in a row;
//     the section and the count of empty ones start at 0 in every launch.
//     The pass sums each column as the full pass does, so r on a section is
//     the full pass's r bit for bit.
// Vectors that every CTA needs whole (d, the eta vector u, c_B) are
// gathered through distributed shared memory or kept as identical full
// copies. Each selection is a per-CTA packed-key or value+index min, then a
// min over the partials in rank order: an integer min, or a float min plus
// the lowest index, so it picks the same entry in any order and for any
// cluster size. The three dot-product passes differ from the plain
// version's order of summation (per column: a band's rows in order in
// blocks of 32, then the tree over the bands; per row: lane-strided, then a
// shuffle tree). One departure from the plain version's arithmetic: the
// direction d = B^-1 a, which the ratio test reads and the factor update
// is built from, sums with explicit fused multiply-adds (fmaf: one
// rounding per term), although the build disables FMA contraction. The
// plain version's direction is a library GEMV, which fuses too; with
// twice-rounded terms the factor's float64 residual after 16 pivots at
// m = 32 passed twice the plain version's, and 64 dual pivots at m = 2048
// split from it. Every other operation rounds as the plain version's
// elementwise code does.
// Scalars that one CTA owns (d_l, bfs_l, basis[l], c_enter,
// r_enter) travel in the selection partials or are read from the owner's
// shared memory while it cannot change. Stall state and status are computed
// redundantly in every CTA from these identical reduced values, so all CTAs
// agree bit for bit and take the same number of iterations.
//
// Four cluster barriers per iteration (five in dual mode) separate the
// phases that read another CTA's shared memory:
//   primal: [y own rows: first iteration only; partial of y A] (a) [reduce
//           r of own columns; entering partial] (b) [partial of the
//           direction] (c) [reduce d of own rows; ratio partial] (d)
//           [gather d; eta update of own rows with the next y; bookkeeping]
//   dual:   [leaving partial; y own rows: first iteration only] (l)
//           [w = column l of invBT on own rows; partials of w A and y A]
//           (a) [reduce; dual ratio partial] (b) [partial of the direction]
//           (c) [reduce d of own rows] (d) [gather d; eta update with the
//           next y; bookkeeping]
// A CTA's partial vector is rewritten only after a later barrier than the
// one that follows its readers. invBT is read through L2 only (bulk copies,
// or ld.global.cg); a CTA's own writes are next read by its own bulk copies
// (the async proxy), so each writing thread issues fence.proxy.async before
// the block barrier that precedes them.
//
// The row-split primitives (ring, passes, partials and their combine) live in
// stream_ring.cuh, shared with kernel 4's streaming branch.
//
// Shared memory per CTA: (3m + max(m, n) + 5*ml + 4*nl) floats of vectors
// (n more in dual mode; ml and nl the CTA's slices, 8 / CL bands of
// ceil(m / 8) or ceil(n / 8)) plus the ring (16-128 KB on the aligned
// branch); the plan raises for a lane past the 227 KB a block may hold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "stream_ring.cuh"

namespace cg = cooperative_groups;

namespace {

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
using lp::nan_min;
using lp::nonneg;
using lp::pack_key;
using lp::Scratch;
using lp::unpack_value;

constexpr int kScalarCtas = 5;  // CTAs an SM the scalar branch is built for

// Floats of the lane's vectors in one CTA: d, u and c_B whole; the CTA's
// partial of y A (and of w A in dual mode) over all n columns, which the
// partial of the direction reuses; five slices of m and four of n.
size_t vector_floats(int m, int n, int cluster, int dual) {
  const size_t ml = (size_t)(kBands / cluster) * ((m + kBands - 1) / kBands);
  const size_t nl = (size_t)(kBands / cluster) * ((n + kBands - 1) / kBands);
  const size_t part = (size_t)(n > m ? n : m);
  const size_t v = 3 * (size_t)m + part + (dual ? (size_t)n : 0) + 5 * ml + 4 * nl;
  return (v + 3) / 4 * 4;
}

// RING: the bulk-copy branch, one CTA on an SM (the plan gives it the ring
// that fills the SM's shared memory), so a thread may use every register.
// Otherwise the scalar-load branch, built for kScalarCtas CTAs an SM: its
// loads in flight are a thread's own, and it needs the threads.
template <int CL, bool RING>
__global__ void __launch_bounds__(kThreads, RING ? 1 : kScalarCtas)
    solve_segment_stream_kernel(
        const float* __restrict__ A_all, const float* __restrict__ c_all,
        const float* __restrict__ apen_all, float* invBT_all, float* bfs_all,
        float* cB_all, int* basis_all, float* pen_all, int* iters_all,
        int* status_all, int m, int n, int seg_len, int maxiters,
        float opt_tol, float pivot_tol, float feas_tol, int dual, int pricing,
        int packed, int stall_limit, int partial, int n_blk, int stages,
        int stage_floats, int warp_stages, int chunk_floats) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  extern __shared__ __align__(16) float smem[];
  __shared__ Scratch red;
  __shared__ Part s_part[3];  // [0] leaving (dual), [1] entering, [2] ratio
                              // (primal)
  __shared__ Sel s_sel;
  __shared__ float s_zband[kBands];  // entry objective: the CTA's bands, then
                                     // [0] the lane's
  __shared__ __align__(8) unsigned long long s_bbar[kMaxStages];
  __shared__ __align__(8) unsigned long long s_ebar[kMaxStages];
  __shared__ __align__(8) unsigned long long s_wbar[kWarps * kMaxWarpStages];
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x / CL;
  const float* A = A_all + lane * m * n;
  const float* apen = apen_all + lane * n;
  float* invBT = invBT_all + lane * m * m;
  const Range rows = slice_of<CL>(rank, m);  // rows of A and invBT, entries
                                             // of bfs / d / y
  const Range cols = slice_of<CL>(rank, n);  // entries of c / pen / r
  const int nrows = rows.hi - rows.lo;
  const int ml = slice_len<CL>(m), nl = slice_len<CL>(n);
  constexpr int NB = kBands / CL;  // row bands of one CTA
  const int band = ml / NB;        // rows of a band
  const float* A_own = A + (size_t)rows.lo * n;
  float* invBT_own = invBT + (size_t)rows.lo * m;

  // whole vectors (indexed globally)
  float* s_d = smem;       // d; own slice reduced here, the rest gathered
  float* s_u = s_d + m;    // the eta vector
  float* s_cB = s_u + m;   // c_B, an identical copy in every CTA
  float* s_pp = s_cB + m;  // the CTA's partial of y A, then of the direction
  float* s_pp2 = s_pp + (n > m ? n : m);  // partial of w A (dual mode)
  // own slices (indexed from the slice start)
  float* s_y = s_pp2 + (dual ? n : 0);
  float* s_col = s_y + ml;  // entering column, own rows
  float* s_colL = s_col + ml;  // invBT[j, leave], own rows
  float* s_bfs = s_colL + ml;
  int* s_basis = reinterpret_cast<int*>(s_bfs + ml);
  float* s_c = reinterpret_cast<float*>(s_basis + ml);
  float* s_pen = s_c + nl;
  float* s_r = s_pen + nl;
  float* s_urow = s_r + nl;

  Pipe pp;
  pp.ring = smem + ((s_urow + nl - smem) + 3) / 4 * 4;
  pp.bbar = s_bbar;
  pp.ebar = s_ebar;
  pp.wbar = s_wbar;
  pp.bphase = pp.wphase = 0u;
  pp.S = stages;
  pp.stage_floats = stage_floats;
  pp.D = warp_stages;
  pp.C = chunk_floats;
  if (RING && tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(s_bbar + s, 1);
      mbar_init(s_ebar + s, kWarps);
    }
    for (int s = 0; s < kWarps * kMaxWarpStages; ++s) mbar_init(s_wbar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  for (int i = tid; i < m; i += kThreads) s_cB[i] = cB_all[lane * m + i];
  for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
    s_bfs[i - rows.lo] = bfs_all[lane * m + i];
    s_basis[i - rows.lo] = basis_all[lane * m + i];
  }
  for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
    s_c[k - cols.lo] = c_all[lane * n + k];
    s_pen[k - cols.lo] = pen_all[lane * n + k];
  }
  int status = status_all[lane];
  int iters = iters_all[lane];
  __syncthreads();

  const bool dantzig = pricing >= 1;
  const bool track = stall_limit > 0 && pricing >= 1;
  const int bits_n = bits_for(n), bits_m = bits_for(m);
  const int lo_n = (1 << bits_n) - 1, lo_m = (1 << bits_m) - 1;
  // sectional pricing: the selection runs over the section's local indices
  const int n_sec = partial ? n / n_blk : 1;
  const int nsel = partial ? n_blk : n;
  const int bits_sel = partial ? bits_for(n_blk) : bits_n;
  const int lo_sel = (1 << bits_sel) - 1;
  int sec = 0, empty = 0;  // the section, and empty sections in a row

  // segment-local stall state; the entry objective is summed band by band
  // and then as the tree of the column passes, whatever the cluster size
  float z = 0.0f;
  for (int b = 0; b < NB; ++b) {
    const int lo = min(rows.lo + b * band, rows.hi);
    const int hi = min(lo + band, rows.hi);
    float part = 0.0f;
    if (track)
      for (int i = lo + tid; i < hi; i += kThreads)
        part += s_cB[i] * s_bfs[i - rows.lo];
    part = block_sum(part, red);
    if (tid == 0) s_zband[b] = part;
  }
  cl.sync();  // every CTA has started and published its partials
  float zb[kBands];
#pragma unroll
  for (int g = 0; g < kBands; ++g)
    zb[g] = cl.map_shared_rank(s_zband, g / NB)[g % NB];
  if (track)
    z = ((zb[0] + zb[1]) + (zb[2] + zb[3])) + ((zb[4] + zb[5]) + (zb[6] + zb[7]));
  float dz_prev = INFINITY;
  int stall = 0;
  bool bland = false;

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
    float ratio, bfs_l, c_enter, r_enter = 0.0f;

    // ---- duals of own rows (later iterations: from the eta pass) --------
    if (seg == 0) {
      row_pass<RING, false>(invBT, s_cB, nullptr, nullptr, s_y, m, rows, pp);
      __syncthreads();
    }

    if (dual) {
      // ---- leaving partial over the own bfs slice ----------------------
      {
        int key = kIntMax, first = m, hot = m;
        float val = INFINITY;
        for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
          const float b = s_bfs[i - rows.lo];
          if (b < -feas_tol) {
            if (dantzig && packed) key = min(key, pack_key(b, i, bits_m, true));
            first = min(first, i);
          }
          val = nan_min(val, b);
        }
        const int2 kf = block_min2(key, first, red);
        if (dantzig && !packed) {
          val = block_min(val, red);
          for (int i = rows.lo + tid; i < rows.hi; i += kThreads)
            if (s_bfs[i - rows.lo] == val) hot = min(hot, i);
          hot = block_min2(hot, kIntMax, red).x;
        }
        if (tid == 0) s_part[0] = Part{kf.x, kf.y, hot, 0, val, 0.0f};
      }
      cl.sync();  // (l)
      bool viable;
      if (tid == 0) {
        Sel s = combine<CL>(cl, &s_part[0], m);
        int l;
        bool v;
        if (dantzig && packed) {
          v = s.key != kIntMax;
          l = use_bland ? s.first : (s.key & lo_m);
        } else if (dantzig) {
          v = s.val < -feas_tol;
          l = use_bland ? s.first : s.hot;
        } else {
          l = s.first;
          v = l < m;
        }
        if (!v) l = 0;
        s.key = l;  // the leaving row
        s.hot = v;
        // the owner changes its bfs / basis only after (d)
        const int o = owner_of<CL>(l, m);
        const Range orow = slice_of<CL>(o, m);
        s.bfs = cl.map_shared_rank(s_bfs, o)[l - orow.lo];
        s.basis = cl.map_shared_rank(s_basis, o)[l - orow.lo];
        s_sel = s;
      }
      __syncthreads();
      leave = s_sel.key;
      viable = s_sel.hot != 0;
      bfs_l = s_sel.bfs + 0.0f;
      leaving_col = s_sel.basis;

      // ---- partials of urow = B^-1[leave, :] A and of y A, own rows ----
      for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
        s_colL[j - rows.lo] = ldcg(invBT + (size_t)j * m + leave);
      __syncthreads();
      col_pass<RING, 2, false, NB>(A_own, n, n, nrows, band, s_colL, s_y, s_pp2,
                                   s_pp, pp);
      cl.sync();  // (a)
      reduce_slice<CL>(cl, s_pp2, s_urow, cols);
      reduce_slice<CL>(cl, s_pp, s_r, cols);
      for (int k = cols.lo + tid; k < cols.hi; k += kThreads)
        s_r[k - cols.lo] = s_c[k - cols.lo] - s_r[k - cols.lo];
      __syncthreads();

      // ---- dual ratio partial over urow < -pivot_tol, pen == 0 ---------
      {
        int key = kIntMax, hot = n;
        float val = INFINITY;
        for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
          const float uk = s_urow[k - cols.lo];
          if (uk < -pivot_tol && s_pen[k - cols.lo] == 0.0f) {
            const float t = -s_r[k - cols.lo] / uk;
            if (packed)
              key = min(key, pack_key(nonneg(t), k, bits_n, false));
            else
              val = nan_min(val, t);
          }
        }
        if (packed) {
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
        Sel s = combine<CL>(cl, &s_part[1], n);
        bool any;
        int e;
        float rt;
        if (packed) {
          any = s.key != kIntMax;
          e = any ? (s.key & lo_n) : 0;
          rt = any ? unpack_value(s.key, bits_n) : INFINITY;
        } else {
          rt = s.val;
          any = rt < INFINITY;
          e = any ? s.hot : 0;
        }
        s.key = e;
        s.hot = any;
        s.val = rt;
        const int o = owner_of<CL>(e, n);
        s.c_enter = cl.map_shared_rank(s_c, o)[e - slice_of<CL>(o, n).lo];
        s_sel = s;
      }
      __syncthreads();
      enter = s_sel.key;
      const bool any_cand = s_sel.hot != 0;
      ratio = s_sel.val;
      c_enter = s_sel.c_enter + 0.0f;
      do_pivot = viable && any_cand;
      stop_status = !viable ? kOptimal
                            : (!any_cand ? kDualUnbounded : kRunning);

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
      // ---- partial of y A over own rows, then r of own columns (in
      // sectional pricing: the section's columns, and r of the own slice of
      // the section) -------------------------------------------------------
      const int start = partial ? sec * n_blk : 0;
      const Range rc = partial ? Range{max(cols.lo, start),
                                       min(cols.hi, start + n_blk)}
                               : cols;
      col_pass<RING, 1, false, NB>(A_own + start, n, nsel, nrows, band, s_y,
                                   nullptr, s_pp, nullptr, pp);
      cl.sync();  // (a)
      for (int k = rc.lo + tid; k < rc.hi; k += kThreads)
        s_r[k - cols.lo] = (s_c[k - cols.lo] - tree_sum<0, CL>(cl, s_pp, k - start)) +
                           s_pen[k - cols.lo];
      __syncthreads();

      // ---- entering partial (indices local to the section) ---------------
      {
        int key = kIntMax, first = nsel, hot = nsel;
        float val = INFINITY;
        for (int k = rc.lo + tid; k < rc.hi; k += kThreads) {
          const float r = s_r[k - cols.lo];
          if (r < -opt_tol) {
            if (packed && pricing == 1)
              key = min(key, pack_key(r, k - start, bits_sel, true));
            first = min(first, k - start);
          }
          val = nan_min(val, r);
        }
        const int2 kf = block_min2(key, first, red);
        if (dantzig && !(packed && pricing == 1)) {
          val = block_min(val, red);
          for (int k = rc.lo + tid; k < rc.hi; k += kThreads)
            if (s_r[k - cols.lo] == val) hot = min(hot, k - start);
          hot = block_min2(hot, kIntMax, red).x;
        }
        if (tid == 0) s_part[1] = Part{kf.x, kf.y, hot, 0, val, 0.0f};
      }
      cl.sync();  // (b)
      if (tid == 0) {
        Sel s = combine<CL>(cl, &s_part[1], nsel);
        bool elig;
        int e;
        if (packed && pricing == 1) {
          elig = s.key != kIntMax;
          e = use_bland ? s.first : (s.key & lo_sel);
        } else if (dantzig) {
          elig = s.val < -opt_tol;
          e = use_bland ? s.first : s.hot;
        } else {
          e = s.first;
          elig = e < nsel;
        }
        if (!elig) e = 0;
        e += start;
        s.key = e;
        s.hot = elig;
        // the owner rewrites r only after the next (a)
        const int o = owner_of<CL>(e, n);
        const int off = e - slice_of<CL>(o, n).lo;
        s.c_enter = cl.map_shared_rank(s_c, o)[off];
        s.r_enter = cl.map_shared_rank(s_r, o)[off];
        s_sel = s;
      }
      __syncthreads();
      enter = s_sel.key;
      const bool eligible = s_sel.hot != 0;
      c_enter = s_sel.c_enter + 0.0f;
      r_enter = s_sel.r_enter + 0.0f;
      if (partial) {
        empty = eligible ? 0 : empty + 1;
        if (!eligible) {
          // an empty section: no direction, ratio test or pivot; OPTIMAL
          // once every section came up empty under this basis
          sec = sec + 1 == n_sec ? 0 : sec + 1;
          status = empty >= n_sec ? kOptimal : kRunning;
          iters += 1;
          dz_prev = 0.0f;
          __syncthreads();
          continue;
        }
      }

      // ---- partial of the direction over own rows, then own slice and
      // the ratio partial --------------------------------------------------
      for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
        s_col[j - rows.lo] = __ldg(A + (size_t)j * n + enter);
      __syncthreads();
      col_pass<RING, 1, true, NB>(invBT_own, m, m, nrows, band, s_col, nullptr,
                                  s_pp, nullptr, pp);
      cl.sync();  // (c)
      reduce_slice<CL>(cl, s_pp, s_d + rows.lo, rows);
      __syncthreads();
      {
        int key = kIntMax, hot = m;
        float val = INFINITY;
        for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
          const float di = s_d[i];
          if (di > pivot_tol) {
            const float t = nonneg(s_bfs[i - rows.lo]) / di;
            if (packed)
              key = min(key, pack_key(t, i, bits_m, false));
            else
              val = nan_min(val, t);
          }
        }
        int win;
        if (packed) {
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
        if (tid == 0) {
          const bool mine = win >= rows.lo && win < rows.hi;
          s_part[2] = Part{key, m, hot, mine ? s_basis[win - rows.lo] : 0, val,
                           mine ? s_bfs[win - rows.lo] : 0.0f};
        }
      }
      cl.sync();  // (d)
      if (tid == 0) {
        Sel s = combine<CL>(cl, &s_part[2], m);
        bool any;
        int l;
        float rt;
        if (packed) {
          any = s.key != kIntMax;
          l = any ? (s.key & lo_m) : 0;
          rt = any ? unpack_value(s.key, bits_m) : INFINITY;
        } else {
          rt = s.val;
          any = rt < INFINITY;
          l = any ? s.hot : 0;
        }
        take_winner<CL>(cl, &s_part[2], l, m, s);
        s.key = l;
        s.hot = any;
        s.val = rt;
        s.c_enter = s_sel.c_enter;
        s.r_enter = s_sel.r_enter;
        s_sel = s;
      }
      __syncthreads();
      leave = s_sel.key;
      const bool any_pos = s_sel.hot != 0;
      ratio = s_sel.val;
      bfs_l = s_sel.bfs + 0.0f;
      leaving_col = s_sel.basis;
      do_pivot = eligible && any_pos;
      stop_status = !eligible ? kOptimal
                              : (!any_pos ? kPrimalUnbounded : kRunning);
    }

    // ---- pivot: eta update of own rows (with the next iteration's duals),
    // bfs slice and bookkeeping ------------------------------------------
    gather<CL>(cl, s_d, m, rank);
    __syncthreads();
    float dz = 0.0f;
    if (do_pivot) {
      // d_l read as the reference's masked sum reads it (-0.0 -> +0.0)
      const float d_l = s_d[leave] + 0.0f;
      const float safe = d_l == 0.0f ? 1.0f : d_l;
      for (int i = tid; i < m; i += kThreads)
        s_u[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
      if (!dual)  // dual mode staged it for the dual row
        for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
          s_colL[j - rows.lo] = ldcg(invBT + (size_t)j * m + leave);
      // c_B of the new basis: the eta pass's dot products are the next duals
      if (tid == 0) s_cB[leave] = c_enter;
      __syncthreads();
      row_pass<RING, true>(invBT, s_cB, s_u, s_colL, s_y, m, rows, pp);
      // the rows this CTA wrote are next read by its own bulk copies: order
      // the generic-proxy writes before them (a block barrier follows)
      if (RING) fence_proxy_async();
      for (int i = rows.lo + tid; i < rows.hi; i += kThreads)
        s_bfs[i - rows.lo] = s_bfs[i - rows.lo] + s_u[i] * bfs_l;
      __syncthreads();
      if (tid == 0) {
        if (leave >= rows.lo && leave < rows.hi) s_basis[leave - rows.lo] = enter;
        if (leaving_col >= cols.lo && leaving_col < cols.hi)
          s_pen[leaving_col - cols.lo] = apen[leaving_col];
        if (enter >= cols.lo && enter < cols.hi) s_pen[enter - cols.lo] = INFINITY;
      }
      if (track) dz = dual ? -ratio * bfs_l : ratio * r_enter;
    }
    status = stop_status;
    iters += 1;
    z = z + dz;
    dz_prev = dz;
    __syncthreads();
  }

  for (int i = rows.lo + tid; i < rows.hi; i += kThreads) {
    cB_all[lane * m + i] = s_cB[i];
    bfs_all[lane * m + i] = s_bfs[i - rows.lo];
    basis_all[lane * m + i] = s_basis[i - rows.lo];
  }
  for (int k = cols.lo + tid; k < cols.hi; k += kThreads)
    pen_all[lane * n + k] = s_pen[k - cols.lo];
  if (rank == 0 && tid == 0) {
    status_all[lane] = status;
    iters_all[lane] = iters;
  }
  cl.sync();  // no CTA exits while another may read its shared memory
}

// The launch configuration of `cluster` CTAs a lane.
template <int CL, bool RING>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int lanes, size_t smem, cudaStream_t stream) {
  auto kernel = solve_segment_stream_kernel<CL, RING>;
  // always: static shared memory counts against the 48 KB default too
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)lanes * CL, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int CL, bool RING>
int max_clusters(size_t smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<CL, RING>(cfg, &attr, 1024, smem, nullptr);
  if (e != cudaSuccess) return -(int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters,
                                     solve_segment_stream_kernel<CL, RING>,
                                     &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

template <int CL, bool RING, typename... Args>
int launch(int lanes, size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<CL, RING>(cfg, &attr, lanes, smem, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, solve_segment_stream_kernel<CL, RING>, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Cluster sizes the two branches are built for: what the routes launch (a
// bucket of 8 lanes or fewer at 8 CTAs a lane, a larger batch at 2).
bool size_built(int cluster, bool ring) {
  return cluster == 8 || (ring && cluster == 2);
}

}  // namespace

// How many clusters of `cluster` CTAs with `smem_bytes` of dynamic shared
// memory each the device holds at once on the bulk-copy branch
// (`aligned`) or the scalar branch (a batch of more lanes runs in several
// waves); < 0 is a negated CUDA error (e.g. a cluster size the device does
// not grant, or one the branch is not built for).
extern "C" int lp_solve_segment_stream_max_clusters(int cluster, int aligned,
                                                    int smem_bytes) {
  if (smem_bytes < 0 || !size_built(cluster, aligned != 0))
    return -(int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes;
  if (!aligned) return max_clusters<8, false>(smem);
  return cluster == 2 ? max_clusters<2, true>(smem)
                      : max_clusters<8, true>(smem);
}

// The launch plan (cluster .. smem_bytes) comes from
// ops/stream_kernel.py :: stream_plans; it is checked here against the
// shape before anything is launched.
extern "C" int lp_solve_segment_stream(
    const float* A, const float* c, const float* apen, float* invBT,
    float* bfs, float* cB, int* basis, float* pen, int* iters, int* status,
    int B, int m, int n, int seg_len, int maxiters, float opt_tol,
    float pivot_tol, float feas_tol, int dual, int pricing, int packed,
    int stall_limit, int partial, int n_blk, int cluster, int aligned,
    int stages, int stage_floats, int warp_stages, int chunk_floats,
    int smem_bytes, void* stream) {
  if (pricing < 0 || pricing > 1 || m < 1 || n < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  // sectional pricing: primal only, whole sections, and on the bulk-copy
  // branch sections that start on 16 bytes
  if (partial && (dual || n_blk < 1 || n % n_blk || (aligned && n_blk % 4)))
    return (int)cudaErrorInvalidValue;
  if (!size_built(cluster, aligned != 0)) return (int)cudaErrorInvalidValue;
  const size_t vec = vector_floats(m, n, cluster, dual);
  size_t ring = 0;
  if (aligned) {
    const bool ok =
        m % 4 == 0 && n % 4 == 0 &&
        ((uintptr_t)A % 16 == 0) && ((uintptr_t)invBT % 16 == 0) &&
        stages >= 2 && stages <= kMaxStages && stage_floats >= 4 &&
        stage_floats % 4 == 0 && warp_stages >= 1 &&
        warp_stages <= kMaxWarpStages && chunk_floats >= 4 &&
        chunk_floats % 4 == 0 && (chunk_floats >= m || chunk_floats % 32 == 0);
    if (!ok) return (int)cudaErrorInvalidValue;
    const size_t block_view = (size_t)stages * stage_floats;
    const size_t warp_view = (size_t)kWarps * warp_stages * chunk_floats;
    ring = block_view > warp_view ? block_view : warp_view;
  }
  const size_t smem = (vec + ring) * sizeof(float);
  if ((size_t)smem_bytes < smem) return (int)cudaErrorInvalidValue;
  if ((size_t)smem_bytes + sizeof(Part) * 3 + sizeof(Sel) + sizeof(Scratch) + sizeof(float) * kBands +
          8 * (2 * kMaxStages + kWarps * kMaxWarpStages) >
      kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LP_STREAM_LAUNCH(CL, RING)                                            \
  return launch<CL, RING>(B, (size_t)smem_bytes, s, A, c, apen, invBT, bfs,   \
                          cB, basis, pen, iters, status, m, n, seg_len,       \
                          maxiters, opt_tol, pivot_tol, feas_tol, dual,       \
                          pricing, packed, stall_limit, partial, n_blk,       \
                          stages, stage_floats, warp_stages, chunk_floats)
  if (!aligned) LP_STREAM_LAUNCH(8, false);
  if (cluster == 2) LP_STREAM_LAUNCH(2, true);
  LP_STREAM_LAUNCH(8, true);
#undef LP_STREAM_LAUNCH
}
