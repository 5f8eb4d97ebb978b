// Whole-segment revised simplex for large m: up to seg_len iterations per
// lane in one launch, one thread-block CLUSTER of 8 CTAs per lane, the
// lane's state updated in place.
//
// Replaces linprog_tpu/ops/stream_kernel.py :: solve_segment_stream
// (Pallas; body _stream_kernel). Its iteration math is the one of
// solve_segment.cu; what differs is the size of a lane. At m = 2048,
// n = 4096 a primal pivot reads A once (32 MiB) and the transposed basis
// inverse invBT four times (duals, direction, the eta read and write:
// 16 MiB each), about 96 MiB per lane-pivot, so the kernel is bound by
// device-memory bandwidth. One 256-thread block per lane (solve_segment.cu)
// would keep far too few loads in flight for the few large lanes of this
// regime, and its (7m + 4n) floats of shared vectors pass the 227 KB a
// block may hold at m = 4096. Here the 8 CTAs of a cluster split the lane:
// CTA k owns
//   * a contiguous slice of A's columns: pricing r = c - yA + pen (and the
//     dual row B^-1[l, :] A), and the c, pen and r entries of the slice;
//   * a contiguous slice of the rows of invBT: duals y = c_B B^-1 on those
//     rows, the eta update invBT[j, :] += invBT[j, l] u, and the bfs and
//     basis entries of the same index range;
//   * the same index range of the direction d = B^-1 a, read as a column
//     slice of every row of invBT (coalesced within the row).
// So each lane has 8x the SMs and loads in flight of the one-block design,
// and its vectors are split 8 ways. Vectors that every CTA needs whole
// (y, d, the entering column, the dual row w, c_B) are gathered through
// distributed shared memory or kept as identical full copies. Each
// selection is a per-CTA packed-key or value+index min, then a min over
// the 8 partials in rank order: an integer min, or a float min plus the
// lowest index, so it picks the same entry in any order. Only the GEMV sums
// run in another order than the plain version's. Scalars that one CTA owns
// (d_l, bfs_l, basis[l], c_enter, r_enter) travel in the selection
// partials or are read from the owner's shared memory while it cannot
// change. Stall state and status are computed redundantly in every CTA
// from these identical reduced values, so all CTAs agree bit for bit and
// take the same number of iterations.
//
// Three cluster barriers per iteration separate the phases that read
// another CTA's rows or shared memory:
//   primal: [y own rows] (a) [gather y; price own columns; entering
//           partial] (b) [direction slice; ratio partial] (c) [gather d;
//           eta update of own rows; bookkeeping]
//   dual:   [leaving partial; y own rows] (a) [gather y; w = column l of
//           invBT; price own columns; dual ratio partial] (b) [direction
//           slice] (c) [gather d; eta update; bookkeeping]
// The eta update writes only the CTA's own rows, after (c), when every
// CTA has finished reading column slices for the direction; the next
// iteration's direction reads them after its (a). invBT is read through L2
// only (ld.global.cg), so no CTA sees a stale L1 line of a row that
// another CTA wrote.
//
// Shared memory per CTA: (4m + 3*ceil(m/8) + 4*ceil(n/8) + 256) floats,
// about 97 KB at the two-phase shape m = 4096, n = 12288 and 44 KB at
// m = 2048, n = 4096. The largest lane it takes is where that reaches
// 227 KB, e.g. m = 8192 with n up to about 42,000; the wrapper raises past
// it. No TMA and no wgmma: a simple kernel that is right comes first.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

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

constexpr int kCluster = 8;  // CTAs per lane (the portable maximum)
constexpr size_t kMaxSmem = 232448;  // bytes a Hopper block may use

// One CTA's partial of a selection (or of the entry objective).
struct Part {
  int key;    // min packed key, or kIntMax
  int first;  // lowest eligible index, or the size
  int hot;    // lowest index attaining `val`, or the size
  int basis;  // basis entry at the CTA's local winner (primal ratio test)
  float val;  // NaN-propagating min value, or +inf
  float bfs;  // bfs entry at the local winner (primal ratio test)
  float sum;  // partial sum (entry objective)
  float pad;
};

// The cluster's reduction of a selection, plus the scalars it broadcasts.
struct Sel {
  int key, first, hot, basis;
  float val, bfs, sum;
  float c_enter, r_enter;
};

struct Range {
  int lo, hi;
};

__device__ __forceinline__ int slice_len(int size) {
  return (size + kCluster - 1) / kCluster;
}

__device__ __forceinline__ Range slice_of(int rank, int size) {
  const int len = slice_len(size);
  return {min(rank * len, size), min((rank + 1) * len, size)};
}

__device__ __forceinline__ int owner_of(int idx, int size) {
  return idx / slice_len(size);
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

// Thread 0 combines the 8 CTAs' partials in `slot`, in rank order.
// `size` is the default of `hot` when no CTA attains the min value.
__device__ Sel combine(cg::cluster_group& cl, Part* slot, int size) {
  Sel s;
  s.key = kIntMax;
  s.first = size;
  s.hot = size;
  s.basis = 0;
  s.val = INFINITY;
  s.bfs = 0.0f;
  s.sum = 0.0f;
  s.c_enter = 0.0f;
  s.r_enter = 0.0f;
  for (int r = 0; r < kCluster; ++r) {
    const Part* p = cl.map_shared_rank(slot, r);
    s.key = min(s.key, p->key);
    s.first = min(s.first, p->first);
    s.val = nan_min(s.val, p->val);
    s.sum = s.sum + p->sum;
  }
  for (int r = 0; r < kCluster; ++r) {
    const Part* p = cl.map_shared_rank(slot, r);
    if (p->val == s.val) s.hot = min(s.hot, p->hot);
  }
  return s;
}

// The winner's bfs / basis entries, carried by the owner's partial.
__device__ void take_winner(cg::cluster_group& cl, Part* slot, int leave,
                            int m, Sel& s) {
  const Part w = *cl.map_shared_rank(slot, owner_of(leave, m));
  s.bfs = w.bfs;
  s.basis = w.basis;
}

// dst[i] = (owner of i)'s src[i] for every i outside the CTA's own slice.
__device__ void gather(cg::cluster_group& cl, float* buf, int size,
                       unsigned rank) {
  for (int i = threadIdx.x; i < size; i += kThreads) {
    const unsigned r = (unsigned)owner_of(i, size);
    if (r != rank) buf[i] = cl.map_shared_rank(buf, r)[i];
  }
}

// y[j] = sum_i cB[i] invBT[j, i] for the CTA's rows: one warp per row.
__device__ void duals(const float* invBT, const float* s_cB, float* s_y,
                      int m, Range rows) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int j = rows.lo + w; j < rows.hi; j += kWarps) {
    const float* row = invBT + (size_t)j * m;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = l; i < m; i += 32) acc += ldcg(row + i) * s_cB[i];
    acc = lp::warp_sum(acc);
    if (l == 0) s_y[j] = acc;
  }
}

// s_d[i] = sum_j s_col[j] invBT[j, i] for i in the CTA's slice. A slice
// narrower than the block splits the rows into G groups whose partials
// are added in group order. Ends synced.
__device__ void direction(const float* invBT, const float* s_col, float* s_d,
                          float* s_tmp, int m, Range cols) {
  const int w = cols.hi - cols.lo;
  int G = w > 0 ? kThreads / w : 1;
  G = G < 1 ? 1 : (G > 8 ? 8 : G);
  if (G == 1) {
    for (int i = cols.lo + threadIdx.x; i < cols.hi; i += kThreads) {
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < m; ++j)
        acc += s_col[j] * ldcg(invBT + (size_t)j * m + i);
      s_d[i] = acc;
    }
  } else {
    const int chunk = (m + G - 1) / G;
    const int t = threadIdx.x;
    if (t < w * G) {
      const int i = cols.lo + t % w, g = t / w;
      const int j0 = min(g * chunk, m), j1 = min(j0 + chunk, m);
      float acc = 0.0f;
#pragma unroll 4
      for (int j = j0; j < j1; ++j)
        acc += s_col[j] * ldcg(invBT + (size_t)j * m + i);
      s_tmp[t] = acc;
    }
    __syncthreads();
    for (int k = t; k < w; k += kThreads) {
      float acc = s_tmp[k];
      for (int g = 1; g < G; ++g) acc += s_tmp[g * w + k];
      s_d[cols.lo + k] = acc;
    }
  }
  __syncthreads();
}

// At most 48 registers a thread, so 5 CTAs may share an SM: with 4, the
// card holds only 62 clusters at (2048, 4096) (its GPCs do not pack 8-CTA
// clusters evenly), and B = 64 lanes ran in two waves.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 5)
    solve_segment_stream_kernel(
        const float* __restrict__ A_all, const float* __restrict__ c_all,
        const float* __restrict__ apen_all, float* invBT_all, float* bfs_all,
        float* cB_all, int* basis_all, float* pen_all, int* iters_all,
        int* status_all, int m, int n, int seg_len, int maxiters,
        float opt_tol, float pivot_tol, float feas_tol, int dual, int pricing,
        int packed, int stall_limit) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  extern __shared__ float smem[];
  __shared__ Scratch red;
  __shared__ Part s_part[4];  // [0] leaving (dual), [1] entering, [2] ratio
                              // (primal) / unused, [3] entry objective
  __shared__ Sel s_sel;
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x / kCluster;
  const float* A = A_all + lane * m * n;
  const float* apen = apen_all + lane * n;
  float* invBT = invBT_all + lane * m * m;
  const Range rows = slice_of(rank, m);  // rows of invBT, entries of bfs/d
  const Range cols = slice_of(rank, n);  // columns of A
  const int ml = slice_len(m), nl = slice_len(n);

  // whole vectors (indexed globally)
  float* s_y = smem;        // y; own rows written here, the rest gathered
  float* s_d = s_y + m;     // d; own slice written here, the rest gathered
  float* s_cB = s_d + m;    // c_B, an identical copy in every CTA
  float* s_col = s_cB + m;  // entering column / dual row w / eta vector u
  // own slices (indexed from the slice start)
  float* s_bfs = s_col + m;
  int* s_basis = reinterpret_cast<int*>(s_bfs + ml);
  float* s_colL = reinterpret_cast<float*>(s_basis + ml);  // invBT[j, l]
  float* s_c = s_colL + ml;
  float* s_pen = s_c + nl;
  float* s_r = s_pen + nl;
  float* s_urow = s_r + nl;
  float* s_tmp = s_urow + nl;  // kThreads floats

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

  // segment-local stall state; the entry objective is a cluster sum
  float z = 0.0f;
  {
    float part = 0.0f;
    if (track)
      for (int i = rows.lo + tid; i < rows.hi; i += kThreads)
        part += s_cB[i] * s_bfs[i - rows.lo];
    part = block_sum(part, red);
    if (tid == 0) {
      s_part[3] = Part{kIntMax, m, m, 0, INFINITY, 0.0f, part, 0.0f};
    }
  }
  cl.sync();  // every CTA has started and published its partial
  if (tid == 0) s_sel = combine(cl, &s_part[3], m);
  __syncthreads();
  if (track) z = s_sel.sum;
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

    if (dual) {
      // ---- leaving partial over the own bfs slice; duals of own rows ---
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
        if (tid == 0) s_part[0] = Part{kf.x, kf.y, hot, 0, val, 0.0f, 0.0f, 0.0f};
      }
      duals(invBT, s_cB, s_y, m, rows);
      __syncthreads();
      cl.sync();  // (a)
      bool viable;
      if (tid == 0) {
        Sel s = combine(cl, &s_part[0], m);
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
        // the owner changes its bfs / basis only after (c)
        const int o = owner_of(l, m);
        const Range orow = slice_of(o, m);
        s.bfs = cl.map_shared_rank(s_bfs, o)[l - orow.lo];
        s.basis = cl.map_shared_rank(s_basis, o)[l - orow.lo];
        s_sel = s;
      }
      gather(cl, s_y, m, rank);
      __syncthreads();
      leave = s_sel.key;
      viable = s_sel.hot != 0;
      bfs_l = s_sel.bfs + 0.0f;
      leaving_col = s_sel.basis;

      // ---- dual row urow = B^-1[leave, :] A and r = c - y A (own cols) -
      for (int j = tid; j < m; j += kThreads)
        s_col[j] = ldcg(invBT + (size_t)j * m + leave);
      __syncthreads();
      for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
        float au = 0.0f, ay = 0.0f;
#pragma unroll 8
        for (int j = 0; j < m; ++j) {
          const float a = __ldg(A + (size_t)j * n + k);
          au += s_col[j] * a;
          ay += s_y[j] * a;
        }
        s_urow[k - cols.lo] = au;
        s_r[k - cols.lo] = s_c[k - cols.lo] - ay;
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
        if (tid == 0) s_part[1] = Part{key, n, hot, 0, val, 0.0f, 0.0f, 0.0f};
      }
      cl.sync();  // (b)
      if (tid == 0) {
        Sel s = combine(cl, &s_part[1], n);
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
        const int o = owner_of(e, n);
        s.c_enter = cl.map_shared_rank(s_c, o)[e - slice_of(o, n).lo];
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

      // ---- direction slice ---------------------------------------------
      for (int j = tid; j < m; j += kThreads)
        s_col[j] = __ldg(A + (size_t)j * n + enter);
      __syncthreads();
      direction(invBT, s_col, s_d, s_tmp, m, rows);
      cl.sync();  // (c)
    } else {
      // ---- duals of own rows, gathered whole ---------------------------
      duals(invBT, s_cB, s_y, m, rows);
      __syncthreads();
      cl.sync();  // (a)
      gather(cl, s_y, m, rank);
      __syncthreads();

      // ---- pricing of own columns: r = (c - y A) + pen -----------------
      for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
        float ay = 0.0f;
#pragma unroll 8
        for (int j = 0; j < m; ++j) ay += s_y[j] * __ldg(A + (size_t)j * n + k);
        s_r[k - cols.lo] = (s_c[k - cols.lo] - ay) + s_pen[k - cols.lo];
      }
      __syncthreads();

      // ---- entering partial --------------------------------------------
      {
        int key = kIntMax, first = n, hot = n;
        float val = INFINITY;
        for (int k = cols.lo + tid; k < cols.hi; k += kThreads) {
          const float r = s_r[k - cols.lo];
          if (r < -opt_tol) {
            if (packed && pricing == 1) key = min(key, pack_key(r, k, bits_n, true));
            first = min(first, k);
          }
          val = nan_min(val, r);
        }
        const int2 kf = block_min2(key, first, red);
        if (dantzig && !(packed && pricing == 1)) {
          val = block_min(val, red);
          for (int k = cols.lo + tid; k < cols.hi; k += kThreads)
            if (s_r[k - cols.lo] == val) hot = min(hot, k);
          hot = block_min2(hot, kIntMax, red).x;
        }
        if (tid == 0) s_part[1] = Part{kf.x, kf.y, hot, 0, val, 0.0f, 0.0f, 0.0f};
      }
      cl.sync();  // (b)
      if (tid == 0) {
        Sel s = combine(cl, &s_part[1], n);
        bool elig;
        int e;
        if (packed && pricing == 1) {
          elig = s.key != kIntMax;
          e = use_bland ? s.first : (s.key & lo_n);
        } else if (dantzig) {
          elig = s.val < -opt_tol;
          e = use_bland ? s.first : s.hot;
        } else {
          e = s.first;
          elig = e < n;
        }
        if (!elig) e = 0;
        s.key = e;
        s.hot = elig;
        // the owner rewrites r only after the next (a)
        const int o = owner_of(e, n);
        const int off = e - slice_of(o, n).lo;
        s.c_enter = cl.map_shared_rank(s_c, o)[off];
        s.r_enter = cl.map_shared_rank(s_r, o)[off];
        s_sel = s;
      }
      __syncthreads();
      enter = s_sel.key;
      const bool eligible = s_sel.hot != 0;
      c_enter = s_sel.c_enter + 0.0f;
      r_enter = s_sel.r_enter + 0.0f;

      // ---- direction slice and ratio partial ---------------------------
      for (int j = tid; j < m; j += kThreads)
        s_col[j] = __ldg(A + (size_t)j * n + enter);
      __syncthreads();
      direction(invBT, s_col, s_d, s_tmp, m, rows);
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
                           mine ? s_bfs[win - rows.lo] : 0.0f, 0.0f, 0.0f};
        }
      }
      cl.sync();  // (c)
      if (tid == 0) {
        Sel s = combine(cl, &s_part[2], m);
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
        take_winner(cl, &s_part[2], l, m, s);
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

    // ---- pivot: eta update of own rows, bfs slice and bookkeeping -------
    gather(cl, s_d, m, rank);
    __syncthreads();
    float dz = 0.0f;
    if (do_pivot) {
      // d_l read as the reference's masked sum reads it (-0.0 -> +0.0)
      const float d_l = s_d[leave] + 0.0f;
      const float safe = d_l == 0.0f ? 1.0f : d_l;
      for (int i = tid; i < m; i += kThreads)
        s_col[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
      for (int j = rows.lo + tid; j < rows.hi; j += kThreads)
        s_colL[j - rows.lo] = ldcg(invBT + (size_t)j * m + leave);
      __syncthreads();
      const int w = tid >> 5, l = tid & 31;
      for (int j = rows.lo + w; j < rows.hi; j += kWarps) {
        const float cj = s_colL[j - rows.lo];
        float* row = invBT + (size_t)j * m;
#pragma unroll 4
        for (int i = l; i < m; i += 32) row[i] = ldcg(row + i) + cj * s_col[i];
      }
      __threadfence();  // own rows visible to the cluster before the next (a)
      for (int i = rows.lo + tid; i < rows.hi; i += kThreads)
        s_bfs[i - rows.lo] = s_bfs[i - rows.lo] + s_col[i] * bfs_l;
      __syncthreads();
      if (tid == 0) {
        if (leave >= rows.lo && leave < rows.hi) s_basis[leave - rows.lo] = enter;
        s_cB[leave] = c_enter;
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

size_t smem_bytes(int m, int n) {
  const size_t ml = (m + kCluster - 1) / kCluster;
  const size_t nl = (n + kCluster - 1) / kCluster;
  return (4 * (size_t)m + 3 * ml + 4 * nl + kThreads) * sizeof(float);
}

}  // namespace

extern "C" size_t lp_solve_segment_stream_smem(int m, int n) {
  return smem_bytes(m, n);
}

// How many 8-CTA clusters of this kernel the device holds at once for
// lanes of (m, n) (a batch of more lanes runs in several waves); < 0 is a
// negated CUDA error.
extern "C" int lp_solve_segment_stream_max_clusters(int m, int n) {
  const size_t smem = smem_bytes(m, n);
  cudaError_t e = cudaFuncSetAttribute(
      solve_segment_stream_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 1024, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, solve_segment_stream_kernel,
                                     &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

extern "C" int lp_solve_segment_stream(
    const float* A, const float* c, const float* apen, float* invBT,
    float* bfs, float* cB, int* basis, float* pen, int* iters, int* status,
    int B, int m, int n, int seg_len, int maxiters, float opt_tol,
    float pivot_tol, float feas_tol, int dual, int pricing, int packed,
    int stall_limit, void* stream) {
  if (pricing < 0 || pricing > 1 || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m, n);
  if (smem + sizeof(Part) * 4 + sizeof(Sel) + sizeof(Scratch) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // always: static shared memory counts against the 48 KB default too
  const cudaError_t e = cudaFuncSetAttribute(
      solve_segment_stream_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  solve_segment_stream_kernel<<<B * kCluster, kThreads, smem,
                                (cudaStream_t)stream>>>(
      A, c, apen, invBT, bfs, cB, basis, pen, iters, status, m, n, seg_len,
      maxiters, opt_tol, pivot_tol, feas_tol, dual, pricing, packed,
      stall_limit);
  return (int)cudaGetLastError();
}
