// The row-split streaming primitives of the whole-segment kernels that keep
// a lane in device memory: kernel 3 (solve_segment_stream.cu) and kernel 4's
// streaming branch (solve_bounded_segment.cu). One thread-block cluster runs
// a lane; CTA k owns whole bands of the lane's kBands fixed row bands of
// ceil(m / kBands) rows, with those rows of A and of the transposed basis
// inverse invBT, and streams them from device memory each pass:
//   * column passes (col_pass_ring / col_pass_scalar) give the CTA's partial
//     of a product over its rows for every column, summed band by band and
//     then over the CTA's bands as a balanced tree that tree_sum /
//     reduce_slice continue over the CTAs through distributed shared memory,
//     so a lane's bits do not depend on the cluster size;
//   * row passes (row_pass_ring / row_pass_scalar) give the duals of the
//     CTA's rows, or rewrite its rows in the eta update and yield the next
//     duals from the new rows;
//   * selections are per-CTA partials (Part) combined in rank order
//     (combine), and vectors split by rows are gathered (gather).
// Where the rows are 16-byte aligned the passes stream through a ring in
// shared memory filled by cp.async.bulk copies that complete on mbarriers
// (the Pipe); other shapes take scalar ld.global.cg loads summed in the same
// order. See solve_segment_stream.cu's header for the design.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace lps {

using lp::kIntMax;
using lp::kThreads;
using lp::kWarps;
using lp::nan_min;
constexpr size_t kMaxSmem = 232448;  // bytes a Hopper block may use
constexpr int kMaxStages = 8;        // block-ring stages
constexpr int kMaxWarpStages = 4;    // stages of one warp's ring
constexpr int kSumBlock = 32;        // rows per partial sum of a column pass
constexpr int kBands = 8;            // row bands of a lane: the units of every sum
constexpr int kLag = 1;              // tiles between a stage's last read and its refill

// One CTA's partial of a selection.
struct Part {
  int key;    // min packed key, or kIntMax
  int first;  // lowest eligible index, or the size
  int hot;    // lowest index attaining `val`, or the size
  int basis;  // basis entry at the CTA's local winner (primal ratio test)
  float val;  // NaN-propagating min value, or +inf
  float bfs;  // bfs entry at the local winner (primal ratio test)
};

// The cluster's reduction of a selection, plus the scalars it broadcasts.
struct Sel {
  int key, first, hot, basis;
  float val, bfs;
  float c_enter, r_enter;
};

struct Range {
  int lo, hi;
};

// The shared-memory ring and its barriers, in both views.
struct Pipe {
  float* ring;
  unsigned long long* bbar;  // block view: S stages of stage_floats (full)
  unsigned long long* ebar;  // block view: the stages' `empty` barriers
  unsigned long long* wbar;  // warp view: per warp D stages of C floats
  uint32_t bphase, wphase;   // parity bit per stage of the next wait
  int S, stage_floats, D, C;
};

// A CTA's slice of `size` entries is kBands / CL whole bands of
// ceil(size / kBands), so the bands are the same at every cluster size.
template <int CL>
__device__ __forceinline__ int slice_len(int size) {
  return (kBands / CL) * ((size + kBands - 1) / kBands);
}

template <int CL>
__device__ __forceinline__ Range slice_of(int rank, int size) {
  const int len = slice_len<CL>(size);
  return {min(rank * len, size), min((rank + 1) * len, size)};
}

template <int CL>
__device__ __forceinline__ int owner_of(int idx, int size) {
  return idx / slice_len<CL>(size);
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

// ---- mbarrier and bulk-copy primitives -----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned; completion is counted on `bar`.
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src,
                                         uint32_t bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's generic-proxy writes before later async-proxy
// (bulk-copy) reads of the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// ---- cluster reductions ---------------------------------------------------

// Thread 0 combines the CTAs' partials in `slot`, in rank order. `size` is
// the default of `hot` when no CTA attains the min value.
template <int CL>
__device__ Sel combine(cooperative_groups::cluster_group& cl, Part* slot, int size) {
  Sel s;
  s.key = kIntMax;
  s.first = size;
  s.hot = size;
  s.basis = 0;
  s.val = INFINITY;
  s.bfs = 0.0f;
  s.c_enter = 0.0f;
  s.r_enter = 0.0f;
  for (int r = 0; r < CL; ++r) {
    const Part* p = cl.map_shared_rank(slot, r);
    s.key = min(s.key, p->key);
    s.first = min(s.first, p->first);
    s.val = nan_min(s.val, p->val);
  }
  for (int r = 0; r < CL; ++r) {
    const Part* p = cl.map_shared_rank(slot, r);
    if (p->val == s.val) s.hot = min(s.hot, p->hot);
  }
  return s;
}

// The winner's bfs / basis entries, carried by the owner's partial.
template <int CL>
__device__ void take_winner(cooperative_groups::cluster_group& cl, Part* slot, int leave,
                            int m, Sel& s) {
  const Part w = *cl.map_shared_rank(slot, owner_of<CL>(leave, m));
  s.bfs = w.bfs;
  s.basis = w.basis;
}

// dst[i] = (owner of i)'s src[i] for every i outside the CTA's own slice.
template <int CL>
__device__ void gather(cooperative_groups::cluster_group& cl, float* buf, int size,
                       unsigned rank) {
  for (int i = threadIdx.x; i < size; i += kThreads) {
    const unsigned r = (unsigned)owner_of<CL>(i, size);
    if (r != rank) buf[i] = cl.map_shared_rank(buf, r)[i];
  }
}

// ---- row passes: duals, and the eta update that yields the next duals -----
//
// One warp per row j of the CTA's slice. Lane l sums the entries
// i = l, l + 32, ... in order, then a shuffle tree: the same order in the
// standalone pass and the eta pass, on both branches. s_y and s_colL are
// indexed from the slice start.
//   ETA = false: y[j] = sum_i cB[i] invBT[j, i]
//   ETA = true:  invBT[j, i] += colL[j] u[i], then y[j] over the new row

template <bool ETA>
__device__ void row_pass_scalar(float* invBT, const float* s_cB,
                                const float* s_u, const float* s_colL,
                                float* s_y, int m, Range rows) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int j = rows.lo + w; j < rows.hi; j += kWarps) {
    float* row = invBT + (size_t)j * m;
    const float cj = ETA ? s_colL[j - rows.lo] : 0.0f;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = l; i < m; i += 32) {
      float v = ldcg(row + i);
      if (ETA) {
        v = v + cj * s_u[i];
        row[i] = v;
      }
      acc += v * s_cB[i];
    }
    acc = lp::warp_sum(acc);
    if (l == 0) s_y[j - rows.lo] = acc;
  }
}

// The same through the warp's own ring: the rows arrive in chunks of C
// floats by bulk copy; lane 0 refills a stage once the warp has read it.
template <bool ETA>
__device__ void row_pass_ring(float* invBT, const float* s_cB,
                              const float* s_u, const float* s_colL,
                              float* s_y, int m, Range rows, Pipe& pp) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int D = pp.D, C = pp.C;
  float* wring = pp.ring + (size_t)w * D * C;
  unsigned long long* bar = pp.wbar + w * kMaxWarpStages;
  const int span = rows.hi - rows.lo - w;
  const int nq = span > 0 ? (span + kWarps - 1) / kWarps : 0;  // rows of the warp
  const int nc = (m + C - 1) / C;                              // chunks a row
  const int T = nq * nc;

  auto issue = [&](int t) {  // lane 0 only
    const int q = t / nc, c = t - q * nc, s = t % D;
    const int j = rows.lo + w + q * kWarps;
    const uint32_t bytes = (uint32_t)min(C, m - c * C) * sizeof(float);
    mbar_expect(bar + s, bytes);
    bulk_g2s(wring + s * C, invBT + (size_t)j * m + (size_t)c * C, bytes,
             bar + s);
  };

  if (l == 0)
    for (int t = 0; t < min(D, T); ++t) issue(t);
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const int q = t / nc, c = t - q * nc, s = t % D;
    const int j = rows.lo + w + q * kWarps;
    const int base = c * C, len = min(C, m - base);
    mbar_wait(bar + s, (pp.wphase >> s) & 1u);
    pp.wphase ^= 1u << s;
    const float* buf = wring + s * C;
    if (c == 0) acc = 0.0f;
    if (ETA) {
      const float cj = s_colL[j - rows.lo];
      float* row = invBT + (size_t)j * m + base;
#pragma unroll 4
      for (int i = l; i < len; i += 32) {
        const float v = buf[i] + cj * s_u[base + i];
        row[i] = v;
        acc += v * s_cB[base + i];
      }
    } else {
#pragma unroll 4
      for (int i = l; i < len; i += 32) acc += buf[i] * s_cB[base + i];
    }
    if (c == nc - 1) {
      const float tot = lp::warp_sum(acc);
      if (l == 0) s_y[j - rows.lo] = tot;
    }
    __syncwarp();
    if (l == 0 && t + D < T) issue(t + D);
  }
}

// acc + a * b: fused (one rounding, as a library GEMV sums) or with the
// product rounded first (as the build's --fmad=false leaves a * b + c).
template <bool FMA>
__device__ __forceinline__ float madd(float a, float b, float acc) {
  return FMA ? fmaf(a, b, acc) : acc + a * b;
}

// ---- column passes: the CTA's partial of pricing and of the direction -----
//
// out0[k] = sum_j v0[j] G[j, k] over the `nrows` rows of G that the CTA
// owns (and out1 with v1 when NV == 2), for every k < ncols: one thread
// per column. NV == 3 is kernel 1's split-bf16 pricing: the three products
// of the halves of v0 and of G (taken in registers, exact in f32), yh Gh
// into out0, yh Gl into out1 and yl Gh into out2. The order of the sum is fixed by the lane's kBands row bands
// of `band` rows, not by the cluster size: the rows of a band in order, in
// partial sums of kSumBlock rows that are added up in order; then the CTA's
// NB = kBands / CL bands as a balanced tree, which reduce_slice continues
// over the CTAs. G points at the CTA's first row (the start of a band);
// `ld` is the row length; v0 and v1 are indexed from that row. Ends synced.

// The band total `a` joins the tree of the CTA's bands as band number `bi`.
template <int NB>
__device__ __forceinline__ void close_band(float& a, float& prev, float& tot,
                                           int bi) {
  if (NB == 1) {
    tot = a;
  } else if (!(bi & 1)) {
    prev = a;
  } else {
    const float pair = prev + a;
    tot = (NB == 2 || bi == 1) ? pair : tot + pair;
  }
  a = 0.0f;
}

// One row's terms: x = G[j, k] against v0[j] (and v1[j]), or the split
// products of their halves.
template <int NV, bool FMA>
__device__ __forceinline__ void add_terms(float y0, float y1, float x,
                                          float& p0, float& p1, float& p2) {
  if constexpr (NV == 3) {
    float yh, yl, xh, xl;
    lp::bf16_split(y0, yh, yl);
    lp::bf16_split(x, xh, xl);
    p0 = p0 + yh * xh;
    p1 = p1 + yh * xl;
    p2 = p2 + yl * xh;
  } else {
    p0 = madd<FMA>(y0, x, p0);
    if (NV == 2) p1 = madd<FMA>(y1, x, p1);
  }
}

template <int NV, bool FMA, int NB>
__device__ void col_pass_scalar(const float* G, int ld, int ncols, int nrows,
                                int band, const float* v0, const float* v1,
                                float* out0, float* out1, float* out2) {
  for (int k = threadIdx.x; k < ncols; k += kThreads) {
    const float* g = G + k;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, prev0 = 0.0f, prev1 = 0.0f,
          prev2 = 0.0f, tot0 = 0.0f, tot1 = 0.0f, tot2 = 0.0f;
    int j = 0;
    for (int bi = 0; bi < NB; ++bi) {
      const int jend = min(j + band, nrows);  // an empty band sums to 0
      while (j < jend) {
        const int bend = min(j + kSumBlock, jend);
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
#pragma unroll 8
        for (; j < bend; ++j)
          add_terms<NV, FMA>(v0[j], NV == 2 ? v1[j] : 0.0f,
                             ldcg(g + (size_t)j * ld), p0, p1, p2);
        a0 += p0;
        if (NV >= 2) a1 += p1;
        if (NV == 3) a2 += p2;
      }
      close_band<NB>(a0, prev0, tot0, bi);
      if (NV >= 2) close_band<NB>(a1, prev1, tot1, bi);
      if (NV == 3) close_band<NB>(a2, prev2, tot2, bi);
    }
    out0[k] = tot0;
    if (NV >= 2) out1[k] = tot1;
    if (NV == 3) out2[k] = tot2;
  }
  __syncthreads();
}

// The same through the block's ring, in sweeps of up to 256 * KPT columns:
// a stage holds as many row segments of the sweep as fit, and warp 0 issues
// one bulk copy per segment. The copies are as long as the registers allow
// (8 KB at 8 columns a thread): the card moves about one bulk copy per 200
// cycles and SM whatever its length. No block barrier per stage: each warp
// arrives on the stage's `empty` barrier when it has read it, and warp 0
// refills the stage it read kLag tiles ago, which by then every warp has
// left, so the refill neither waits nor holds the other warps up.
template <int NV, int KPT, bool FMA, int NB>
__device__ void col_pass_ring(const float* G, int ld, int ncols, int nrows,
                              int band, const float* v0, const float* v1,
                              float* out0, float* out1, float* out2,
                              Pipe& pp) {
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int S = pp.S, SF = pp.stage_floats;
  const int lag = min(kLag, S - 1);
  const int wc_max = min(SF, kThreads * KPT) & ~3;
  for (int cc = 0; cc < ncols; cc += wc_max) {
    const int wc = min(wc_max, ncols - cc);      // columns of this sweep
    const int rps = max(min(SF / wc, nrows), 1);  // rows per stage
    const int T = (nrows + rps - 1) / rps;
    const int kpt = (wc + kThreads - 1) / kThreads;
    const float* g = G + cc;

    auto issue = [&](int t) {  // warp 0
      const int s = t % S, j0 = t * rps, nr = min(rps, nrows - j0);
      if (l == 0)
        mbar_expect(pp.bbar + s, (uint32_t)(nr * wc) * sizeof(float));
      __syncwarp();
      for (int r = l; r < nr; r += 32)
        bulk_g2s(pp.ring + (size_t)s * SF + r * wc, g + (size_t)(j0 + r) * ld,
                 (uint32_t)wc * sizeof(float), pp.bbar + s);
    };

    if (warp == 0)
      for (int t = 0; t < min(S, T); ++t) issue(t);
    float p0[KPT], p1[KPT], p2[KPT], a0[KPT], a1[KPT], a2[KPT], prev0[KPT],
        prev1[KPT], prev2[KPT], tot0[KPT], tot1[KPT], tot2[KPT];
#pragma unroll
    for (int q = 0; q < KPT; ++q)
      p0[q] = p1[q] = p2[q] = a0[q] = a1[q] = a2[q] = prev0[q] = prev1[q] =
          prev2[q] = tot0[q] = tot1[q] = tot2[q] = 0.0f;
    int jb = 0, bi = 0;  // rows into the band, bands into the CTA's rows
    for (int t = 0; t < T; ++t) {
      const int s = t % S, j0 = t * rps, nr = min(rps, nrows - j0);
      mbar_wait(pp.bbar + s, (pp.bphase >> s) & 1u);
      const float* buf = pp.ring + (size_t)s * SF;
      for (int r = 0; r < nr;) {
        // the rows up to the next end of a kSumBlock block, of the band or
        // of the stage, in one tight loop
        const int run =
            min(nr - r, min(kSumBlock - (jb & (kSumBlock - 1)), band - jb));
        const int rend = r + run;
#pragma unroll 4
        for (; r < rend; ++r) {
          const float y0 = v0[j0 + r];
          const float y1 = NV == 2 ? v1[j0 + r] : 0.0f;
          const float* brow = buf + r * wc;
#pragma unroll
          for (int q = 0; q < KPT; ++q) {
            const int k = tid + q * kThreads;
            if (q < kpt && k < wc)
              add_terms<NV, FMA>(y0, y1, brow[k], p0[q], p1[q], p2[q]);
          }
        }
        jb += run;
        const bool band_end = jb == band || j0 + r == nrows;
        if ((jb & (kSumBlock - 1)) == 0 || band_end) {
#pragma unroll
          for (int q = 0; q < KPT; ++q) {
            a0[q] += p0[q];
            p0[q] = 0.0f;
            if (NV >= 2) {
              a1[q] += p1[q];
              p1[q] = 0.0f;
            }
            if (NV == 3) {
              a2[q] += p2[q];
              p2[q] = 0.0f;
            }
          }
        }
        if (band_end) {
#pragma unroll
          for (int q = 0; q < KPT; ++q) {
            close_band<NB>(a0[q], prev0[q], tot0[q], bi);
            if (NV >= 2) close_band<NB>(a1[q], prev1[q], tot1[q], bi);
            if (NV == 3) close_band<NB>(a2[q], prev2[q], tot2[q], bi);
          }
          jb = 0;
          ++bi;
        }
      }
      __syncwarp();
      if (l == 0) mbar_arrive(pp.ebar + s);  // this warp has read the stage
      pp.bphase ^= 1u << s;  // both barriers of the stage: its next use
      const int tr = t - lag;  // the tile whose stage warp 0 refills now
      if (warp == 0 && tr >= 0 && tr + S < T) {
        const int sr = tr % S;  // used once since, so its bit has flipped
        mbar_wait(pp.ebar + sr, ((pp.bphase >> sr) & 1u) ^ 1u);
        issue(tr + S);
      }
    }
    for (; bi < NB; ++bi) {  // bands past the CTA's last row sum to 0
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        close_band<NB>(a0[q], prev0[q], tot0[q], bi);
        if (NV >= 2) close_band<NB>(a1[q], prev1[q], tot1[q], bi);
        if (NV == 3) close_band<NB>(a2[q], prev2[q], tot2[q], bi);
      }
    }
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const int k = tid + q * kThreads;
      if (q < kpt && k < wc) {
        out0[cc + k] = tot0[q];
        if (NV >= 2) out1[cc + k] = tot1[q];
        if (NV == 3) out2[cc + k] = tot2[q];
      }
    }
    __syncthreads();  // every warp has left the ring; the partials are written
  }
}

template <bool RING, int NV, bool FMA, int NB>
__device__ __forceinline__ void col_pass(const float* G, int ld, int ncols,
                                         int nrows, int band, const float* v0,
                                         const float* v1, float* out0,
                                         float* out1, Pipe& pp,
                                         float* out2 = nullptr) {
  if (RING)
    col_pass_ring<NV, NV == 1 ? 8 : 4, FMA, NB>(G, ld, ncols, nrows, band, v0,
                                                v1, out0, out1, out2, pp);
  else
    col_pass_scalar<NV, FMA, NB>(G, ld, ncols, nrows, band, v0, v1, out0, out1,
                                 out2);
}

template <bool RING, bool ETA>
__device__ __forceinline__ void row_pass(float* invBT, const float* s_cB,
                                         const float* s_u, const float* s_colL,
                                         float* s_y, int m, Range rows,
                                         Pipe& pp) {
  if (RING)
    row_pass_ring<ETA>(invBT, s_cB, s_u, s_colL, s_y, m, rows, pp);
  else
    row_pass_scalar<ETA>(invBT, s_cB, s_u, s_colL, s_y, m, rows);
}

// Entry k of the CTAs' partials LO .. LO + N - 1, added as a balanced tree.
template <int LO, int N>
__device__ __forceinline__ float tree_sum(cooperative_groups::cluster_group& cl, float* src,
                                          int k) {
  if constexpr (N == 1)
    return cl.map_shared_rank(src, LO)[k];
  else
    return tree_sum<LO, N / 2>(cl, src, k) +
           tree_sum<LO + N / 2, N / 2>(cl, src, k);
}

// dst[k - lo] = the sum over the CTAs of their partial src[k], for k in
// [lo, hi): the tree over the lane's kBands bands that the column passes
// began within each CTA, so the bits do not depend on the cluster size.
template <int CL>
__device__ void reduce_slice(cooperative_groups::cluster_group& cl, float* src, float* dst,
                             Range r) {
  for (int k = r.lo + threadIdx.x; k < r.hi; k += kThreads)
    dst[k - r.lo] = tree_sum<0, CL>(cl, src, k);
}

}  // namespace lps
