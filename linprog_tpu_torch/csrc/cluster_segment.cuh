// Helpers of the cluster-resident whole-segment kernels (solve_segment.cu,
// solve_bounded_segment.cu): one lane runs on a thread-block cluster of CL
// CTAs, and the lane's A[m, n] and transposed basis inverse invBT[m, m] stay
// in the cluster's shared memory for the whole segment.
//
// Geometry. A lane's rows are cut into kBands fixed bands of ceil(m / kBands)
// rows, whatever the cluster size; CTA `rank` owns kBands / CL whole bands
// (its rows of A and of invBT, and the duals of those rows; it writes back
// the same share of the lane's vectors). Every dot
// product over rows is summed band by band (a band's rows in order), then
// the band totals as ONE balanced tree: within a CTA over its own bands,
// then across the CTAs through distributed shared memory. So a lane's bits
// do not depend on the cluster size, and the launch plan may take any built
// size. Each CTA adds up the partials of every entry it needs itself and
// runs every selection over whole vectors (the same in every CTA), so an
// iteration needs only two cluster barriers: one after the partials of the
// pricing pass, one after those of the direction.
//
// Loading. At launch each CTA copies its rows of A and invBT into shared
// memory once: one bulk copy (cp.async.bulk, completion on an mbarrier) per
// piece of at most kCopyBytes where the rows are 16-byte aligned, plain
// loads otherwise (load_resident_rows: the leading columns of each row of
// A, for kernel 1's unit layout). invBT is written back once at exit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace lpc {

namespace cg = cooperative_groups;

using lp::kIntMax;
using lp::nan_min;

// threads of a CTA: one CTA holds an SM's shared memory, so its own warps
// are all that hide the latency of the shared-memory passes
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

constexpr int kBands = 16;           // row bands of a lane: the units of every sum
constexpr uint32_t kCopyBytes = 65536;  // bytes of one bulk copy at most
constexpr size_t kMaxSmem = 232448;  // bytes a Hopper block may use

struct Range {
  int lo, hi;
};

// A CTA's slice of `size` entries: kBands / CL whole bands of
// ceil(size / kBands).
template <int CL>
__host__ __device__ __forceinline__ int slice_len(int size) {
  return (kBands / CL) * ((size + kBands - 1) / kBands);
}

template <int CL>
__device__ __forceinline__ Range slice_of(int rank, int size) {
  const int len = slice_len<CL>(size);
  return {min(rank * len, size), min((rank + 1) * len, size)};
}

__device__ __forceinline__ int band_len(int m) {
  return (m + kBands - 1) / kBands;
}

// ---- mbarrier and bulk-copy primitives -----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

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

__device__ __forceinline__ void bulk_g2s(float* dst, const float* src,
                                         uint32_t bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copy `nA` floats from gA to sA and `nB` from gB to sB (a CTA's rows of A
// and of invBT, each contiguous in device memory). `aligned`: both pieces
// start on 16 bytes and hold a multiple of 4 floats, so bulk copies carry
// them; otherwise every thread loads. `bar` is initialised with count 1.
// Ends synced.
__device__ __forceinline__ void load_resident(float* sA, const float* gA,
                                              int nA, float* sB,
                                              const float* gB, int nB,
                                              bool aligned,
                                              unsigned long long* bar) {
  if (aligned) {
    if (threadIdx.x == 0) {
      const uint32_t total = (uint32_t)(nA + nB) * sizeof(float);
      mbar_expect(bar, total);
      const float* src[2] = {gA, gB};
      float* dst[2] = {sA, sB};
      const int cnt[2] = {nA, nB};
      for (int p = 0; p < 2; ++p) {
        const uint32_t bytes = (uint32_t)cnt[p] * sizeof(float);
        for (uint32_t off = 0; off < bytes; off += kCopyBytes) {
          const uint32_t len = min(kCopyBytes, bytes - off);
          bulk_g2s(dst[p] + off / 4, src[p] + off / 4, len, bar);
        }
      }
    }
    mbar_wait(bar, 0u);
  } else {
    for (int i = threadIdx.x; i < nA; i += kThreads) sA[i] = __ldg(gA + i);
    for (int i = threadIdx.x; i < nB; i += kThreads) sB[i] = gB[i];
  }
  __syncthreads();
}

// Copy the leading `ncols` floats of `nrows` rows of gA (row length `ld`)
// to sA (row length `ncols`), and `nB` floats from gB to sB. `aligned`: ld,
// ncols and nB are multiples of 4 floats and both pieces start on 16 bytes,
// so bulk copies carry gB while every thread loads the rows of gA by 16
// bytes (on an H100, a bulk copy a row issued one by one loads 64 rows of
// 1 KB slower than the dense layout's two copies of 64 KB); otherwise
// every thread loads.
// `bar` is initialised with count 1. Ends synced.
__device__ __forceinline__ void load_resident_rows(
    float* sA, const float* gA, int nrows, int ld, int ncols, float* sB,
    const float* gB, int nB, bool aligned, unsigned long long* bar) {
  if (aligned) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)nB * sizeof(float);
      mbar_expect(bar, bytes);
      for (uint32_t off = 0; off < bytes; off += kCopyBytes)
        bulk_g2s(sB + off / 4, gB + off / 4, min(kCopyBytes, bytes - off),
                 bar);
    }
    const int q = ncols / 4;
    for (int i = threadIdx.x; i < nrows * q; i += kThreads)
      reinterpret_cast<float4*>(sA)[i] = __ldg(
          reinterpret_cast<const float4*>(gA + (size_t)(i / q) * ld) + i % q);
    mbar_wait(bar, 0u);
  } else {
    for (int i = threadIdx.x; i < nrows * ncols; i += kThreads)
      sA[i] = __ldg(gA + (size_t)(i / ncols) * ld + i % ncols);
    for (int i = threadIdx.x; i < nB; i += kThreads) sB[i] = gB[i];
  }
  __syncthreads();
}

// acc + a * b: fused (one rounding, as a library GEMV sums) or with the
// product rounded first (the build's --fmad=false).
template <bool FMA>
__device__ __forceinline__ float madd(float a, float b, float acc) {
  return FMA ? fmaf(a, b, acc) : acc + a * b;
}

// The balanced tree over v[LO .. LO + N).
template <int LO, int N>
__device__ __forceinline__ float tree(const float* v) {
  if constexpr (N == 1)
    return v[LO];
  else
    return tree<LO, N / 2>(v) + tree<LO + N / 2, N / 2>(v);
}

// ---- column pass: the CTA's partial of a product over its own rows ---------
//
// out0[k] = sum_j v0[j] G[j, k] over the CTA's NB = kBands / CL bands of
// `band` rows (its first `nrows` rows of G, which lies in shared memory with
// row length `ld`), for every k < ncols; and out1 with v1 when NV == 2. A
// band's rows are summed in order, then the NB band totals as the balanced
// tree that tree_sum continues over the CTAs. A thread takes KPT
// columns a sweep. Ends synced.
template <int NV, bool FMA, int NB, int KPT>
__device__ void col_pass(const float* G, int ld, int ncols, int nrows,
                         int band, const float* v0, const float* v1,
                         float* out0, float* out1) {
  for (int cc = 0; cc < ncols; cc += kThreads * KPT) {
    float t0[KPT][NB], t1[KPT][NB];
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      const int jlo = min(bi * band, nrows), jhi = min(jlo + band, nrows);
      float a0[KPT], a1[KPT];
#pragma unroll
      for (int q = 0; q < KPT; ++q) a0[q] = a1[q] = 0.0f;
#pragma unroll 2
      for (int j = jlo; j < jhi; ++j) {
        const float y0 = v0[j];
        const float y1 = NV == 2 ? v1[j] : 0.0f;
        const float* row = G + (size_t)j * ld + cc + threadIdx.x;
#pragma unroll
        for (int q = 0; q < KPT; ++q) {
          if (cc + (int)threadIdx.x + q * kThreads < ncols) {
            const float x = row[q * kThreads];
            a0[q] = madd<FMA>(y0, x, a0[q]);
            if (NV == 2) a1[q] = madd<FMA>(y1, x, a1[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        t0[q][bi] = a0[q];
        t1[q][bi] = a1[q];
      }
    }
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const int k = cc + threadIdx.x + q * kThreads;
      if (k < ncols) {
        out0[k] = tree<0, NB>(t0[q]);
        if (NV == 2) out1[k] = tree<0, NB>(t1[q]);
      }
    }
  }
  __syncthreads();
}

// ---- unit columns: col_pass's partials of columns with one nonzero ------------
//
// Column k = n_d + u of the lane's A holds a[u] at row r[u] and zeros
// elsewhere, and only the leading n_d columns lie in shared memory. Over
// the CTA's rows col_pass sums +0 + v[j] * 0 on every row but r[u]: +-0
// where v[j] is finite, which leaves the sum alone (a -0 product becomes
// +0), and NaN where it is not. So its partial is +0 + v[r] a[u] where
// r[u] is an own row and +0 where it is not, while no other own v[j] is
// infinite or NaN; the canonical NaN where one is (v[r] = +-inf alone gives
// +-inf, as col_pass does). out0[k] from v0, and out1[k] from v1 when
// NV == 2, for n_d <= k < n; v indexed from the CTA's first row `row_lo`.
// The threads that the col_pass over the held columns leaves idle (those
// from n_d on, where n_d < kThreads) take the unit columns. Does not sync:
// that col_pass follows and ends synced.

// The one own row j < nrows whose v[j] is not finite, -1 where none is,
// -2 where two or more are; each warp looks at every row.
__device__ __forceinline__ int nonfinite_row(const float* v, int nrows) {
  int count = 0, at = -1;
  for (int j = threadIdx.x & 31; j < nrows; j += 32)
    if (!isfinite(v[j])) {
      ++count;
      at = j;
    }
  count = __reduce_add_sync(lp::kFullMask, count);
  at = __reduce_max_sync(lp::kFullMask, at);
  return count == 0 ? -1 : count == 1 ? at : -2;
}

template <int NV>
__device__ void unit_pass(const int* s_urow, const float* s_uval, int n_d,
                          int n, int row_lo, int nrows, const float* v0,
                          const float* v1, float* out0, float* out1) {
  const int bad0 = nonfinite_row(v0, nrows);
  const int bad1 = NV == 2 ? nonfinite_row(v1, nrows) : -1;
  const float nan = __int_as_float(0x7fffffff);
  const int idle = kThreads - n_d;
  const int first = idle > 0 ? (int)threadIdx.x - n_d : (int)threadIdx.x;
  const int step = idle > 0 ? idle : kThreads;
  for (int k = n_d + first; first >= 0 && k < n; k += step) {
    const int j = s_urow[k - n_d] - row_lo;
    const bool own = j >= 0 && j < nrows;
    const float a = s_uval[k - n_d];
    // NaN where a non-finite v meets a zero of the column
    out0[k] = bad0 == -2 || (bad0 >= 0 && bad0 != j)
                  ? nan
                  : (own ? 0.0f + v0[j] * a : 0.0f);
    if (NV == 2)
      out1[k] = bad1 == -2 || (bad1 >= 0 && bad1 != j)
                    ? nan
                    : (own ? 0.0f + v1[j] * a : 0.0f);
  }
}

// ---- split pricing: the three bf16 products of the pricing pass ------------
//
using lp::bf16_split;  // the halves of x, in registers (common.cuh)

// The CTA's partials of the split product y A over its own rows, for every
// k < ncols: hh[k] = sum_j yh[j] Ah[j, k], hl[k] = sum_j yh[j] Al[j, k],
// lh[k] = sum_j yl[j] Ah[j, k] (the lo * lo term is dropped). The halves
// are taken in registers from the resident f32 rows, so the pass reads no
// more than the f32 pass; a product of two halves is exact in f32. The
// order of every sum is col_pass's (a band's rows in order, then the
// balanced tree over the CTA's bands). Ends synced.
template <int NB>
__device__ void col_pass_split(const float* G, int ld, int ncols, int nrows,
                               int band, const float* v, float* hh, float* hl,
                               float* lh) {
  for (int k = threadIdx.x; k < ncols; k += kThreads) {
    float t0[NB], t1[NB], t2[NB];
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      const int jlo = min(bi * band, nrows), jhi = min(jlo + band, nrows);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll 2
      for (int j = jlo; j < jhi; ++j) {
        float yh, yl, xh, xl;
        bf16_split(v[j], yh, yl);
        bf16_split(G[(size_t)j * ld + k], xh, xl);
        a0 = a0 + yh * xh;
        a1 = a1 + yh * xl;
        a2 = a2 + yl * xh;
      }
      t0[bi] = a0;
      t1[bi] = a1;
      t2[bi] = a2;
    }
    hh[k] = tree<0, NB>(t0);
    hl[k] = tree<0, NB>(t1);
    lh[k] = tree<0, NB>(t2);
  }
  __syncthreads();
}

// Entry k of the CTAs' partials LO .. LO + N - 1, added as a balanced tree.
template <int LO, int N>
__device__ __forceinline__ float tree_sum(cg::cluster_group& cl, float* src,
                                          int k) {
  if constexpr (N == 1)
    return cl.map_shared_rank(src, LO)[k];
  else
    return tree_sum<LO, N / 2>(cl, src, k) +
           tree_sum<LO + N / 2, N / 2>(cl, src, k);
}

// ---- row pass: duals, and the eta update that yields the next duals -------
//
// One warp per own row j of the resident invBT slice (row length m). Lane l
// sums the entries i = l, l + 32, ... in order, then a shuffle tree.
//   ETA = false: y[j] = sum_i cB[i] invBT[j, i]
//   ETA = true:  invBT[j, i] += colL[j] u[i], then y[j] over the new row
// s_y and s_colL are indexed from the slice start.
template <bool ETA>
__device__ void row_pass(float* invBT, const float* s_cB, const float* s_u,
                         const float* s_colL, float* s_y, int m, int nrows) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int j = w; j < nrows; j += kWarps) {
    float* row = invBT + (size_t)j * m;
    const float cj = ETA ? s_colL[j] : 0.0f;
    float acc = 0.0f;
#pragma unroll 4
    for (int i = l; i < m; i += 32) {
      float v = row[i];
      if (ETA) {
        v = v + cj * s_u[i];
        row[i] = v;
      }
      acc += v * s_cB[i];
    }
    acc = lp::warp_sum(acc);
    if (l == 0) s_y[j] = acc;
  }
}

// The lane's objective sum_i cB[i] bfs[i] from the whole vectors: band by
// band (block sums), then the balanced tree over the kBands band totals, in
// every CTA alike.
// Block-wide sum (every thread gets it), warps' sums in a fixed order.
struct SumScratch {
  float w[kWarps];
};

__device__ __forceinline__ float block_sum(float v, SumScratch& s) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  v = lp::warp_sum(v);
  if (l == 0) s.w[w] = v;
  __syncthreads();
  float r = 0.0f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) r += s.w[k];
  __syncthreads();  // the scratch may be reused
  return r;
}

__device__ __forceinline__ float lane_objective(const float* s_cB,
                                                const float* s_bfs, int m,
                                                int band, SumScratch& red) {
  float zb[kBands];
#pragma unroll
  for (int b = 0; b < kBands; ++b) {
    const int lo = min(b * band, m), hi = min(lo + band, m);
    float part = 0.0f;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads)
      part += s_cB[i] * s_bfs[i];
    zb[b] = block_sum(part, red);
  }
  return tree<0, kBands>(zb);
}

// ---- selections -------------------------------------------------------------
//
// One block-wide reduction carries everything a selection needs: the min of
// a packed key, the lowest eligible index, and a NaN-propagating argmin
// (the min value and the lowest index attaining it; an index of `none` once
// a NaN is met, as no entry equals a NaN minimum). Every CTA of a cluster
// runs the same selection over the same whole vectors, so all agree bit for
// bit without exchanging anything.
struct Pick {
  int key;    // min packed key, or kIntMax
  int first;  // lowest eligible index, or `none`
  int i;      // lowest index attaining `v`, or `none`
  float v;    // NaN-propagating min, or +inf
};

__device__ __forceinline__ Pick pick_init(int none) {
  return Pick{kIntMax, none, none, INFINITY};
}

// Fold the entry (x, k) into the argmin (v, i).
__device__ __forceinline__ void amin(Pick& p, float x, int k, int none) {
  if (p.v != p.v) return;  // a NaN minimum stays, with no index
  if (x != x) {
    p.v = x;
    p.i = none;
  } else if (x < p.v || (x == p.v && k < p.i)) {
    p.v = x;
    p.i = k;
  }
}

__device__ __forceinline__ void merge(Pick& p, const Pick& q, int none) {
  p.key = min(p.key, q.key);
  p.first = min(p.first, q.first);
  amin(p, q.v, q.v != q.v ? none : q.i, none);
}

struct PickScratch {
  Pick w[kWarps];
};

// The block's Pick in every thread. Two block barriers.
__device__ __forceinline__ Pick block_pick(Pick p, int none, PickScratch& s) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) {
    Pick q;
    q.key = __shfl_xor_sync(lp::kFullMask, p.key, o);
    q.first = __shfl_xor_sync(lp::kFullMask, p.first, o);
    q.i = __shfl_xor_sync(lp::kFullMask, p.i, o);
    q.v = __shfl_xor_sync(lp::kFullMask, p.v, o);
    merge(p, q, none);
  }
  if (l == 0) s.w[w] = p;
  __syncthreads();
  Pick r = s.w[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) merge(r, s.w[k], none);
  __syncthreads();  // the scratch may be reused
  return r;
}

// Writes a CTA's rows of invBT back to device memory.
__device__ __forceinline__ void store_rows(float* g, const float* s, int cnt,
                                           bool aligned) {
  if (aligned) {
    float4* g4 = reinterpret_cast<float4*>(g);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    for (int i = threadIdx.x; i < cnt / 4; i += kThreads) g4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < cnt; i += kThreads) g[i] = s[i];
  }
}

// Floats rounded up to a multiple of 4 (16 bytes).
__host__ __device__ __forceinline__ size_t round4(size_t v) {
  return (v + 3) / 4 * 4;
}

// The launch configuration of `lanes` clusters of CL CTAs of `kernel`, each
// CTA of THREADS threads.
template <int THREADS = kThreads, typename Kernel>
cudaError_t configure(Kernel kernel, int CL, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute* attr, int lanes, size_t smem,
                      cudaStream_t stream) {
  // always: static shared memory counts against the 48 KB default too
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (CL > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)lanes * CL, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of `kernel` the device holds at once (< 0: a negated
// CUDA error).
template <int THREADS = kThreads, typename Kernel>
int max_clusters(Kernel kernel, int CL, size_t smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      configure<THREADS>(kernel, CL, cfg, &attr, 64, smem, nullptr);
  if (e != cudaSuccess) return -(int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

template <int THREADS = kThreads, typename Kernel, typename... Args>
int launch(Kernel kernel, int CL, int lanes, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      configure<THREADS>(kernel, CL, cfg, &attr, lanes, smem, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Cluster sizes the cluster-resident branches are built for.
__host__ __forceinline__ bool cluster_built(int cl) {
  return cl == 1 || cl == 2 || cl == 4 || cl == 8 || cl == 16;
}

}  // namespace lpc
