// Shared device helpers for the linprog_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lp {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kIntMax = 0x7FFFFFFF;

// lane status codes (linprog_tpu_torch/status.py)
constexpr int kRunning = 0;
constexpr int kOptimal = 1;
constexpr int kPrimalUnbounded = 3;
constexpr int kDualUnbounded = 5;

// threads per block of the simplex segment kernels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// NaN-propagating min/max, as jnp.min / jnp.max reduce (fminf would drop NaN).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_min_float(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Scratch for the block-wide reductions below (blocks of kThreads).
struct Scratch {
  int a[kWarps];
  int b[kWarps];
  float f[kWarps];
  int out_a, out_b;
  float out_f;
};

// Block-wide min of two ints (every thread gets both). Each thread's
// partial must start at the reduction's identity for its use.
__device__ __forceinline__ int2 block_min2(int a, int b, Scratch& s) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  a = warp_min_int(a);
  b = warp_min_int(b);
  if (l == 0) {
    s.a[w] = a;
    s.b[w] = b;
  }
  __syncthreads();
  if (w == 0) {
    a = warp_min_int(l < kWarps ? s.a[l] : kIntMax);
    b = warp_min_int(l < kWarps ? s.b[l] : kIntMax);
    if (l == 0) {
      s.out_a = a;
      s.out_b = b;
    }
  }
  __syncthreads();
  const int2 r = make_int2(s.out_a, s.out_b);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_min(float v, Scratch& s) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  v = warp_min_float(v);
  if (l == 0) s.f[w] = v;
  __syncthreads();
  if (w == 0) {
    v = warp_min_float(l < kWarps ? s.f[l] : INFINITY);
    if (l == 0) s.out_f = v;
  }
  __syncthreads();
  const float r = s.out_f;
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, Scratch& s) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  v = warp_sum(v);
  if (l == 0) s.f[w] = v;
  __syncthreads();
  if (w == 0) {
    v = warp_sum(l < kWarps ? s.f[l] : 0.0f);
    if (l == 0) s.out_f = v;
  }
  __syncthreads();
  const float r = s.out_f;
  __syncthreads();
  return r;
}

// Packed selection key: the float's bits (complemented for negative values)
// with the index in the low `bits` bits; the min over keys fuses value-min,
// argmin (lowest index on an exact tie) and any-eligible (kIntMax: none).
__device__ __forceinline__ int pack_key(float v, int idx, int bits,
                                        bool negate) {
  int u = __float_as_int(v);
  if (negate) u = ~u;
  return (u & -(1 << bits)) | idx;
}

__device__ __forceinline__ float unpack_value(int key, int bits) {
  return __int_as_float(key & -(1 << bits));
}

// max(x, 0) with -0.0 -> +0.0 and NaN kept, as XLA's maximum.
__device__ __forceinline__ float nonneg(float x) {
  return x > 0.0f ? x : (x != x ? x : 0.0f);
}

// Index bits of a packed key over `size` entries: max(1, bit_length(size-1)).
__device__ __forceinline__ int bits_for(int size) {
  const int v = size - 1;
  const int bl = v <= 0 ? 0 : 32 - __clz(v);
  return bl < 1 ? 1 : bl;
}

// y[j] = sum_i cB[i] invBT[j, i]: one warp per row of invBT.  The caller
// syncs before it reads s_y.
__device__ __forceinline__ void duals(const float* invBT, const float* s_cB,
                                      float* s_y, int m) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int j = w; j < m; j += kWarps) {
    const float* row = invBT + (size_t)j * m;
    float acc = 0.0f;
    for (int i = l; i < m; i += 32) acc += row[i] * s_cB[i];
    acc = warp_sum(acc);
    if (l == 0) s_y[j] = acc;
  }
}

// s_col = A[:, enter]; s_d[i] = sum_j s_col[j] invBT[j, i] (thread per
// column of invBT, coalesced).  Ends synced.
__device__ __forceinline__ void direction(const float* __restrict__ A,
                                          const float* invBT, float* s_col,
                                          float* s_d, int m, int n,
                                          int enter) {
  for (int j = threadIdx.x; j < m; j += kThreads)
    s_col[j] = __ldg(A + (size_t)j * n + enter);
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kThreads) {
    float acc = 0.0f;
#pragma unroll 4
    for (int j = 0; j < m; ++j) acc += s_col[j] * invBT[(size_t)j * m + i];
    s_d[i] = acc;
  }
  __syncthreads();
}

// invBT += col (x) u with col = s_col (column `leave` of the old invBT,
// staged by the caller) and u = s_u: one warp per row.
__device__ __forceinline__ void eta_update(float* invBT, const float* s_col,
                                           const float* s_u, int m) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int j = w; j < m; j += kWarps) {
    const float cj = s_col[j];
    float* row = invBT + (size_t)j * m;
    for (int i = l; i < m; i += 32) row[i] = row[i] + cj * s_u[i];
  }
}

}  // namespace lp
