// Shared device helpers for the linprog_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
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

// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi), both rounded to
// nearest even (the reference's astype(bfloat16)); x - hi is exact in f32,
// and a product of two halves is exact in f32.
__device__ __forceinline__ void bf16_split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

// Index bits of a packed key over `size` entries: max(1, bit_length(size-1)).
__device__ __forceinline__ int bits_for(int size) {
  const int v = size - 1;
  const int bl = v <= 0 ? 0 : 32 - __clz(v);
  return bl < 1 ? 1 : bl;
}

}  // namespace lp
