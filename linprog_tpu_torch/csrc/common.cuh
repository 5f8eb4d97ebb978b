// Shared device helpers for the linprog_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>

namespace lp {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kIntMax = 0x7FFFFFFF;

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

}  // namespace lp
