// Pricing and entering-column selection of one batched simplex step.
//
// Replaces linprog_tpu/ops/pallas_kernels.py :: price_entering (Pallas, body
// _price_kernel). Per lane: y = c_B B^-1, r = (c - y A) + penalty, then the
// entering column and an eligibility flag; two integers per lane leave the
// kernel. The work is one read of invB[m, m] and of A[m, n] per lane with
// two flops per element, so the kernel is bound by device-memory bandwidth.
// One thread block per lane: both GEMVs run thread per column (neighbouring
// threads on neighbouring addresses, every element read once), y and r stay
// in shared memory, and the selection is a block-wide min. The reference's
// grouping of four lanes per grid step is a Mosaic tiling rule and is not
// carried over.
//
// Semantics follow the Pallas kernel and the plain PyTorch version
// (linprog_tpu_torch/ops/step_kernels.py): dantzig takes the first index of
// the smallest r, reports eligible = (min r < -opt_tol) and does NOT zero
// the column of an ineligible lane (with a NaN in r no column equals the
// minimum and enter is n: callers clamp before they gather); bland takes the
// first r < -opt_tol and zeroes the column when there is none.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using lp::block_min;
using lp::block_min2;
using lp::kIntMax;
using lp::kThreads;
using lp::Scratch;

__global__ void __launch_bounds__(kThreads) price_entering_kernel(
    const float* __restrict__ cB_all, const float* __restrict__ invB_all,
    const float* __restrict__ A_all, const float* __restrict__ c_all,
    const float* __restrict__ pen_all, int* enter_all, int* elig_all, int m,
    int n, int dantzig, float opt_tol) {
  extern __shared__ float smem[];
  __shared__ Scratch red;
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x;
  const float* invB = invB_all + lane * m * m;
  const float* A = A_all + lane * m * n;
  float* s_cB = smem;
  float* s_y = s_cB + m;
  float* s_r = s_y + m;

  for (int i = tid; i < m; i += kThreads) s_cB[i] = cB_all[lane * m + i];
  __syncthreads();
  // y[k] = sum_i cB[i] invB[i, k]
  for (int k = tid; k < m; k += kThreads) {
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < m; ++i) acc += s_cB[i] * __ldg(invB + (size_t)i * m + k);
    s_y[k] = acc;
  }
  __syncthreads();
  // r[k] = (c[k] - sum_j y[j] A[j, k]) + penalty[k]
  for (int k = tid; k < n; k += kThreads) {
    float ay = 0.0f;
#pragma unroll 4
    for (int j = 0; j < m; ++j) ay += s_y[j] * __ldg(A + (size_t)j * n + k);
    s_r[k] = (c_all[lane * n + k] - ay) + pen_all[lane * n + k];
  }
  __syncthreads();

  int enter;
  bool eligible;
  if (dantzig) {
    float part = INFINITY;
    for (int k = tid; k < n; k += kThreads) part = lp::nan_min(part, s_r[k]);
    const float best = block_min(part, red);
    eligible = best < -opt_tol;
    int hot = n;
    for (int k = tid; k < n; k += kThreads)
      if (s_r[k] == best) hot = min(hot, k);
    enter = block_min2(hot, kIntMax, red).x;
  } else {
    int first = n;
    for (int k = tid; k < n; k += kThreads)
      if (s_r[k] < -opt_tol) first = min(first, k);
    enter = block_min2(first, kIntMax, red).x;
    eligible = enter < n;
    if (!eligible) enter = 0;
  }
  if (tid == 0) {
    enter_all[lane] = enter;
    elig_all[lane] = eligible ? 1 : 0;
  }
}

}  // namespace

extern "C" int lp_price_entering(const float* cB, const float* invB,
                                 const float* A, const float* c,
                                 const float* penalty, int* enter,
                                 int* eligible, int B, int m, int n,
                                 int dantzig, float opt_tol, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * m + n) * sizeof(float);
  // always: static shared memory counts against the 48 KB default too
  const cudaError_t e = cudaFuncSetAttribute(
      price_entering_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  price_entering_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      cB, invB, A, c, penalty, enter, eligible, m, n, dantzig, opt_tol);
  return (int)cudaGetLastError();
}
