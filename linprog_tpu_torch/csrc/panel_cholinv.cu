// Batched inverse Cholesky factor W = L^{-1} of small SPD blocks M = L L'.
//
// Replaces linprog_tpu/ops/cholinv_kernel.py :: panel_cholinv (Pallas).
// One block per matrix; A (the working copy of M) and R (starts at I, ends
// at L^{-1}) live in shared memory, one thread per (row, col) element
// (threads loop when mb * mb > blockDim). Per step k:
//   d       = 1 / sqrt(A[k][k])
//   col[j]  = j >= k ? A[k][j] * d : 0        rowR[j] = R[k][j] * d
//   A[i][j] -= col[i] * col[j]
//   R[k][:] = rowR;  R[i][j] -= (i > k ? col[i] : 0) * rowR[j]
// Every element takes the full update, as in the plain PyTorch version, so
// NaN/inf from a non-SPD pivot spread the same way in both. Built with
// --fmad=false: each product rounds before its subtraction.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxMb = 64;

__global__ void panel_cholinv_kernel(const float* __restrict__ M,
                                     float* __restrict__ W, int mb) {
  __shared__ float A[kMaxMb * kMaxMb];
  __shared__ float R[kMaxMb * kMaxMb];
  __shared__ float col[kMaxMb];
  __shared__ float rowR[kMaxMb];

  const int nel = mb * mb;
  const float* Mb = M + (size_t)blockIdx.x * nel;
  for (int e = threadIdx.x; e < nel; e += blockDim.x) {
    A[e] = Mb[e];
    R[e] = (e / mb == e % mb) ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int k = 0; k < mb; ++k) {
    const float d = 1.0f / sqrtf(A[k * mb + k]);
    for (int j = threadIdx.x; j < mb; j += blockDim.x) {
      col[j] = j >= k ? A[k * mb + j] * d : 0.0f;
      rowR[j] = R[k * mb + j] * d;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nel; e += blockDim.x) {
      const int i = e / mb, j = e % mb;
      A[e] = A[e] - col[i] * col[j];
      const float r = (i == k) ? rowR[j] : R[e];
      const float cb = i > k ? col[i] : 0.0f;
      R[e] = r - cb * rowR[j];
    }
    __syncthreads();
  }

  float* Wb = W + (size_t)blockIdx.x * nel;
  for (int e = threadIdx.x; e < nel; e += blockDim.x) Wb[e] = R[e];
}

}  // namespace

extern "C" int lp_panel_cholinv(const float* M, float* W, int B, int mb,
                                void* stream) {
  if (mb < 1 || mb > kMaxMb) return (int)cudaErrorInvalidValue;
  const int threads = mb * mb < 1024 ? ((mb * mb + 31) / 32) * 32 : 1024;
  panel_cholinv_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(M, W, mb);
  return (int)cudaGetLastError();
}
