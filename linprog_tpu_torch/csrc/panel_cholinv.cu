// Batched inverse Cholesky factor W = L^{-1} of small SPD blocks M = L L'.
//
// Replaces linprog_tpu/ops/cholinv_kernel.py :: panel_cholinv (Pallas).
// Per step k, with A the working copy of M and R starting at I and ending
// at L^{-1}:
//   d       = 1 / sqrt(A[k][k])
//   col[j]  = j >= k ? A[k][j] * d : 0        rowR[j] = R[k][j] * d
//   A[i][j] -= col[i] * col[j]
//   R[k][:] = rowR;  R[i][j] -= (i > k ? col[i] : 0) * rowR[j]
// Every element takes the full update, as in the plain PyTorch version, so
// NaN/inf from a non-SPD pivot spread the same way in both. Built with
// --fmad=false: each product rounds before its subtraction.
//
// What bounds it: a matrix is 4 KB at the IPM's mb = 32, so neither bytes
// nor operations; the mb elimination steps depend on each other, and what
// a step costs is the time to hand d and col from the threads that hold
// them to the threads that need them.
//
// mb <= 32 (every call of the IPM's block recursion): ONE WARP per matrix,
// the state in registers, no block barrier. Lane j holds column j of A and
// of R in 2 x 32 registers (all loops over rows and steps are unrolled, so
// every register index is static). In step k the pivot comes by one shuffle
// from lane k, col[j] and rowR[j] are the lane's own, and the 32 values
// col[i] pass through 32 floats of the warp's shared memory (one store,
// eight 16-byte broadcast loads, two __syncwarp). Rows load and store
// coalesced. Four warps a block, so [1024, 32, 32] is one resident wave.
//
// 32 < mb <= 64 (a direct call, or blk = 64): one block per matrix, A and R
// in shared memory, one thread per element, two block barriers a step.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxMb = 64;
constexpr int kWarpMb = 32;        // largest mb of the warp kernel
constexpr int kWarpsPerBlock = 4;  // matrices per block of the warp kernel

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    panel_cholinv_warp_kernel(const float* __restrict__ M,
                              float* __restrict__ W, int B, int mb) {
  __shared__ __align__(16) float s_col[kWarpsPerBlock][kWarpMb];
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int mat = blockIdx.x * kWarpsPerBlock + warp;
  if (mat >= B) return;  // whole warps leave; no block barrier follows
  const float* Mb = M + (size_t)mat * mb * mb;
  float* col = s_col[warp];

  // lane j: a[i] = A[i][j], r[i] = R[i][j]; entries past mb are zero and
  // never reach an entry inside (an update of (i, j) reads only rows and
  // columns i, j and k, all inside)
  float a[kWarpMb], r[kWarpMb];
#pragma unroll
  for (int i = 0; i < kWarpMb; ++i) {
    a[i] = (i < mb && j < mb) ? Mb[i * mb + j] : 0.0f;
    r[i] = i == j ? 1.0f : 0.0f;
  }

#pragma unroll
  for (int k = 0; k < kWarpMb; ++k) {
    if (k < mb) {  // uniform over the warp
      const float d = 1.0f / sqrtf(__shfl_sync(lp::kFullMask, a[k], k));
      const float colj = j >= k ? a[k] * d : 0.0f;
      const float rowj = r[k] * d;
      col[j] = colj;
      __syncwarp();
      float c[kWarpMb];
#pragma unroll
      for (int i = 0; i < kWarpMb; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(col + i);
        c[i] = v.x;
        c[i + 1] = v.y;
        c[i + 2] = v.z;
        c[i + 3] = v.w;
      }
      __syncwarp();  // col is read: the next step may overwrite it
#pragma unroll
      for (int i = 0; i < kWarpMb; ++i) {
        a[i] = a[i] - c[i] * colj;
        const float ri = i == k ? rowj : r[i];
        const float cb = i > k ? c[i] : 0.0f;
        r[i] = ri - cb * rowj;
      }
    }
  }

  float* Wb = W + (size_t)mat * mb * mb;
#pragma unroll
  for (int i = 0; i < kWarpMb; ++i)
    if (i < mb && j < mb) Wb[i * mb + j] = r[i];
}

__global__ void panel_cholinv_block_kernel(const float* __restrict__ M,
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

// mb <= 32: the warp-per-matrix kernel; 32 < mb <= 64: the block-per-matrix
// kernel.
extern "C" int lp_panel_cholinv(const float* M, float* W, int B, int mb,
                                void* stream) {
  if (mb < 1 || mb > kMaxMb || B < 1) return (int)cudaErrorInvalidValue;
  if (mb <= kWarpMb) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    panel_cholinv_warp_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                                (cudaStream_t)stream>>>(M, W, B, mb);
  } else {
    panel_cholinv_block_kernel<<<B, 1024, 0, (cudaStream_t)stream>>>(M, W, mb);
  }
  return (int)cudaGetLastError();
}
