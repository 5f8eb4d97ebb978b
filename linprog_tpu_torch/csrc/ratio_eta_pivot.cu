// Ratio test and in-place eta pivot of one batched simplex step.
//
// Replaces linprog_tpu/ops/pallas_kernels.py :: ratio_eta_pivot (Pallas,
// body _ratio_eta_kernel). Per lane: the direction d = B^-1 a, the masked
// min-ratio leaving row (first index on ties), the unbounded flag and the
// masked rank-1 update invB += u (x) invB[leave, :] with the matching update
// of bfs, in place. The work is a read of invB[m, m] for d, and a read and a
// write of it for the update, with two flops per element: the kernel is
// bound by device-memory bandwidth. One thread block per lane. d needs all
// of invB before any row is rewritten, so the block finishes d, the
// selection and a copy of row `leave` (which is itself rescaled) in shared
// memory, meets at a barrier, and only then rewrites the rows, one warp per
// row (coalesced). A lane that does not pivot skips the update.
//
// Semantics follow the Pallas kernel and the plain PyTorch version
// (linprog_tpu_torch/ops/step_kernels.py): the ratio test divides the
// UNCLAMPED bfs; leave is 0 and nothing changes when no d > pivot_tol;
// unbounded = go and no positive d; the eta column is zero unless go and a
// positive d exists.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using lp::block_min;
using lp::block_min2;
using lp::kThreads;
using lp::kWarps;
using lp::Scratch;

__global__ void __launch_bounds__(kThreads) ratio_eta_pivot_kernel(
    float* invB_all, float* bfs_all, const float* __restrict__ acol_all,
    const int* __restrict__ go_all, int* leave_all, int* unb_all, int m,
    float pivot_tol) {
  extern __shared__ float smem[];
  __shared__ Scratch red;
  const int tid = threadIdx.x;
  const int w = tid >> 5, l = tid & 31;
  const size_t lane = blockIdx.x;
  float* invB = invB_all + lane * m * m;
  float* s_a = smem;
  float* s_bfs = s_a + m;
  float* s_d = s_bfs + m;
  float* s_row = s_d + m;

  for (int i = tid; i < m; i += kThreads) {
    s_a[i] = acol_all[lane * m + i];
    s_bfs[i] = bfs_all[lane * m + i];
  }
  const bool go = go_all[lane] > 0;
  __syncthreads();
  // d[i] = sum_k invB[i, k] a[k]: one warp per row
  for (int i = w; i < m; i += kWarps) {
    const float* row = invB + (size_t)i * m;
    float acc = 0.0f;
    for (int k = l; k < m; k += 32) acc += row[k] * s_a[k];
    acc = lp::warp_sum(acc);
    if (l == 0) s_d[i] = acc;
  }
  __syncthreads();

  // ---- masked min-ratio leaving row ---------------------------------------
  float part = INFINITY;
  int first_pos = m;
  for (int i = tid; i < m; i += kThreads) {
    const float d = s_d[i];
    if (d > pivot_tol) {
      part = lp::nan_min(part, s_bfs[i] / d);
      first_pos = min(first_pos, i);
    }
  }
  const float best = block_min(part, red);
  int hot = m;
  for (int i = tid; i < m; i += kThreads) {
    const float d = s_d[i];
    if (d > pivot_tol && s_bfs[i] / d == best) hot = min(hot, i);
  }
  const int2 sel = block_min2(hot, first_pos, red);
  const bool any_pos = sel.y < m;
  // with a NaN ratio no row equals the minimum: stay inside the lane
  const int leave = any_pos ? min(sel.x, m - 1) : 0;
  const bool do_pivot = go && any_pos;

  if (do_pivot) {
    const float d_l = s_d[leave] + 0.0f;
    const float bfs_l = s_bfs[leave] + 0.0f;
    const float safe = d_l == 0.0f ? 1.0f : d_l;
    for (int k = tid; k < m; k += kThreads) s_row[k] = invB[(size_t)leave * m + k];
    __syncthreads();  // row `leave` is staged, s_d and s_bfs are read
    for (int i = tid; i < m; i += kThreads) {
      // u overwrites d in place
      const float u = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
      s_d[i] = u;
      bfs_all[lane * m + i] = s_bfs[i] + u * bfs_l;
    }
    __syncthreads();
    for (int i = w; i < m; i += kWarps) {
      const float u = s_d[i];
      float* row = invB + (size_t)i * m;
      for (int k = l; k < m; k += 32) row[k] = row[k] + u * s_row[k];
    }
  }
  if (tid == 0) {
    leave_all[lane] = leave;
    unb_all[lane] = (go && !any_pos) ? 1 : 0;
  }
}

}  // namespace

extern "C" int lp_ratio_eta_pivot(float* invB, float* bfs, const float* acol,
                                  const int* go, int* leave, int* unbounded,
                                  int B, int m, float pivot_tol,
                                  void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(4 * m) * sizeof(float);
  // always: static shared memory counts against the 48 KB default too
  const cudaError_t e = cudaFuncSetAttribute(
      ratio_eta_pivot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ratio_eta_pivot_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      invB, bfs, acol, go, leave, unbounded, m, pivot_tol);
  return (int)cudaGetLastError();
}
