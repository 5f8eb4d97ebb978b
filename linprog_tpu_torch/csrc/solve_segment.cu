// Whole-segment revised simplex: up to seg_len iterations per lane in one
// launch, the lane's state updated in place.
//
// Replaces linprog_tpu/ops/solve_kernel.py :: solve_segment (Pallas). One
// thread block per lane. A[m, n] and the transposed basis inverse
// invBT[m, m] stay in device memory (a lane's A alone is 512 KB at
// m = 256, n = 512, past the 227 KB a block may hold); the O(m + n) vectors
// live in shared memory. Per primal iteration the block streams A once and
// invBT four times, so the kernel is bound by device-memory bandwidth:
//   y  = c_B B^-1           warp per row of invBT
//   r  = (c - y A) + pen    thread per column of A (coalesced)
//   entering column         block-wide min (packed i32 key, or value+index)
//   d  = B^-1 A[:, enter]   thread per column of invBT (coalesced)
//   leaving row             block-wide min of the ratio test
//   invBT += invBT[:, l] u  warp per row
// Dual mode picks the leaving row first, prices the row B^-1[l, :] A and
// r = c - y A in one pass over A, and takes the dual ratio test.
// Devex pricing (pricing = 2) keeps the reference weights gamma[n] in shared
// memory: the entering column maximises r^2 / gamma over r < -opt_tol (first
// index on ties; a stalled lane takes Bland's column instead), and each
// pivot reads A once more for the pivot row w = B^-1[l, :] A of the old
// tableau: gamma_j <- max(gamma_j, (w_j / d_l)^2 gamma_q) with
// gamma_q = max(gamma[enter], 1); the leaving column re-enters at
// max(gamma_q / d_l^2, 1); everything is capped at 1e12.
//
// Semantics follow the Pallas kernel and the plain PyTorch version
// (linprog_tpu_torch/ops/solve_kernel.py): absolute opt_tol, packed keys
// with the index in the low bits (complemented for negative values,
// INT32_MAX for "none", lowest index on exact ties), ratios clamped to +0.0
// before packing, segment-local stall state, untouched non-RUNNING lanes.
// The reference's `unroll` never changed results; this kernel has none.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using lp::block_min;
using lp::block_min2;
using lp::block_sum;
using lp::bits_for;
using lp::direction;
using lp::duals;
using lp::kDualUnbounded;
using lp::kIntMax;
using lp::kOptimal;
using lp::kPrimalUnbounded;
using lp::kRunning;
using lp::kThreads;
using lp::nonneg;
using lp::pack_key;
using lp::Scratch;
using lp::unpack_value;

__global__ void __launch_bounds__(kThreads) solve_segment_kernel(
    const float* __restrict__ A_all, const float* __restrict__ c_all,
    const float* __restrict__ apen_all, float* invBT_all, float* bfs_all,
    float* cB_all, int* basis_all, float* pen_all, float* gamma_all,
    int* iters_all, int* status_all, int m, int n, int seg_len, int maxiters,
    float opt_tol, float pivot_tol, float feas_tol, int dual, int pricing,
    int packed, int stall_limit) {
  extern __shared__ float smem[];
  __shared__ Scratch red;
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x;
  const float* A = A_all + lane * m * n;
  const float* apen = apen_all + lane * n;
  float* invBT = invBT_all + lane * m * m;

  float* s_bfs = smem;
  float* s_cB = s_bfs + m;
  int* s_basis = reinterpret_cast<int*>(s_cB + m);
  float* s_y = reinterpret_cast<float*>(s_basis + m);
  float* s_d = s_y + m;
  float* s_u = s_d + m;
  float* s_col = s_u + m;
  float* s_c = s_col + m;
  float* s_pen = s_c + n;
  float* s_r = s_pen + n;
  float* s_urow = s_r + n;
  float* s_gamma = s_urow + n;  // devex only (not allocated otherwise)
  const bool devex = pricing == 2;

  for (int i = tid; i < m; i += kThreads) {
    s_bfs[i] = bfs_all[lane * m + i];
    s_cB[i] = cB_all[lane * m + i];
    s_basis[i] = basis_all[lane * m + i];
  }
  for (int k = tid; k < n; k += kThreads) {
    s_c[k] = c_all[lane * n + k];
    s_pen[k] = pen_all[lane * n + k];
    if (devex) s_gamma[k] = gamma_all[lane * n + k];
  }
  int status = status_all[lane];
  int iters = iters_all[lane];
  __syncthreads();

  const bool dantzig = pricing >= 1;
  const bool track = stall_limit > 0 && pricing >= 1;
  const int bits_n = bits_for(n), bits_m = bits_for(m);
  const int lo_n = (1 << bits_n) - 1, lo_m = (1 << bits_m) - 1;

  // segment-local stall state
  float z = 0.0f;
  if (track) {
    float part = 0.0f;
    for (int i = tid; i < m; i += kThreads) part += s_cB[i] * s_bfs[i];
    z = block_sum(part, red);
  }
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
    int enter, leave, stop_status;
    bool do_pivot;
    float ratio;  // best_t (primal) / best_d (dual), for the stall metric

    if (dual) {
      // ---- leaving row: most infeasible (dantzig) or first (bland) ----
      bool viable;
      if (dantzig && packed) {
        int key = kIntMax, first = m;
        for (int i = tid; i < m; i += kThreads) {
          const float b = s_bfs[i];
          if (b < -feas_tol) {
            key = min(key, pack_key(b, i, bits_m, true));
            first = min(first, i);
          }
        }
        const int2 r = block_min2(key, first, red);
        viable = r.x != kIntMax;
        leave = use_bland ? r.y : (r.x & lo_m);
      } else if (dantzig) {
        float part = INFINITY;
        for (int i = tid; i < m; i += kThreads)
          part = lp::nan_min(part, s_bfs[i]);
        const float worst = block_min(part, red);
        viable = worst < -feas_tol;
        int hot = m, first = m;
        for (int i = tid; i < m; i += kThreads) {
          if (s_bfs[i] == worst) hot = min(hot, i);
          if (s_bfs[i] < -feas_tol) first = min(first, i);
        }
        const int2 r = block_min2(hot, first, red);
        leave = use_bland ? r.y : r.x;
      } else {
        int first = m;
        for (int i = tid; i < m; i += kThreads)
          if (s_bfs[i] < -feas_tol) first = min(first, i);
        leave = block_min2(first, kIntMax, red).x;
        viable = leave < m;
      }
      if (!viable) leave = 0;

      // ---- dual row urow = B^-1[leave, :] A and r = c - y A ------------
      for (int j = tid; j < m; j += kThreads)
        s_col[j] = invBT[(size_t)j * m + leave];
      duals(invBT, s_cB, s_y, m);
      __syncthreads();
      for (int k = tid; k < n; k += kThreads) {
        float au = 0.0f, ay = 0.0f;
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const float a = __ldg(A + (size_t)j * n + k);
          au += s_col[j] * a;
          ay += s_y[j] * a;
        }
        s_urow[k] = au;
        s_r[k] = s_c[k] - ay;
      }
      __syncthreads();

      // ---- dual ratio test over candidates urow < -pivot_tol, pen == 0 -
      bool any_cand;
      if (packed) {
        int key = kIntMax;
        for (int k = tid; k < n; k += kThreads) {
          const float uk = s_urow[k];
          if (uk < -pivot_tol && s_pen[k] == 0.0f)
            key = min(key, pack_key(nonneg(-s_r[k] / uk), k, bits_n, false));
        }
        const int d0 = block_min2(key, kIntMax, red).x;
        any_cand = d0 != kIntMax;
        enter = any_cand ? (d0 & lo_n) : 0;
        ratio = any_cand ? unpack_value(d0, bits_n) : INFINITY;
      } else {
        float part = INFINITY;
        for (int k = tid; k < n; k += kThreads) {
          const float uk = s_urow[k];
          if (uk < -pivot_tol && s_pen[k] == 0.0f)
            part = lp::nan_min(part, -s_r[k] / uk);
        }
        ratio = block_min(part, red);
        any_cand = ratio < INFINITY;
        int hot = n;
        for (int k = tid; k < n; k += kThreads) {
          const float uk = s_urow[k];
          if (uk < -pivot_tol && s_pen[k] == 0.0f && -s_r[k] / uk == ratio)
            hot = min(hot, k);
        }
        enter = block_min2(hot, kIntMax, red).x;
        if (!any_cand) enter = 0;
      }
      do_pivot = viable && any_cand;
      stop_status = !viable ? kOptimal : (!any_cand ? kDualUnbounded : kRunning);
      direction(A, invBT, s_col, s_d, m, n, enter);
    } else {
      // ---- pricing: r = (c - y A) + pen --------------------------------
      duals(invBT, s_cB, s_y, m);
      __syncthreads();
      for (int k = tid; k < n; k += kThreads) {
        float ay = 0.0f;
#pragma unroll 4
        for (int j = 0; j < m; ++j) ay += s_y[j] * __ldg(A + (size_t)j * n + k);
        s_r[k] = (s_c[k] - ay) + s_pen[k];
      }
      __syncthreads();

      // ---- entering column ---------------------------------------------
      bool eligible;
      if (packed && pricing == 1) {
        int key = kIntMax, first = n;
        for (int k = tid; k < n; k += kThreads) {
          const float r = s_r[k];
          if (r < -opt_tol) {
            key = min(key, pack_key(r, k, bits_n, true));
            first = min(first, k);
          }
        }
        const int2 res = block_min2(key, first, red);
        eligible = res.x != kIntMax;
        enter = use_bland ? res.y : (res.x & lo_n);
      } else if (devex) {
        // maximise r^2 / gamma over r < -opt_tol (as the min of its negative)
        float part = INFINITY;
        for (int k = tid; k < n; k += kThreads) {
          const float r = s_r[k];
          if (r < -opt_tol) part = lp::nan_min(part, -((r * r) / s_gamma[k]));
        }
        const float best = block_min(part, red);
        eligible = best < INFINITY;  // false for a NaN score, as max() > -inf
        int hot = n, first = n;
        for (int k = tid; k < n; k += kThreads) {
          const float r = s_r[k];
          if (r < -opt_tol) {
            if (-((r * r) / s_gamma[k]) == best) hot = min(hot, k);
            first = min(first, k);
          }
        }
        const int2 res = block_min2(hot, first, red);
        enter = use_bland ? res.y : res.x;
      } else if (dantzig) {
        float part = INFINITY;
        for (int k = tid; k < n; k += kThreads)
          part = lp::nan_min(part, s_r[k]);
        const float best = block_min(part, red);
        eligible = best < -opt_tol;
        int hot = n, first = n;
        for (int k = tid; k < n; k += kThreads) {
          if (s_r[k] == best) hot = min(hot, k);
          if (s_r[k] < -opt_tol) first = min(first, k);
        }
        const int2 res = block_min2(hot, first, red);
        enter = use_bland ? res.y : res.x;
      } else {
        int first = n;
        for (int k = tid; k < n; k += kThreads)
          if (s_r[k] < -opt_tol) first = min(first, k);
        enter = block_min2(first, kIntMax, red).x;
        eligible = enter < n;
      }
      if (!eligible) enter = 0;
      direction(A, invBT, s_col, s_d, m, n, enter);

      // ---- primal ratio test over d > pivot_tol ------------------------
      bool any_pos;
      if (packed) {
        int key = kIntMax;
        for (int i = tid; i < m; i += kThreads) {
          const float di = s_d[i];
          if (di > pivot_tol)
            key = min(key, pack_key(nonneg(s_bfs[i]) / di, i, bits_m, false));
        }
        const int t0 = block_min2(key, kIntMax, red).x;
        any_pos = t0 != kIntMax;
        leave = any_pos ? (t0 & lo_m) : 0;
        ratio = any_pos ? unpack_value(t0, bits_m) : INFINITY;
      } else {
        float part = INFINITY;
        for (int i = tid; i < m; i += kThreads) {
          const float di = s_d[i];
          if (di > pivot_tol) part = lp::nan_min(part, nonneg(s_bfs[i]) / di);
        }
        ratio = block_min(part, red);
        any_pos = ratio < INFINITY;
        int hot = m;
        for (int i = tid; i < m; i += kThreads) {
          const float di = s_d[i];
          if (di > pivot_tol && nonneg(s_bfs[i]) / di == ratio)
            hot = min(hot, i);
        }
        leave = block_min2(hot, kIntMax, red).x;
        if (!any_pos) leave = 0;
      }
      do_pivot = eligible && any_pos;
      stop_status = !eligible ? kOptimal
                              : (!any_pos ? kPrimalUnbounded : kRunning);
    }

    // ---- pivot: eta update of invBT, bfs and bookkeeping -----------------
    // scalars read as the reference's masked sums read them (-0.0 -> +0.0)
    const float d_l = s_d[leave] + 0.0f;
    const float bfs_l = s_bfs[leave] + 0.0f;
    const int leaving_col = s_basis[leave];
    const float c_enter = s_c[enter] + 0.0f;
    const float r_enter = s_r[enter] + 0.0f;
    const float gamma_q =
        devex ? lp::nan_max(s_gamma[enter] + 0.0f, 1.0f) : 1.0f;
    float dz = 0.0f;
    if (do_pivot) {
      const float safe = d_l == 0.0f ? 1.0f : d_l;
      for (int i = tid; i < m; i += kThreads) {
        s_u[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
        s_col[i] = invBT[(size_t)i * m + leave];
      }
      __syncthreads();
      if (devex) {
        // reference weights from the pivot row of the OLD tableau
        const float g_leave = lp::nan_max(gamma_q / (safe * safe), 1.0f);
        for (int k = tid; k < n; k += kThreads) {
          float w = 0.0f;
#pragma unroll 4
          for (int j = 0; j < m; ++j)
            w += s_col[j] * __ldg(A + (size_t)j * n + k);
          const float ws = w / safe;
          float g = lp::nan_max(s_gamma[k], (ws * ws) * gamma_q);
          if (k == leaving_col) g = g_leave;
          s_gamma[k] = lp::nan_min(g, 1e12f);
        }
      }
      lp::eta_update(invBT, s_col, s_u, m);
      for (int i = tid; i < m; i += kThreads)
        s_bfs[i] = s_bfs[i] + s_u[i] * bfs_l;
      __syncthreads();
      if (tid == 0) {
        s_basis[leave] = enter;
        s_cB[leave] = c_enter;
        s_pen[leaving_col] = apen[leaving_col];
        s_pen[enter] = INFINITY;
      }
      if (track) dz = dual ? -ratio * bfs_l : ratio * r_enter;
    }
    status = stop_status;
    iters += 1;
    z = z + dz;
    dz_prev = dz;
    __syncthreads();
  }

  for (int i = tid; i < m; i += kThreads) {
    bfs_all[lane * m + i] = s_bfs[i];
    cB_all[lane * m + i] = s_cB[i];
    basis_all[lane * m + i] = s_basis[i];
  }
  for (int k = tid; k < n; k += kThreads) {
    pen_all[lane * n + k] = s_pen[k];
    if (devex) gamma_all[lane * n + k] = s_gamma[k];
  }
  if (tid == 0) {
    status_all[lane] = status;
    iters_all[lane] = iters;
  }
}

}  // namespace

extern "C" int lp_solve_segment(const float* A, const float* c,
                                const float* apen, float* invBT, float* bfs,
                                float* cB, int* basis, float* pen,
                                float* gamma, int* iters, int* status, int B,
                                int m, int n, int seg_len, int maxiters,
                                float opt_tol, float pivot_tol, float feas_tol,
                                int dual, int pricing, int packed,
                                int stall_limit, void* stream) {
  if (pricing < 0 || pricing > 2 || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  // the devex weights take a fifth row of n floats
  const size_t smem =
      (size_t)(7 * m + (pricing == 2 ? 5 : 4) * n) * sizeof(float);
  // always: static shared memory counts against the 48 KB default too
  const cudaError_t e = cudaFuncSetAttribute(
      solve_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  solve_segment_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      A, c, apen, invBT, bfs, cB, basis, pen, gamma, iters, status, m, n,
      seg_len, maxiters, opt_tol, pivot_tol, feas_tol, dual, pricing, packed,
      stall_limit);
  return (int)cudaGetLastError();
}

extern "C" const char* lp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
