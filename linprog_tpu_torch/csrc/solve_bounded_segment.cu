// Whole-segment bounded-variable simplex (min c'x, Ax = b, lb <= x <= ub):
// up to seg_len iterations per lane in one launch, the lane's state updated
// in place.
//
// Replaces linprog_tpu/ops/bounded_kernel.py :: solve_bounded_segment
// (Pallas, body _bounded_kernel). One thread block per lane, the design of
// solve_segment.cu: A[m, n] and the transposed basis inverse invBT[m, m]
// stay in device memory (a lane's A alone is 512 KB at m = 256, n = 512,
// past the 227 KB a block may hold); the O(m + n) vectors (c, lb, ub,
// vstate, rc, y, d, u, bfs, cB, lbB, ubB, basis) live in shared memory. Per
// iteration the block streams A once and invBT up to four times, so the
// kernel is bound by device-memory bandwidth:
//   y   = c_B B^-1              warp per row of invBT
//   rc  = +-(y A - c)           thread per column of A (coalesced)
//   entering column             block-wide min (packed key) or max + index
//   d   = B^-1 A[:, enter]      thread per column of invBT (coalesced)
//   three-way ratio test        block-wide mins over the two ratio rows
//   bfs -= step * sigma * d     a bound flip stops here
//   invBT += invBT[:, l] u      warp per row (a pivot only)
//
// Semantics follow the Pallas kernel and the plain PyTorch version
// (linprog_tpu_torch/ops/bounded_kernel.py): Dantzig pricing on the
// bound-aware reduced costs with the absolute opt_tol, no stall escalation;
// the rooms bfs - lbB and ubB - bfs clamp to +0.0; infinite bounds pass
// through (gamma3 = ub_e - lb_e may be inf; the step length is selected,
// never multiplied by a flag); packed mode compares the two ratio KEYS to
// pick the bound the leaving variable lands on and re-reads the step length
// exactly at the chosen row, unpacked mode compares the two values; a flip
// counts as an iteration; a lane that is not RUNNING is untouched. The
// variable states are int8 in device memory and ints in shared memory.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using lp::block_min;
using lp::block_min2;
using lp::bits_for;
using lp::direction;
using lp::duals;
using lp::kIntMax;
using lp::kOptimal;
using lp::kPrimalUnbounded;
using lp::kRunning;
using lp::kThreads;
using lp::nan_min;
using lp::nonneg;
using lp::pack_key;
using lp::Scratch;

constexpr int kAtLb = 0, kAtUb = 1, kBasic = 2;

// The two ratio rows at basis position i: g1 (the basic variable drops to
// its lower bound) and g2 (it rises to its upper bound); inf where the
// direction does not move it that way.
__device__ __forceinline__ float2 ratios(float sigma, float d, float bfs,
                                         float lbB, float ubB,
                                         float pivot_tol) {
  const float sd = sigma * d;
  const float g1 = sd > pivot_tol ? nonneg(bfs - lbB) / sd : INFINITY;
  const float g2 = -sd > pivot_tol ? nonneg(ubB - bfs) / -sd : INFINITY;
  return make_float2(g1, g2);
}

__global__ void __launch_bounds__(kThreads) solve_bounded_segment_kernel(
    const float* __restrict__ A_all, const float* __restrict__ c_all,
    const float* __restrict__ lb_all, const float* __restrict__ ub_all,
    float* invBT_all, float* bfs_all, float* cB_all, int* basis_all,
    signed char* vstate_all, float* lbB_all, float* ubB_all, int* iters_all,
    int* status_all, int m, int n, int seg_len, int maxiters, float opt_tol,
    float pivot_tol, int packed) {
  extern __shared__ float smem[];
  __shared__ Scratch red;
  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x;
  const float* A = A_all + lane * m * n;
  float* invBT = invBT_all + lane * m * m;

  float* s_bfs = smem;
  float* s_cB = s_bfs + m;
  float* s_lbB = s_cB + m;
  float* s_ubB = s_lbB + m;
  int* s_basis = reinterpret_cast<int*>(s_ubB + m);
  float* s_y = reinterpret_cast<float*>(s_basis + m);
  float* s_d = s_y + m;
  float* s_u = s_d + m;
  float* s_col = s_u + m;
  float* s_c = s_col + m;
  float* s_lb = s_c + n;
  float* s_ub = s_lb + n;
  float* s_rc = s_ub + n;
  int* s_vs = reinterpret_cast<int*>(s_rc + n);

  for (int i = tid; i < m; i += kThreads) {
    s_bfs[i] = bfs_all[lane * m + i];
    s_cB[i] = cB_all[lane * m + i];
    s_lbB[i] = lbB_all[lane * m + i];
    s_ubB[i] = ubB_all[lane * m + i];
    s_basis[i] = basis_all[lane * m + i];
  }
  for (int k = tid; k < n; k += kThreads) {
    s_c[k] = c_all[lane * n + k];
    s_lb[k] = lb_all[lane * n + k];
    s_ub[k] = ub_all[lane * n + k];
    s_vs[k] = vstate_all[lane * n + k];
  }
  int status = status_all[lane];
  int iters = iters_all[lane];
  __syncthreads();

  const int bits_n = bits_for(n), bits_m = bits_for(m);
  const int lo_n = (1 << bits_n) - 1, lo_m = (1 << bits_m) - 1;

  for (int seg = 0; seg < seg_len && status == kRunning && iters < maxiters;
       ++seg) {
    // ---- bound-aware pricing: z - c at a lower bound, c - z at an upper --
    duals(invBT, s_cB, s_y, m);
    __syncthreads();
    for (int k = tid; k < n; k += kThreads) {
      float ay = 0.0f;
#pragma unroll 4
      for (int j = 0; j < m; ++j) ay += s_y[j] * __ldg(A + (size_t)j * n + k);
      const float zc = ay - s_c[k];
      const int vs = s_vs[k];
      s_rc[k] = vs == kBasic ? -INFINITY : (vs == kAtUb ? -zc : zc);
    }
    __syncthreads();

    // ---- entering column: the largest rc above opt_tol -------------------
    bool eligible;
    int enter;
    if (packed) {
      int key = kIntMax;
      for (int k = tid; k < n; k += kThreads) {
        const float rc = s_rc[k];
        if (rc > opt_tol) key = min(key, pack_key(-rc, k, bits_n, true));
      }
      const int kr = block_min2(key, kIntMax, red).x;
      eligible = kr != kIntMax;
      enter = eligible ? (kr & lo_n) : 0;
    } else {
      float part = INFINITY;  // the max of rc as the min of -rc
      for (int k = tid; k < n; k += kThreads) part = nan_min(part, -s_rc[k]);
      const float best = -block_min(part, red);
      eligible = best > opt_tol;
      int hot = n;
      for (int k = tid; k < n; k += kThreads)
        if (s_rc[k] == best) hot = min(hot, k);
      enter = block_min2(hot, kIntMax, red).x;
      if (!eligible) enter = 0;
    }
    // scalars read as the reference's masked sums read them (-0.0 -> +0.0,
    // inf passes through)
    const int vs_enter = s_vs[enter];
    const float lb_e = s_lb[enter] + 0.0f;
    const float ub_e = s_ub[enter] + 0.0f;
    const float c_e = s_c[enter] + 0.0f;
    const float sigma = vs_enter == kAtLb ? 1.0f : -1.0f;

    direction(A, invBT, s_col, s_d, m, n, enter);

    // ---- three-way ratio test ---------------------------------------------
    const float gamma3 = ub_e - lb_e;
    float delta;
    bool leave_to_lb;
    int leave;
    if (packed) {
      int k1 = kIntMax, k2 = kIntMax;
      for (int i = tid; i < m; i += kThreads) {
        const float sd = sigma * s_d[i];
        const float2 g =
            ratios(sigma, s_d[i], s_bfs[i], s_lbB[i], s_ubB[i], pivot_tol);
        if (sd > pivot_tol) k1 = min(k1, pack_key(g.x, i, bits_m, false));
        if (-sd > pivot_tol) k2 = min(k2, pack_key(g.y, i, bits_m, false));
      }
      const int2 km = block_min2(k1, k2, red);
      leave_to_lb = km.x < km.y;
      const int ksel = min(km.x, km.y);
      leave = ksel & lo_m;
      delta = INFINITY;
      if (ksel != kIntMax) {
        // the step length exactly at the chosen row, not the key's
        // truncated mantissa
        const float2 g = ratios(sigma, s_d[leave], s_bfs[leave], s_lbB[leave],
                                s_ubB[leave], pivot_tol);
        delta = (leave_to_lb ? g.x : g.y) + 0.0f;
      }
    } else {
      float p1 = INFINITY, p2 = INFINITY;
      for (int i = tid; i < m; i += kThreads) {
        const float2 g =
            ratios(sigma, s_d[i], s_bfs[i], s_lbB[i], s_ubB[i], pivot_tol);
        p1 = nan_min(p1, g.x);
        p2 = nan_min(p2, g.y);
      }
      const float g1 = block_min(p1, red);
      const float g2 = block_min(p2, red);
      delta = nan_min(g1, g2);
      leave_to_lb = g1 < g2;
      int l1 = m, l2 = m;
      for (int i = tid; i < m; i += kThreads) {
        const float2 g =
            ratios(sigma, s_d[i], s_bfs[i], s_lbB[i], s_ubB[i], pivot_tol);
        if (g.x == g1) l1 = min(l1, i);
        if (g.y == g2) l2 = min(l2, i);
      }
      const int2 lm = block_min2(l1, l2, red);
      leave = leave_to_lb ? lm.x : lm.y;
    }

    const bool unbounded = eligible && isinf(delta) && isinf(gamma3);
    const bool traverse = gamma3 <= delta;
    const bool flip = eligible && !unbounded && traverse;
    const bool piv = eligible && !unbounded && !traverse;
    if (!piv) leave = 0;
    // with a NaN ratio no row equals the minimum (leave == m): then no slot
    // is seated, as the reference's all-false row mask does
    const bool seat = piv && leave < m;
    const int row_l = min(leave, m - 1);
    const float d_l = leave < m ? s_d[leave] + 0.0f : 0.0f;
    const int leaving_col = leave < m ? s_basis[leave] : 0;
    const float step_len = flip ? gamma3 : (piv ? delta : 0.0f);
    const float enter_val = (sigma > 0.0f ? lb_e : ub_e) + sigma * delta;
    const float safe = d_l == 0.0f ? 1.0f : d_l;
    __syncthreads();  // every thread has read its scalars

    // ---- incremental bfs: every basic moves by -step * sd; a pivot then
    // seats the entering variable's value in the leaving slot
    for (int i = tid; i < m; i += kThreads) {
      const float moved = s_bfs[i] - step_len * (sigma * s_d[i]);
      s_bfs[i] = (seat && i == leave) ? enter_val : moved;
    }

    if (piv) {
      // ---- rank-1 eta update of invBT (column l staged first: its rows
      // are rewritten below) ------------------------------------------------
      for (int i = tid; i < m; i += kThreads) {
        s_u[i] = i == leave ? (1.0f / safe - 1.0f) : (-s_d[i] / safe);
        s_col[i] = invBT[(size_t)i * m + row_l];
      }
      __syncthreads();
      lp::eta_update(invBT, s_col, s_u, m);
      if (tid == 0) {
        if (seat) {
          s_basis[leave] = enter;
          s_cB[leave] = c_e;
          s_lbB[leave] = lb_e;
          s_ubB[leave] = ub_e;
        }
        s_vs[enter] = kBasic;
        s_vs[leaving_col] = leave_to_lb ? kAtLb : kAtUb;
      }
    } else if (flip && tid == 0) {
      s_vs[enter] = 1 - vs_enter;
    }
    status = !eligible ? kOptimal : (unbounded ? kPrimalUnbounded : kRunning);
    iters += 1;
    __syncthreads();
  }

  for (int i = tid; i < m; i += kThreads) {
    bfs_all[lane * m + i] = s_bfs[i];
    cB_all[lane * m + i] = s_cB[i];
    lbB_all[lane * m + i] = s_lbB[i];
    ubB_all[lane * m + i] = s_ubB[i];
    basis_all[lane * m + i] = s_basis[i];
  }
  for (int k = tid; k < n; k += kThreads)
    vstate_all[lane * n + k] = (signed char)s_vs[k];
  if (tid == 0) {
    status_all[lane] = status;
    iters_all[lane] = iters;
  }
}

}  // namespace

extern "C" int lp_solve_bounded_segment(
    const float* A, const float* c, const float* lb, const float* ub,
    float* invBT, float* bfs, float* cB, int* basis, signed char* vstate,
    float* lbB, float* ubB, int* iters, int* status, int B, int m, int n,
    int seg_len, int maxiters, float opt_tol, float pivot_tol, int packed,
    void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(9 * m + 5 * n) * sizeof(float);
  // always: static shared memory counts against the 48 KB default too
  const cudaError_t e = cudaFuncSetAttribute(
      solve_bounded_segment_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  solve_bounded_segment_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      A, c, lb, ub, invBT, bfs, cB, basis, vstate, lbB, ubB, iters, status, m,
      n, seg_len, maxiters, opt_tol, pivot_tol, packed);
  return (int)cudaGetLastError();
}
