// The double-word products and compensated sums of refine.py, one launch a
// call.
//
// Replaces no TPU kernel: the JAX package computes these with XLA's
// elementwise ops (linprog_tpu/refine.py), and the port's plain version is
// a chain of eager ops (linprog_tpu_torch/refine.py :: _dd_chunk_products,
// then _kahan_sum_chunks), ~600 launches a residual at [1024, 256, 256],
// each a strided pass over M or a 1 MB partial. Every step is an IEEE f32
// add, subtract or multiply, so each output is a fixed sequence of
// roundings; this file runs the same sequence per output with the _rn
// intrinsics (and the library builds with --fmad=false), so no product is
// contracted into an FMA and every output equals the plain version's in
// every bit, signed zeros and NaN and inf positions included.
//
// dd_rowmat_kernel: for lane b and output column j of y[B, m] @ M[B, m, n],
// rows zero-padded to a multiple of `chunk`: the Dekker splits of y and M,
// then per chunk k the TwoProd / TwoSum loop over its rows in order, giving
// the pair (s_k, e_k); then the compensated sum over [bvec, -s_0 ..
// -s_{K-1}, -e_0 .. -e_{K-1}] (the residual bvec - y M) or over [s_0 ..
// s_{K-1}, e_0 .. e_{K-1}] (y M in double-word). A CTA owns one lane and 32
// output columns; its 8 warps take the 8 chunks of a row block of 8 * chunk
// rows, each lane one column, so the chunks' pairs, which are independent,
// are computed in parallel, and only the sum over the 2K + 1 partials runs
// serially, one thread a column. The row block of M comes through a tile in
// shared memory, loaded along whichever of M's strides is 1: a row-major M
// and its transposed view (refine.dd_residual's M.transpose(1, 2)) both
// read M once, coalesced, with no copy. The pairs wait in shared memory
// (2 K floats a column; past the device's opt-in limit, 227 KB on the
// H100, in a scratch buffer of the size lp_dd_rowmat_scratch_floats gives).
//
// dd_kahan_sum_kernel: _kahan_sum_chunks alone over P[B, K, n], a thread an
// output (refine.dd_rowmat sums its partial products with cuBLAS's order
// and hands them here).
//
// Bound: M read once, y, bvec and the output once (268 MB at [1024, 256,
// 256], 0.08 ms at 3.35 TB/s); ~22 f32 operations an element of M, none
// fused (1.5 G at that shape, ~0.05 ms at the card's 33 T non-FMA
// instructions a second).

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;                // output columns a CTA
constexpr int kWarps = 8;                // chunks of a row block, a warp each
constexpr int kThreads = kCols * kWarps;
constexpr int kPitch = kCols + 1;        // tile row pitch: no bank conflicts

// refine._split: x = hi + lo with hi the top 12 mantissa bits.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  const float t = __fmul_rn(x, 4097.0f);
  hi = __fsub_rn(t, __fsub_rn(t, x));
  lo = __fsub_rn(x, hi);
}

// One step of refine._kahan_sum_chunks: s += x, its error into comp.
__device__ __forceinline__ void kahan_add(float& s, float& comp, float x) {
  const float t = __fadd_rn(s, x);
  const float z = __fsub_rn(t, s);
  comp = __fadd_rn(comp,
                   __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(x, z)));
  s = t;
}

__global__ void __launch_bounds__(kThreads) dd_rowmat_kernel(
    const float* __restrict__ bvec, long long sbb, long long sbj,
    const float* __restrict__ y, long long syb, long long syi,
    const float* __restrict__ M, long long smb, long long smi, long long smj,
    float* __restrict__ out, float* scratch, int m, int n, int chunk,
    int tiles) {
  extern __shared__ float smem[];
  const int rows = kWarps * chunk;  // rows of a row block
  const int K = (m + chunk - 1) / chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long cta = blockIdx.x;
  const long long b = cta / tiles;
  const int j0 = (int)(cta % tiles) * kCols;
  float* tile = smem;                 // [rows][kPitch]: the block's M
  float* yv = tile + rows * kPitch;   // the block's y and its halves
  float* yh = yv + rows;
  float* yl = yh + rows;
  float* S = scratch ? scratch + cta * 2LL * K * kCols : yl + rows;
  float* E = S + (long long)K * kCols;  // S, E: [K][kCols]
  const float* Mb = M + b * smb;
  const float* yb = y + b * syb;
  const bool rows_fast = smi == 1 && smj != 1;  // M's transposed view

  for (int i0 = 0, k0 = 0; k0 < K; i0 += rows, k0 += kWarps) {
    for (int idx = tid; idx < rows * kCols; idx += kThreads) {
      const int r = rows_fast ? idx % rows : idx / kCols;
      const int c = rows_fast ? idx / rows : idx % kCols;
      const int i = i0 + r, j = j0 + c;
      tile[r * kPitch + c] = (i < m && j < n) ? Mb[i * smi + j * smj] : 0.0f;
    }
    for (int r = tid; r < rows; r += kThreads) {
      const int i = i0 + r;
      const float v = i < m ? yb[i * syi] : 0.0f;
      float hi, lo;
      split(v, hi, lo);
      yv[r] = v;
      yh[r] = hi;
      yl[r] = lo;
    }
    __syncthreads();
    const int k = k0 + warp;
    if (k < K) {
      // refine._dd_chunk_products, one chunk of one column
      float s = 0.0f, e = 0.0f;
      for (int c = 0; c < chunk; ++c) {
        const int r = warp * chunk + c;
        const float a = tile[r * kPitch + lane];
        float ah, al;
        split(a, ah, al);
        const float p = __fmul_rn(yv[r], a);
        float pe = __fsub_rn(__fmul_rn(yh[r], ah), p);  // TwoProd's error
        pe = __fadd_rn(pe, __fmul_rn(yh[r], al));
        pe = __fadd_rn(pe, __fmul_rn(yl[r], ah));
        pe = __fadd_rn(pe, __fmul_rn(yl[r], al));
        const float t = __fadd_rn(s, p);  // TwoSum(s, p)
        const float z = __fsub_rn(t, s);
        const float err =
            __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(p, z));
        s = t;
        e = __fadd_rn(e, __fadd_rn(pe, err));
      }
      S[k * kCols + lane] = s;
      E[k * kCols + lane] = e;
    }
    __syncthreads();
  }

  const int j = j0 + lane;
  if (warp != 0 || j >= n) return;
  float sum, comp = 0.0f;
  if (bvec != nullptr) {  // [bvec, -s, -e]
    sum = bvec[b * sbb + j * sbj];
    for (int k = 0; k < K; ++k) kahan_add(sum, comp, -S[k * kCols + lane]);
    for (int k = 0; k < K; ++k) kahan_add(sum, comp, -E[k * kCols + lane]);
  } else {  // [s, e]
    sum = S[lane];
    for (int k = 1; k < K; ++k) kahan_add(sum, comp, S[k * kCols + lane]);
    for (int k = 0; k < K; ++k) kahan_add(sum, comp, E[k * kCols + lane]);
  }
  out[b * n + j] = __fadd_rn(sum, comp);
}

__global__ void __launch_bounds__(256) dd_kahan_sum_kernel(
    const float* __restrict__ P, long long spb, long long spk, long long spj,
    float* __restrict__ out, long long total, int K, int n) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const float* p = P + (idx / n) * spb + (idx % n) * spj;
  float sum = p[0], comp = 0.0f;
#pragma unroll 4
  for (int k = 1; k < K; ++k) kahan_add(sum, comp, p[k * spk]);
  out[idx] = __fadd_rn(sum, comp);
}

// Shared memory of dd_rowmat_kernel without the pairs: the tile, y and its
// halves.
size_t base_smem(int chunk) {
  const size_t rows = (size_t)kWarps * chunk;
  return (rows * kPitch + 3 * rows) * sizeof(float);
}

// The pairs' floats a CTA (2 K kCols) and whether they fit in shared memory
// beside the base under the device's opt-in limit; else they go to scratch.
cudaError_t pairs_plan(int m, int chunk, size_t* base, size_t* pairs,
                       bool* fit) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *base = base_smem(chunk);
  *pairs = (size_t)2 * ((m + chunk - 1) / chunk) * kCols;
  if (*base > (size_t)limit) return cudaErrorInvalidValue;
  *fit = *base + *pairs * sizeof(float) <= (size_t)limit;
  return cudaSuccess;
}

}  // namespace

// Floats of the scratch buffer lp_dd_rowmat needs at this shape: 0 where
// the pairs fit in shared memory (every m below ~7,000 at chunk 8 on the
// H100's 227 KB), else B * tiles * 2 K * 32; a negative CUDA error code on
// failure.
extern "C" long long lp_dd_rowmat_scratch_floats(int B, int m, int n,
                                                 int chunk) {
  if (B < 1 || m < 0 || n < 1 || chunk < 1)
    return -(long long)cudaErrorInvalidValue;
  size_t base = 0, pairs = 0;
  bool fit = false;
  const cudaError_t e = pairs_plan(m, chunk, &base, &pairs, &fit);
  if (e != cudaSuccess) return -(long long)e;
  const long long tiles = (n + kCols - 1) / kCols;
  return fit ? 0 : (long long)B * tiles * (long long)pairs;
}

// `scratch` holds lp_dd_rowmat_scratch_floats(B, m, n, chunk) floats, or is
// null where that is 0.
extern "C" int lp_dd_rowmat(const float* bvec, long long sbb, long long sbj,
                            const float* y, long long syb, long long syi,
                            const float* M, long long smb, long long smi,
                            long long smj, float* out, float* scratch, int B,
                            int m, int n, int chunk, void* stream) {
  if (B < 1 || m < 0 || n < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  if (bvec == nullptr && m == 0) return (int)cudaErrorInvalidValue;
  size_t base = 0, pairs = 0;
  bool fit = false;
  cudaError_t e = pairs_plan(m, chunk, &base, &pairs, &fit);
  if (e != cudaSuccess) return (int)e;
  if (fit) scratch = nullptr;
  else if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = fit ? base + pairs * sizeof(float) : base;
  e = cudaFuncSetAttribute(dd_rowmat_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + kCols - 1) / kCols;
  dd_rowmat_kernel<<<(unsigned)((long long)B * tiles), kThreads, smem,
                     (cudaStream_t)stream>>>(bvec, sbb, sbj, y, syb, syi, M,
                                             smb, smi, smj, out, scratch, m,
                                             n, chunk, tiles);
  return (int)cudaGetLastError();
}

extern "C" int lp_dd_kahan_sum(const float* P, long long spb, long long spk,
                               long long spj, float* out, int B, int K, int n,
                               void* stream) {
  if (B < 1 || K < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * n;
  const unsigned grid = (unsigned)((total + 255) / 256);
  dd_kahan_sum_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      P, spb, spk, spj, out, total, K, n);
  return (int)cudaGetLastError();
}
