// Microbenchmark: how fast one CTA per SM streams device memory through a
// shared-memory ring filled by cp.async.bulk (completion on an mbarrier), by
// copy size, copies per stage and ring depth. It is what the design of
// solve_segment_stream.cu rests on: a stage of the ring turns over in about
// the same time whatever it holds, so a few large stages of several long
// copies reach the card's rate and many small ones do not.
//
// Build and run on a machine with an H100 (no dependency on the package):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o bulk_copy_bench \
//        tools/bulk_copy_bench.cu && ./bulk_copy_bench
// Each line: CTAs (one per SM), KB per copy, copies per stage, stages, KB in
// flight per CTA, milliseconds, GB/s per SM and TB/s in total.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

__device__ __forceinline__ uint32_t s32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__global__ void bench(const float* src, size_t per_cta_floats, int copy_floats, int depth, int copies_per_stage, float* sink) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) unsigned long long bar[32];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 32; ++i) asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(s32(bar + i)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const float* base = src + (size_t)blockIdx.x * per_cta_floats;
  const int stage_floats = copy_floats * copies_per_stage;
  const int T = (int)(per_cta_floats / stage_floats);
  uint32_t phase = 0;
  float acc = 0.f;
  auto issue = [&](int t) {
    const int s = t % depth;
    if (tid == 0) asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(s32(bar + s)), "r"(stage_floats * 4) : "memory");
    __syncwarp();
    if (tid < copies_per_stage)
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(s32(ring + (size_t)s * stage_floats + tid * copy_floats)),
                   "l"(__cvta_generic_to_global(base + (size_t)t * stage_floats + tid * copy_floats)), "r"(copy_floats * 4), "r"(s32(bar + s))
                   : "memory");
  };
  if (tid < 32) for (int t = 0; t < min(depth, T); ++t) issue(t);
  for (int t = 0; t < T; ++t) {
    const int s = t % depth;
    uint32_t done;
    do {
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }" : "=r"(done) : "r"(s32(bar + s)), "r"((phase >> s) & 1u) : "memory");
    } while (!done);
    phase ^= 1u << s;
    acc += ring[(size_t)s * stage_floats + tid];
    __syncthreads();
    if (tid < 32 && t + depth < T) issue(t + depth);
  }
  if (acc == 12345.678f) sink[0] = acc;
}

int main() {
  const size_t per = ((size_t)32 << 20) / 4;  // floats per CTA: 32 MB
  const size_t total = per * 132;
  float* src; float* sink;
  cudaMalloc(&src, total * 4); cudaMalloc(&sink, 4);
  cudaMemset(src, 0, total * 4);
  cudaFuncSetAttribute(bench, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  int ctas_list[] = {64, 128, 132};  // <= 132: `total` is sized for that
  int sizes[] = {512, 2048, 8192};          // floats per copy: 2 KB, 8 KB, 32 KB
  for (int ci = 0; ci < 3; ++ci) for (int si = 0; si < 3; ++si) for (int cps = 1; cps <= 4; cps *= 4) for (int depth = 2; depth <= 16; depth *= 2) {
    const int ctas = ctas_list[ci], cf = sizes[si];
    const size_t smem = (size_t)cf * cps * depth * 4;
    if (smem > 192 * 1024) continue;
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    bench<<<ctas, 256, smem>>>(src, per, cf, depth, cps, sink);
    cudaEventRecord(a);
    bench<<<ctas, 256, smem>>>(src, per, cf, depth, cps, sink);
    cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    cudaError_t e = cudaGetLastError();
    printf("ctas=%d copy=%dKB copies/stage=%d depth=%d inflight=%zuKB: %.3f ms, %.1f GB/s per SM, %.2f TB/s total %s\n", ctas, cf * 4 / 1024, cps, depth, smem / 1024, ms,
           per * 4 / ms / 1e6, per * 4.0 * ctas / ms / 1e9, e == cudaSuccess ? "" : cudaGetErrorString(e));
  }
  return 0;
}
