// Microbenchmark: what one cluster barrier, and one cluster barrier plus one
// reduction through distributed shared memory, cost on the card. The
// cluster-resident segment kernels (csrc/solve_segment.cu,
// csrc/solve_bounded_segment.cu) take four or five of each an iteration, so
// they may set the pace of an iteration.
//
// Build and run on a machine with an H100 (no dependency on the package):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o cluster_sync_bench \
//        tools/cluster_sync_bench.cu && ./cluster_sync_bench
// Each line: cluster size, clusters launched (one, or as many as the card
// holds at once), the floats each CTA reduces (0: the barrier alone), and
// the microseconds of one round (barrier + reduction) on the device clock.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdio.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kRounds = 2000;

template <int CL>
__global__ void bench(int floats, float* sink) {
  extern __shared__ float part[];  // this CTA's partial over every entry
  __shared__ float own[1024];      // its reduced slice
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  for (int i = threadIdx.x; i < floats; i += kThreads) part[i] = rank + i;
  const int slice = floats / CL, lo = rank * slice;
  float acc = 0.0f;
  cl.sync();
  for (int r = 0; r < kRounds; ++r) {
    for (int i = threadIdx.x; i < slice; i += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < CL; ++c) s += cl.map_shared_rank(part, c)[lo + i];
      own[i] = s;
    }
    cl.sync();
    if (threadIdx.x < slice) acc += own[threadIdx.x];
  }
  if (acc == 12345.0f) sink[0] = acc;
  cl.sync();
}

template <int CL>
void run(int floats, bool fill) {
  auto k = bench<CL>;
  const size_t smem = (size_t)(floats > 0 ? floats : 1) * 4;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (CL > 8) cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(CL);
  int clusters = 1;
  if (fill) {
    cudaOccupancyMaxActiveClusters(&clusters, k, &cfg);
    cfg.gridDim = dim3(CL * clusters);
  }
  float* sink;
  cudaMalloc(&sink, 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&cfg, k, floats, sink);  // warm-up
  cudaEventRecord(a);
  cudaLaunchKernelEx(&cfg, k, floats, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  cudaError_t e = cudaGetLastError();
  printf("cluster=%d clusters=%d floats=%d: %.3f us a round %s\n", CL, clusters,
         floats, 1e3f * ms / kRounds, e == cudaSuccess ? "" : cudaGetErrorString(e));
  cudaFree(sink);
}

int main() {
  const int floats[] = {0, 512, 1024};
  for (int fill = 0; fill < 2; ++fill)
    for (int f : floats) {
      run<2>(f, fill);
      run<4>(f, fill);
      run<8>(f, fill);
      run<16>(f, fill);
    }
  return 0;
}
