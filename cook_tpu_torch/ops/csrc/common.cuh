// Shared helpers of the cycle's CUDA stage kernels (sm_90a).
//
// Every C entry point launches on the stream it is given, allocates
// nothing (the Python wrapper passes outputs and scratch) and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
// Built with -fmad=false and without fast math: float sums, products and
// divisions round exactly as the plain PyTorch versions' do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define COOK_API extern "C" __attribute__((visibility("default")))

namespace cook {

constexpr int kThreads = 256;

inline unsigned grid_for(long long n, int threads = kThreads) {
  long long g = (n + threads - 1) / threads;
  return (unsigned)(g > 0 ? g : 1);
}

__device__ __forceinline__ long long gtid() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

inline int last_error() { return (int)cudaGetLastError(); }

}  // namespace cook
