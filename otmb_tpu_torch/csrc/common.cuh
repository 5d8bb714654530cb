// Shared helpers of the otmb_tpu_torch kernels.
//
// Every entry point has a plain C interface: raw pointers, sizes, the
// CUDA stream, and a cudaError_t returned from cudaGetLastError() right
// after the launch, so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define OTMB_EXPORT extern "C" __attribute__((visibility("default")))

namespace otmb {

// Widen a stored coefficient to the accumulation type (exact).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kBlock = 128;

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

}  // namespace otmb
