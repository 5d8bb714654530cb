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

// Shared memory a block may take on the H100 (dynamic, after opting in).
constexpr int kMaxSharedBytes = 232448;

// Asynchronous copy of one 4- or 8-byte value from device to shared memory
// (cp.async, which bypasses the registers), and its groups: a thread
// commits the copies it issued as one group and waits until at most N of
// its groups are in flight. A thread's wait covers its own copies only, so
// copies other threads read need a __syncthreads after the wait.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async of 4 or 8 bytes");
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Opt a kernel in to `bytes` of dynamic shared memory above the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Opt a k-marching kernel (K5, K6: a block walks its columns' levels down)
// in to `bytes` of shared memory a block of `threads`, and count the blocks
// the card holds at once (`slots`). Its walk may be split into chunks of
// kMinChunk levels or more where the tiles are few.
constexpr int kMinChunk = 4;

template <typename Kernel>
inline cudaError_t block_slots(Kernel kernel, int threads, size_t bytes, long long* slots) {
  cudaError_t err = allow_shared(kernel, bytes);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  *slots = static_cast<long long>(sms) * per_sm;
  if (err == cudaSuccess && *slots < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace otmb
