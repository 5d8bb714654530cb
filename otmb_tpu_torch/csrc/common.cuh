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
// the card holds at once (`slots`; `per_sm` of them on each SM). Its walk may
// be split into chunks of kMinChunk levels or more where the tiles are few.
constexpr int kMinChunk = 4;

template <typename Kernel>
inline cudaError_t block_slots(Kernel kernel, int threads, size_t bytes, long long* slots,
                               int* per_sm_out = nullptr) {
  cudaError_t err = allow_shared(kernel, bytes);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  *slots = static_cast<long long>(sms) * per_sm;
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  if (err == cudaSuccess && *slots < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// The chunks of levels a k-marching kernel's `blocks` tiles split their
// walk of nz levels into, `slots` blocks running at once: the count that
// ends soonest, each wave of blocks costing its chunk's levels plus kFill
// steps to fill the walk's pipeline. One chunk can leave a last wave of few
// blocks that walks all the levels alone (1 degree: 456 tiles, 396 slots).
// With `per_sm` > 1, where the tiles overfill the card, waves count in
// parts of per_sm: a block that has its SM to itself walks that much faster
// (K6 in groups of 8, two blocks an SM: 456 tiles on 264 slots end sooner
// in two chunks, as measured, than in one).
constexpr int kFill = 2;

inline int pick_chunks(long long blocks, long long slots, int nz, int per_sm = 1) {
  const long long parts = blocks > slots ? per_sm : 1;
  int best = 1;
  long long best_cost = -1;
  for (int n = 1; n <= nz / kMinChunk; ++n) {
    const int span = (nz + n - 1) / n, used = (nz + span - 1) / span;
    const long long cost = (blocks * used * parts + slots - 1) / slots * (span + kFill);
    if (best_cost < 0 || cost < best_cost) best = n, best_cost = cost;
  }
  return best;
}

}  // namespace otmb
