// K11 and K12: the vector algebra of a BiCGStab(2) cycle around K3.
//
// The JAX package runs its BiCGStab(2) cycle (otmb_tpu/models/solvers.py:
// _sr_chunk2_fused, _bicgstab2_cycles) as one jitted fori_loop, so XLA
// fuses the cycle's axpys and its five polish dots into a few loop fusions;
// there is no Pallas kernel for them. Eager PyTorch would issue each dot and
// each axpy as its own pass. These two kernels do the cycle's end in two:
//
//   K11, the polish sums (one pass over r0, u1, r1, r2):
//     r0' = r0 - alpha * u1
//     sums = (<r1, r1>, <r1, r2>, <r2, r2>, <r0', r1>, <r0', r2>)
//
//   K12, the polish update (one pass), with <rhat, r0''> for the next cycle:
//     y'   = ((y + alpha * u0) + w1 * r0) + w2 * r1
//     r0'' = (r0 - w1 * r1) - w2 * r2
//     u0'  = (u0 - w1 * u1) - w2 * u2
//     d    = <rhat, r0''>     (only with `dot`)
//
// A field (nz, ny, nx) is one member; a batch (B, nz, ny, nx) has B
// members, each with its own scalars (alpha, w1, w2: B values on the
// device) and its own sums, all in one launch (blockIdx.y = member).
//
// Bound on the H100: device-memory bandwidth. K11 moves 5 streams (4 reads,
// 1 write) with 12 flops a cell, K12 11 streams (8 reads, 3 writes) with 14;
// the eager sequence they replace moves 36 (the five dots 10, the four
// axpys of r0, y, y, y and the two of r0 and u0 each 3, and <rhat, r0> 2).
//
// Design. Each block takes tiles of kAlgTile consecutive cells of one
// member, a grid-stride apart; a thread loads its kAlgPer cells of every
// stream of a tile first (all loads in flight together), then computes and
// stores. The sums accumulate in double per thread, in a fixed order, then
// in a fixed shuffle tree per block; a second small kernel adds the
// blocks' partials of each member in a fixed order. The number of blocks
// per member depends on the member's size only, so every sum is the same
// bits on every run (no floating-point atomics): BiCGStab's iterates repeat
// from run to run. The sums are rounded to the field's type at the end, as
// K3's dot is.
//
// Precision and order: each update is formed in double from the stored
// values and rounded to the field's type once. An f32 update chained in f32
// (four to six roundings, of terms that cancel as BiCGStab converges) lets
// the recurrence residual r0 drift from the true b - K y; on an H100 that
// drift ended 0.25-degree refinement passes early. The library is built
// with -fmad=false, so every `a + s * x` is a product and a sum, each
// rounded, as the plain PyTorch version (ops/krylov_algebra.py) computes
// them in float64.
#include "common.cuh"

namespace otmb {

constexpr int kAlgThreads = 256;
constexpr int kAlgPer = 4;                       // cells a thread takes from a tile
constexpr int kAlgTile = kAlgThreads * kAlgPer;  // keep in ops/krylov_algebra.py
constexpr int kAlgMaxBlocks = 1024;              // blocks per member, keep in ops/krylov_algebra.py
constexpr int kAlgWarps = kAlgThreads / 32;
constexpr int kAlgFinishThreads = 256;
constexpr int kPolishSums = 5;

inline long long alg_blocks(long long n) {
  const long long tiles = (n + kAlgTile - 1) / kAlgTile;
  return tiles < kAlgMaxBlocks ? tiles : kAlgMaxBlocks;
}

// The block's S sums in a fixed order: a shuffle tree per warp, then warp 0
// over the warp sums; lane 0 of warp 0 writes them to out[0..S).
template <int S>
__device__ __forceinline__ void block_sums(const double (&v)[S],
                                           double (*warp_sums)[kAlgWarps], double* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    double x = v[s];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[s][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      double x = lane < kAlgWarps ? warp_sums[s][lane] : 0.0;
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) out[s] = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kAlgThreads)
polish_sums_kernel(const T* __restrict__ r0, const T* __restrict__ u1, const T* __restrict__ r1,
                   const T* __restrict__ r2, const T* __restrict__ alpha,
                   T* __restrict__ r0_out, double* __restrict__ partials, long long n) {
  __shared__ double warp_sums[kPolishSums][kAlgWarps];
  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * n;
  const double a = alpha[b];
  const long long tiles = (n + kAlgTile - 1) / kAlgTile;
  double acc[kPolishSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e0 = tile * kAlgTile + threadIdx.x;
    T x0[kAlgPer], xu[kAlgPer], x1[kAlgPer], x2[kAlgPer];
#pragma unroll
    for (int q = 0; q < kAlgPer; ++q) {
      const long long e = e0 + q * kAlgThreads;
      const bool in = e < n;
      const long long c = base + (in ? e : 0);
      x0[q] = in ? r0[c] : T(0);
      xu[q] = in ? u1[c] : T(0);
      x1[q] = in ? r1[c] : T(0);
      x2[q] = in ? r2[c] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kAlgPer; ++q) {
      const long long e = e0 + q * kAlgThreads;
      if (e < n) {
        const T r = static_cast<T>(double(x0[q]) - a * double(xu[q]));
        r0_out[base + e] = r;
        const double d0 = r, d1 = x1[q], d2 = x2[q];
        acc[0] += d1 * d1;
        acc[1] += d1 * d2;
        acc[2] += d2 * d2;
        acc[3] += d0 * d1;
        acc[4] += d0 * d2;
      }
    }
  }
  block_sums<kPolishSums>(
      acc, warp_sums,
      partials + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * kPolishSums);
}

template <typename T, bool kDot>
__global__ void __launch_bounds__(kAlgThreads)
polish_update_kernel(const T* __restrict__ y, const T* __restrict__ u0,
                     const T* __restrict__ r0, const T* __restrict__ r1,
                     const T* __restrict__ r2, const T* __restrict__ u1,
                     const T* __restrict__ u2, const T* __restrict__ rhat,
                     const T* __restrict__ alpha, const T* __restrict__ w1p,
                     const T* __restrict__ w2p, T* __restrict__ y_out, T* __restrict__ r0_out,
                     T* __restrict__ u0_out, double* __restrict__ partials, long long n) {
  __shared__ double warp_sums[1][kAlgWarps];
  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * n;
  const double a = alpha[b];
  const double w1 = w1p[b];
  const double w2 = w2p[b];
  const long long tiles = (n + kAlgTile - 1) / kAlgTile;
  double acc[1] = {0.0};
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e0 = tile * kAlgTile + threadIdx.x;
    T xy[kAlgPer], xu0[kAlgPer], xr0[kAlgPer], xr1[kAlgPer], xr2[kAlgPer], xu1[kAlgPer],
        xu2[kAlgPer], xh[kAlgPer];
#pragma unroll
    for (int q = 0; q < kAlgPer; ++q) {
      const long long e = e0 + q * kAlgThreads;
      const bool in = e < n;
      const long long c = base + (in ? e : 0);
      xy[q] = in ? y[c] : T(0);
      xu0[q] = in ? u0[c] : T(0);
      xr0[q] = in ? r0[c] : T(0);
      xr1[q] = in ? r1[c] : T(0);
      xr2[q] = in ? r2[c] : T(0);
      xu1[q] = in ? u1[c] : T(0);
      xu2[q] = in ? u2[c] : T(0);
      xh[q] = (kDot && in) ? rhat[c] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kAlgPer; ++q) {
      const long long e = e0 + q * kAlgThreads;
      if (e < n) {
        const T yv = static_cast<T>(((double(xy[q]) + a * double(xu0[q])) + w1 * double(xr0[q])) +
                                    w2 * double(xr1[q]));
        const T rv = static_cast<T>((double(xr0[q]) - w1 * double(xr1[q])) - w2 * double(xr2[q]));
        const T uv = static_cast<T>((double(xu0[q]) - w1 * double(xu1[q])) - w2 * double(xu2[q]));
        y_out[base + e] = yv;
        r0_out[base + e] = rv;
        u0_out[base + e] = uv;
        if (kDot) acc[0] += static_cast<double>(xh[q]) * static_cast<double>(rv);
      }
    }
  }
  if (kDot) {
    block_sums<1>(acc, warp_sums,
                  partials + static_cast<long long>(b) * gridDim.x + blockIdx.x);
  }
}

// out[b * S + s] = the sum over the member's blocks p of partials[(b * nblk
// + p) * S + s], in a fixed order, rounded to T: thread t sums blocks t,
// t + 256, ... in turn, then a shuffle tree and warp 0 over the warps.
template <typename T, int S>
__global__ void __launch_bounds__(kAlgFinishThreads)
alg_finish_kernel(const double* __restrict__ partials, int nblk, T* __restrict__ out) {
  __shared__ double warp_sums[kAlgFinishThreads / 32];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const double* p = partials + static_cast<long long>(b) * nblk * S;
  for (int s = 0; s < S; ++s) {
    double v = 0.0;
    for (int q = t; q < nblk; q += kAlgFinishThreads) v += p[static_cast<long long>(q) * S + s];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((t & 31) == 0) warp_sums[t >> 5] = v;
    __syncthreads();
    if (t < 32) {
      v = t < kAlgFinishThreads / 32 ? warp_sums[t] : 0.0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (t == 0) out[static_cast<long long>(b) * S + s] = static_cast<T>(v);
    }
    __syncthreads();
  }
}

inline bool alg_shape_ok(long long n, int members, int nblk) {
  return n > 0 && members > 0 && members <= 65535 && nblk == alg_blocks(n);
}

template <typename T>
int launch_polish_sums(const void* r0, const void* u1, const void* r1, const void* r2,
                       const void* alpha, void* r0_out, void* partials, void* sums,
                       long long n, int members, int nblk, cudaStream_t s) {
  if (!alg_shape_ok(n, members, nblk)) return static_cast<int>(cudaErrorInvalidValue);
  auto c = [](const void* q) { return static_cast<const T*>(q); };
  polish_sums_kernel<T><<<dim3(nblk, members), kAlgThreads, 0, s>>>(
      c(r0), c(u1), c(r1), c(r2), c(alpha), static_cast<T*>(r0_out),
      static_cast<double*>(partials), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  alg_finish_kernel<T, kPolishSums><<<members, kAlgFinishThreads, 0, s>>>(
      static_cast<const double*>(partials), nblk, static_cast<T*>(sums));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_polish_update(const void* y, const void* u0, const void* r0, const void* r1,
                         const void* r2, const void* u1, const void* u2, const void* rhat,
                         const void* alpha, const void* w1, const void* w2, void* y_out,
                         void* r0_out, void* u0_out, void* partials, void* d, long long n,
                         int members, int nblk, int dot, cudaStream_t s) {
  if (!alg_shape_ok(n, members, nblk)) return static_cast<int>(cudaErrorInvalidValue);
  auto c = [](const void* q) { return static_cast<const T*>(q); };
  const dim3 grid(nblk, members);
  if (dot) {
    polish_update_kernel<T, true><<<grid, kAlgThreads, 0, s>>>(
        c(y), c(u0), c(r0), c(r1), c(r2), c(u1), c(u2), c(rhat), c(alpha), c(w1), c(w2),
        static_cast<T*>(y_out), static_cast<T*>(r0_out), static_cast<T*>(u0_out),
        static_cast<double*>(partials), n);
  } else {
    polish_update_kernel<T, false><<<grid, kAlgThreads, 0, s>>>(
        c(y), c(u0), c(r0), c(r1), c(r2), c(u1), c(u2), nullptr, c(alpha), c(w1), c(w2),
        static_cast<T*>(y_out), static_cast<T*>(r0_out), static_cast<T*>(u0_out), nullptr, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !dot) return static_cast<int>(err);
  alg_finish_kernel<T, 1><<<members, kAlgFinishThreads, 0, s>>>(
      static_cast<const double*>(partials), nblk, static_cast<T*>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

#define OTMB_ALGEBRA_ENTRIES(SUFFIX, T)                                                         \
  OTMB_EXPORT int otmb_polish_sums_##SUFFIX(const void* r0, const void* u1, const void* r1,    \
                                            const void* r2, const void* alpha, void* r0_out,   \
                                            void* partials, void* sums, long long n,           \
                                            int members, int nblk, void* stream) {             \
    return otmb::launch_polish_sums<T>(r0, u1, r1, r2, alpha, r0_out, partials, sums, n,       \
                                       members, nblk, static_cast<cudaStream_t>(stream));      \
  }                                                                                            \
  OTMB_EXPORT int otmb_polish_update_##SUFFIX(                                                 \
      const void* y, const void* u0, const void* r0, const void* r1, const void* r2,           \
      const void* u1, const void* u2, const void* rhat, const void* alpha, const void* w1,     \
      const void* w2, void* y_out, void* r0_out, void* u0_out, void* partials, void* d,        \
      long long n, int members, int nblk, int dot, void* stream) {                             \
    return otmb::launch_polish_update<T>(y, u0, r0, r1, r2, u1, u2, rhat, alpha, w1, w2,       \
                                         y_out, r0_out, u0_out, partials, d, n, members, nblk, \
                                         dot, static_cast<cudaStream_t>(stream));              \
  }

OTMB_ALGEBRA_ENTRIES(f32, float)
OTMB_ALGEBRA_ENTRIES(f64, double)
