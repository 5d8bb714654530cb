// K2: per-column tridiagonal (Thomas) solve, for every (j, i) column
//     upper[k] * x[k-1] + diag[k] * x[k] + lower[k] * x[k+1] = b[k],
// in two kernels: the factorization of the legs, once per system, and the
// solve of one right-hand side or a batch against it.
//
// Replaces the Pallas kernel otmb_tpu/ops/tridiag_pallas.py:_thomas_kernel,
// the vertical-line preconditioner of the Krylov solves.
//
// Factor (thomas_factor_kernel): cp = lower/denom and rden = 1/denom, with
// denom = diag - upper*cp_prev and a denom of exactly 0 replaced by 1, one
// thread per column. The legs never change during a solve, so the engine
// factors once per system; K3 (csrc/krylov.cu) runs on the same factor.
//
// Solve (thomas_solve_kernel): dp = (b - upper*dp_prev) * rden up the
// column, then x = dp - cp*x_next down it. Bound on the H100: device-memory
// bandwidth; cp, rden, upper and b are read once and x written once (5
// streams, 20 bytes per cell in f32), and dp never leaves the chip. At 1
// degree there are only 108,000 columns, so what binds a column walk is the
// latency of its dependent loads, not the bandwidth. Design: a block is
// kCols columns (i fastest, coalesced) by a group of batch members; the
// block stages its column segments kChunk levels at a time into shared
// memory with cp.async, double-buffered, so the next chunk is in flight
// while the recurrence runs on this one; upper and rden (and cp in the back
// sweep) are staged once for all members of the group. Each thread keeps
// its column's dp in shared memory (nz values) and runs the back sweep out
// of it. The group of members is as large as fits in half an SM's shared
// memory (so two blocks share an SM); a larger batch takes more groups,
// blockIdx.y, each reading the factor again.
//
// Operation order is that of the plain version (ops/tridiag.py) and of
// _tridiag_preconditioner in otmb_tpu/models/solvers.py: cp = lower/denom
// by a true division, dp = (b - upper*dp_prev) * (1/denom), and a denom
// of exactly 0 replaced by 1. The library is built with -fmad=false, so
// b - upper*dp_prev is not contracted into an FMA and the kernel equals
// the plain version bit for bit; member b of a batch equals the solve of
// member b alone.
#include "common.cuh"

namespace otmb {

constexpr int kCols = 64;   // columns of a block, along i
constexpr int kChunk = 8;   // levels staged per cp.async group
constexpr int kMaxGroup = 16;
constexpr size_t kHalfSm = kMaxSharedBytes / 2;

template <typename T>
__global__ void thomas_factor_kernel(const T* __restrict__ lower, const T* __restrict__ diag,
                                     const T* __restrict__ upper, T* __restrict__ cp,
                                     T* __restrict__ rden, int nz, long long plane) {
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= plane) return;
  T cp_prev = T(0);
  for (int k = 0; k < nz; ++k) {
    const long long c = k * plane + col;
    T denom = diag[c] - upper[c] * cp_prev;
    denom = denom != T(0) ? denom : T(1);
    cp_prev = lower[c] / denom;
    cp[c] = cp_prev;
    rden[c] = T(1) / denom;
  }
}

// Shared memory: the staging ring stage[2][kChunk][group + 2][kCols] (rows:
// upper or cp, rden, then one b per member), then dp[nz][group][kCols].
template <typename T>
__global__ void __launch_bounds__(kCols * kMaxGroup)
thomas_solve_kernel(const T* __restrict__ cp, const T* __restrict__ rden,
                    const T* __restrict__ upper, const T* __restrict__ b, T* __restrict__ x,
                    int nz, long long plane, int nmembers, long long member_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stage = reinterpret_cast<T*>(smem_raw);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int group = blockDim.y;
  const int rows = group + 2;
  T* const dp = stage + 2 * kChunk * rows * kCols;
  const long long col = static_cast<long long>(blockIdx.x) * kCols + tx;
  const int member = blockIdx.y * group + ty;
  const bool in_plane = col < plane;
  const bool live = in_plane && member < nmembers;
  const T* __restrict__ bm = b + member * member_stride;
  T* __restrict__ xm = x + member * member_stride;
  const int nchunks = (nz + kChunk - 1) / kChunk;
  auto slot = [&](int buf, int l, int row) -> T* {
    return stage + ((buf * kChunk + l) * rows + row) * kCols + tx;
  };
  // Stage chunk c of the forward sweep (upper, rden, b), or of the back
  // sweep (cp), into buffer `buf`; the factor rows by one member's thread.
  auto stage_chunk = [&](int c, int buf, bool forward) {
    const int k0 = c * kChunk;
    if (in_plane) {
      for (int l = 0; l < kChunk && k0 + l < nz; ++l) {
        const long long g = (k0 + l) * plane + col;
        if (ty == 0) cp_async(slot(buf, l, 0), (forward ? upper : cp) + g);
        if (forward && ty == group - 1) cp_async(slot(buf, l, 1), rden + g);
        if (forward && member < nmembers) cp_async(slot(buf, l, 2 + ty), bm + g);
      }
    }
    cp_async_commit();
  };

  // forward sweep, chunk by chunk up the column
  T dp_prev = T(0);
  stage_chunk(0, 0, true);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage_chunk(c + 1, (c + 1) & 1, true);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const int k0 = c * kChunk;
      for (int l = 0; l < kChunk && k0 + l < nz; ++l) {
        const T up = *slot(c & 1, l, 0);
        const T rd = *slot(c & 1, l, 1);
        dp_prev = (*slot(c & 1, l, 2 + ty) - up * dp_prev) * rd;
        dp[((k0 + l) * group + ty) * kCols + tx] = dp_prev;
      }
    }
    __syncthreads();
  }

  // back substitution, chunk by chunk down the column
  T x_next = T(0);
  stage_chunk(nchunks - 1, 0, false);
  for (int q = 0; q < nchunks; ++q) {
    const int c = nchunks - 1 - q;
    if (q + 1 < nchunks) {
      stage_chunk(c - 1, (q + 1) & 1, false);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const int k0 = c * kChunk;
      const int last = (k0 + kChunk < nz ? kChunk : nz - k0) - 1;
      for (int l = last; l >= 0; --l) {
        const int k = k0 + l;
        x_next = dp[(k * group + ty) * kCols + tx] - *slot(q & 1, l, 0) * x_next;
        xm[k * plane + col] = x_next;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_thomas_factor(const void* lower, const void* diag, const void* upper, void* cp,
                         void* rden, int nz, int ny, int nx, void* stream) {
  const long long plane = static_cast<long long>(ny) * nx;
  thomas_factor_kernel<T><<<blocks_for(plane), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lower), static_cast<const T*>(diag), static_cast<const T*>(upper),
      static_cast<T*>(cp), static_cast<T*>(rden), nz, plane);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_thomas_solve(const void* cp, const void* rden, const void* upper, const void* b,
                        void* x, int nz, int ny, int nx, int nmembers, void* stream) {
  const long long plane = static_cast<long long>(ny) * nx;
  const size_t fixed = 2 * kChunk * 2 * kCols * sizeof(T);
  const size_t per_member = (2 * kChunk + static_cast<size_t>(nz)) * kCols * sizeof(T);
  int group = kHalfSm > fixed ? static_cast<int>((kHalfSm - fixed) / per_member) : 0;
  group = group < 1 ? 1 : group;
  group = group < nmembers ? group : nmembers;
  group = group < kMaxGroup ? group : kMaxGroup;
  const size_t bytes = fixed + group * per_member;
  if (bytes > static_cast<size_t>(kMaxSharedBytes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_shared(thomas_solve_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((plane + kCols - 1) / kCols),
                  (nmembers + group - 1) / group);
  thomas_solve_kernel<T><<<grid, dim3(kCols, group), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cp), static_cast<const T*>(rden), static_cast<const T*>(upper),
      static_cast<const T*>(b), static_cast<T*>(x), nz, plane, nmembers, nz * plane);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

#define OTMB_THOMAS_ENTRIES(SUFFIX, T)                                                          \
  OTMB_EXPORT int otmb_thomas_factor_##SUFFIX(const void* lower, const void* diag,             \
                                              const void* upper, void* cp, void* rden, int nz, \
                                              int ny, int nx, void* stream) {                  \
    return otmb::launch_thomas_factor<T>(lower, diag, upper, cp, rden, nz, ny, nx, stream);    \
  }                                                                                            \
  OTMB_EXPORT int otmb_thomas_solve_##SUFFIX(const void* cp, const void* rden,                 \
                                             const void* upper, const void* b, void* x,        \
                                             int nz, int ny, int nx, int nmembers,             \
                                             void* stream) {                                   \
    return otmb::launch_thomas_solve<T>(cp, rden, upper, b, x, nz, ny, nx, nmembers, stream);  \
  }

OTMB_THOMAS_ENTRIES(f32, float)
OTMB_THOMAS_ENTRIES(f64, double)
