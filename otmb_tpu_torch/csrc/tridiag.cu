// K2: per-column tridiagonal (Thomas) solve, for every (j, i) column
//     upper[k] * x[k-1] + diag[k] * x[k] + lower[k] * x[k+1] = b[k].
//
// Replaces the Pallas kernel otmb_tpu/ops/tridiag_pallas.py:_thomas_kernel,
// the vertical-line preconditioner of the Krylov solves.
//
// Bound on the H100: device-memory bandwidth. lower, diag, upper and b are
// read once and x written once (5 streams, 20 bytes per cell in f32); cp
// makes one round trip through a scratch tensor the wrapper allocates, and
// x is written twice (dp in the forward sweep, then x in place). Design:
// one thread per column with i fastest, so at every level k a warp reads
// 32 consecutive cells of each stream; the k loops are the sequential
// part and run inside the thread.
//
// A batch of right-hand sides (B, nz, ny, nx) that shares the legs runs in
// the same launch: blockIdx.y is the member, whose b, x and cp lie at
// member * member_stride. B = 1 is the unbatched solve.
//
// Operation order is that of the plain version (ops/tridiag.py) and of
// _tridiag_preconditioner in otmb_tpu/models/solvers.py: cp = lower/denom
// by a true division, dp = (b - upper*dp_prev) * (1/denom), and a denom
// of exactly 0 replaced by 1. The library is built with -fmad=false, so
// b - upper*dp_prev is not contracted into an FMA and the kernel equals
// the plain version bit for bit.
#include "common.cuh"

namespace otmb {

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ lower, const T* __restrict__ diag,
                              const T* __restrict__ upper, const T* __restrict__ b,
                              T* __restrict__ x, T* __restrict__ cp, int nz, long long plane,
                              long long member_stride) {
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= plane) return;
  const long long member = static_cast<long long>(blockIdx.y) * member_stride;
  const T* __restrict__ bm = b + member;
  T* __restrict__ xm = x + member;
  T* __restrict__ cpm = cp + member;

  T cp_prev = T(0);
  T dp_prev = T(0);
  for (int k = 0; k < nz; ++k) {
    const long long c = k * plane + col;
    const T up = upper[c];
    T denom = diag[c] - up * cp_prev;
    denom = denom != T(0) ? denom : T(1);
    const T cpk = lower[c] / denom;
    const T dpk = (bm[c] - up * dp_prev) * (T(1) / denom);
    cpm[c] = cpk;
    xm[c] = dpk;
    cp_prev = cpk;
    dp_prev = dpk;
  }
  T x_next = T(0);
  for (int k = nz - 1; k >= 0; --k) {
    const long long c = k * plane + col;
    const T xk = xm[c] - cpm[c] * x_next;
    xm[c] = xk;
    x_next = xk;
  }
}

template <typename T>
int launch_thomas(const void* lower, const void* diag, const void* upper, const void* b,
                  void* x, void* cp, int nz, int ny, int nx, int nmembers,
                  long long member_stride, void* stream) {
  const long long plane = static_cast<long long>(ny) * nx;
  const dim3 grid(blocks_for(plane), nmembers);
  thomas_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lower), static_cast<const T*>(diag), static_cast<const T*>(upper),
      static_cast<const T*>(b), static_cast<T*>(x), static_cast<T*>(cp), nz, plane,
      member_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

OTMB_EXPORT int otmb_thomas_f32(const void* lower, const void* diag, const void* upper,
                                const void* b, void* x, void* cp, int nz, int ny, int nx,
                                int nmembers, long long member_stride, void* stream) {
  return otmb::launch_thomas<float>(lower, diag, upper, b, x, cp, nz, ny, nx, nmembers,
                                   member_stride, stream);
}

OTMB_EXPORT int otmb_thomas_f64(const void* lower, const void* diag, const void* upper,
                                const void* b, void* x, void* cp, int nz, int ny, int nx,
                                int nmembers, long long member_stride, void* stream) {
  return otmb::launch_thomas<double>(lower, diag, upper, b, x, cp, nz, ny, nx, nmembers,
                                   member_stride, stream);
}
