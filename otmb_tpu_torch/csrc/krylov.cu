// K3: one fused half-step of the BiCGStab(2) engine,
//
//     z   = x1 + c2 * x2          (only with `combine`; z is x1 otherwise)
//     out = A(M(z))               (A: the 7-point stencil, its diagonal
//                                  already holding shift + extra_diag;
//                                  M: the per-column Thomas solve)
//     d   = <rhat, out>           (only with `dot`)
//
// Replaces the Pallas kernel otmb_tpu/ops/krylov_pallas.py:_krylov_kernel
// (public fused_krylov_step). Computes what the composition
// stencil_apply(a, tridiag_solve(lower, diag, upper, x1 + c2 * x2)) of the
// K2 and K1 kernels computes, in one launch that keeps M(z) out of device
// memory.
//
// M's factorization depends on the operator only: K2's factor kernel
// (csrc/tridiag.cu, thomas_factor_kernel) computes cp = lower/denom and
// rden = 1/denom once per system, and K3 runs on that same factor. Each
// half-step then runs only the z-dependent part of the solve.
//
// Bound on the H100: device-memory bandwidth. Per cell, f32: x1, x2, upper
// and rden are read (4 streams), z and dp are written (2), cp and dp are
// read in the back substitution (2), the 7 stencil legs and rhat are read
// (8) and out is written (1): 17 streams, against ~30 flops. The
// composition it replaces moves ~25 (combination, K2 with its round trips,
// K1, dot).
//
// Design. A thread block is a (kBY, kBX) tile of columns (j, i): the inner
// (kBY-2, kBX-2) columns are the block's own, the ring around them is a
// one-column halo. Every thread runs the Thomas solve of one source column:
// the forward sweep forms z on the fly and stores dp in a scratch the
// engine allocates once per solve; the back substitution then walks k from
// nz-1 down to 0. At each level the thread puts M(z)[k] of its column into a
// shared-memory slab, M(z)[k+1] stays in a register and M(z)[k-1] is the
// next step of its own recurrence, so after one __syncthreads the block's
// own threads apply the stencil with every neighbour at hand. Halo threads
// repeat their neighbour block's solve for their column; their dp stores
// write the same bits the owning block writes.
//
// The tile is 256 x 4 threads (254 x 2 columns of its own). Long rows make
// every warp's loads and stores contiguous runs of 1 KB; the halo rows,
// half the tile, are read again by the block above or below, which runs at
// the same time, so L2 serves most of that. Measured on an H100 at
// 1440x1080x75 f32 (z, out and d), per call: 32x16 4.52 ms, 64x8 3.99,
// 128x4 3.91, 128x8 3.70, 192x4 3.49, 256x4 3.47.
//
// Neighbours follow K1 and the plain apply_stencil: i is periodic; the
// halo row past the top is, on a tripolar grid, the fold partner row
// (ny-1, nx-1-i) read directly (no side stream, which the TPU needed for
// want of a lane reversal), and zero on a bipolar grid; the row below j = 0
// and the levels above k = 0 and below k = nz-1 read zero.
//
// Operation order, so that z and out equal the K2 + K1 composition bit for
// bit (the library is built with -fmad=false): z = x1 + c2*x2 in two
// roundings; the Thomas solve is K2's (cp by a true division, dp =
// (z - upper*dp_prev) * (1/denom), back substitution x = dp - cp*x_next
// from x_next = 0); the stencil sum is K1's (diag, east, west, north,
// south, top, bottom).
//
// The dot accumulates rhat*out in double, reduced first in a fixed tree
// per block, then over the blocks in a fixed order by a second small
// kernel: no floating-point atomics, so d is the same bits on every run.
#include "common.cuh"

namespace otmb {

constexpr int kBX = 256;           // threads along i
constexpr int kBY = 4;             // threads along j
constexpr int kTI = kBX - 2;       // owned columns along i (keep in ops/krylov.py)
constexpr int kTJ = kBY - 2;       // owned columns along j (keep in ops/krylov.py)
constexpr int kThreads = kBX * kBY;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 1024;

template <typename T, bool kCombine, bool kDot>
__global__ void __launch_bounds__(kThreads)
krylov_kernel(const T* __restrict__ diag, const T* __restrict__ east, const T* __restrict__ west,
              const T* __restrict__ north, const T* __restrict__ south, const T* __restrict__ top,
              const T* __restrict__ bottom, const T* __restrict__ m_upper,
              const T* __restrict__ cp, const T* __restrict__ rden,
              const T* __restrict__ x1, const T* __restrict__ x2, const T* __restrict__ c2_ptr,
              const T* __restrict__ rhat, T* __restrict__ z, T* __restrict__ out,
              T* __restrict__ dp, double* __restrict__ partials, int nz, int ny, int nx,
              int tripolar) {
  __shared__ T slab[2][kBY][kBX];
  __shared__ double warp_sums[kWarps];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i = static_cast<int>(blockIdx.x) * kTI - 1 + tx;
  const int j = static_cast<int>(blockIdx.y) * kTJ - 1 + ty;

  // The source column of this thread: i wraps; one row past the top is the
  // tripolar fold partner row; every other row outside [0, ny) is empty.
  int si = i % nx;
  if (si < 0) si += nx;
  int sj = j;
  bool valid = j >= 0 && j < ny;
  if (j == ny && tripolar) {
    sj = ny - 1;
    si = nx - 1 - si;
    valid = true;
  }
  const bool owner = tx >= 1 && tx <= kTI && ty >= 1 && ty <= kTJ && i < nx && j < ny;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long col = static_cast<long long>(sj) * nx + si;

  // Forward sweep of the Thomas solve on z. The factorization (cp and
  // rden = 1/denom) depends on the operator only and comes from K2's
  // factor kernel, once per system; dp = (z - upper*dp_prev) *
  // rden is K2's operation.
  T cp_last = T(0);
  T dp_prev = T(0);
  if (valid) {
    const T c2 = kCombine ? *c2_ptr : T(0);
    for (int k = 0; k < nz; ++k) {
      const long long c = k * plane + col;
      T zk;
      if (kCombine) {
        zk = x1[c] + c2 * x2[c];
        if (owner) z[c] = zk;
      } else {
        zk = x1[c];
      }
      const T dpk = (zk - m_upper[c] * dp_prev) * rden[c];
      dp[c] = dpk;
      dp_prev = dpk;
    }
    cp_last = cp[(nz - 1) * plane + col];
  }

  // Back substitution, level by level, with the stencil applied as soon as
  // a level's M(z) is in the slab.
  double dsum = 0.0;
  const T x_last = T(0);
  T mv_k = valid ? dp_prev - cp_last * x_last : T(0);  // M(z)[nz-1], as K2 forms it
  T mv_kp1 = T(0);
  for (int k = nz - 1; k >= 0; --k) {
    const int buf = k & 1;
    slab[buf][ty][tx] = mv_k;
    T mv_km1 = T(0);
    if (valid && k > 0) {
      const long long c = (k - 1) * plane + col;
      mv_km1 = dp[c] - cp[c] * mv_k;
    }
    __syncthreads();
    if (owner) {
      const long long c = k * plane + static_cast<long long>(j) * nx + i;
      const T xe = slab[buf][ty][tx + 1];
      const T xw = slab[buf][ty][tx - 1];
      const T xn = slab[buf][ty + 1][tx];
      const T xs = slab[buf][ty - 1][tx];
      const T xt = k > 0 ? mv_km1 : T(0);
      const T xb = k + 1 < nz ? mv_kp1 : T(0);
      T acc = diag[c] * mv_k;
      acc = acc + east[c] * xe;
      acc = acc + west[c] * xw;
      acc = acc + north[c] * xn;
      acc = acc + south[c] * xs;
      acc = acc + top[c] * xt;
      acc = acc + bottom[c] * xb;
      out[c] = acc;
      if (kDot) dsum += static_cast<double>(rhat[c]) * static_cast<double>(acc);
    }
    mv_kp1 = mv_k;
    mv_k = mv_km1;
  }

  if (kDot) {
    // Fixed-order block sum: a shuffle tree per warp, then warp 0 over the
    // warp sums.
    const int t = ty * kBX + tx;
    const int lane = t & 31;
    const int warp = t >> 5;
    double v = dsum;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? warp_sums[lane] : 0.0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partials[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = v;
    }
  }
}

// d = sum of the block partials, in a fixed order: thread t sums partials
// t, t + 1024, ... in turn, then a shuffle tree and warp 0 over the warps.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
krylov_dot_finish(const double* __restrict__ partials, int n, T* __restrict__ d) {
  __shared__ double warp_sums[kFinishThreads / 32];
  const int t = threadIdx.x;
  double v = 0.0;
  for (int b = t; b < n; b += kFinishThreads) v += partials[b];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((t & 31) == 0) warp_sums[t >> 5] = v;
  __syncthreads();
  if (t < 32) {
    v = warp_sums[t];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (t == 0) *d = static_cast<T>(v);
  }
}

struct KrylovArgs {
  const void* a[7];  // diag, east, west, north, south, top, bottom
  const void *m_upper, *cp, *rden, *x1, *x2, *c2, *rhat;
  void *z, *out, *dp, *partials;
};

template <typename T, bool kCombine, bool kDot>
void launch_krylov_variant(dim3 grid, cudaStream_t stream, const KrylovArgs& p, int nz, int ny,
                           int nx, int tripolar) {
  auto c = [](const void* q) { return static_cast<const T*>(q); };
  krylov_kernel<T, kCombine, kDot><<<grid, dim3(kBX, kBY), 0, stream>>>(
      c(p.a[0]), c(p.a[1]), c(p.a[2]), c(p.a[3]), c(p.a[4]), c(p.a[5]), c(p.a[6]),
      c(p.m_upper), c(p.cp), c(p.rden), c(p.x1), c(p.x2), c(p.c2), c(p.rhat),
      static_cast<T*>(p.z), static_cast<T*>(p.out), static_cast<T*>(p.dp),
      static_cast<double*>(p.partials), nz, ny, nx, tripolar);
}

template <typename T>
int launch_krylov(const KrylovArgs& p, void* d, int npartials, int nz, int ny, int nx,
                  int tripolar, int combine, int dot, cudaStream_t s) {
  const dim3 grid((nx + kTI - 1) / kTI, (ny + kTJ - 1) / kTJ);
  if (dot && npartials != static_cast<int>(grid.x * grid.y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (combine && dot) {
    launch_krylov_variant<T, true, true>(grid, s, p, nz, ny, nx, tripolar);
  } else if (combine) {
    launch_krylov_variant<T, true, false>(grid, s, p, nz, ny, nx, tripolar);
  } else if (dot) {
    launch_krylov_variant<T, false, true>(grid, s, p, nz, ny, nx, tripolar);
  } else {
    launch_krylov_variant<T, false, false>(grid, s, p, nz, ny, nx, tripolar);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !dot) return static_cast<int>(err);
  krylov_dot_finish<T><<<1, kFinishThreads, 0, s>>>(static_cast<const double*>(p.partials),
                                                     npartials, static_cast<T*>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

#define OTMB_KRYLOV_ENTRIES(SUFFIX, T)                                                          \
  OTMB_EXPORT int otmb_krylov_##SUFFIX(                                                        \
      const void* diag, const void* east, const void* west, const void* north,                 \
      const void* south, const void* top, const void* bottom, const void* m_upper,             \
      const void* cp, const void* rden, const void* x1, const void* x2, const void* c2,        \
      const void* rhat, void* z, void* out, void* dp, void* partials, void* d, int npartials,  \
      int nz, int ny, int nx, int tripolar, int combine, int dot, void* stream) {              \
    const otmb::KrylovArgs p = {{diag, east, west, north, south, top, bottom}, m_upper, cp,    \
                                rden, x1, x2, c2, rhat, z, out, dp, partials};                 \
    return otmb::launch_krylov<T>(p, d, npartials, nz, ny, nx, tripolar, combine, dot,         \
                                  static_cast<cudaStream_t>(stream));                          \
  }

OTMB_KRYLOV_ENTRIES(f32, float)
OTMB_KRYLOV_ENTRIES(f64, double)
