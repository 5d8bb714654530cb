// K1: the 7-point transport stencil, y = T @ chi, optionally fused with
// the forward Euler update chi - dt * T @ chi; and K5, the same for a batch
// of tracers (below K1).
//
// Replaces the Pallas kernels of otmb_tpu/ops/stencil_pallas.py
// (_stencil_kernel, _stencil_kernel_carry, _stencil_kernel_blocked): one
// kernel here, where the TPU needed three VMEM fits.
//
// Bound on the H100: device-memory bandwidth. Per cell it reads 7
// coefficients and chi and writes y: 9 streams, 36 bytes in f32 (22 with
// bf16 coefficients), against 15 flops. Design: one thread per cell with
// i fastest, so a warp reads 32 consecutive cells of every stream; the six
// neighbour reads of chi come from lines that the neighbouring threads,
// rows and levels read too, and hit L1/L2 instead of device memory.
//
// Semantics are those of ops/apply.py:apply_stencil, the plain version:
// i periodic; a missing neighbour (j-1 at the south edge, j+1 at a
// bipolar north edge, k-1 at the surface, k+1 at the floor) reads 0 and
// nothing outside the field is read; the tripolar north neighbour of
// (k, ny-1, i) is (k, ny-1, nx-1-i), read directly. The sum runs in the
// order of the plain version (diag, east, west, north, south, top,
// bottom) in the value type V, and the library is built without FMA
// contraction, so the kernel rounds where the plain version does.
#include "common.cuh"

namespace otmb {

template <typename C, typename V>
__global__ void stencil_kernel(const C* __restrict__ diag, const C* __restrict__ east,
                               const C* __restrict__ west, const C* __restrict__ north,
                               const C* __restrict__ south, const C* __restrict__ top,
                               const C* __restrict__ bottom, const V* __restrict__ chi,
                               V* __restrict__ out, int nz, int ny, int nx, int tripolar,
                               int euler, V dt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (i >= nx) return;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long row = k * plane + static_cast<long long>(j) * nx;
  const long long c = row + i;

  const V x = chi[c];
  const V xe = chi[row + (i + 1 == nx ? 0 : i + 1)];
  const V xw = chi[row + (i == 0 ? nx - 1 : i - 1)];
  V xn = V(0);
  if (j + 1 < ny) {
    xn = chi[c + nx];
  } else if (tripolar) {
    xn = chi[row + (nx - 1 - i)];
  }
  const V xs = j > 0 ? chi[c - nx] : V(0);
  const V xt = k > 0 ? chi[c - plane] : V(0);
  const V xb = k + 1 < nz ? chi[c + plane] : V(0);

  V acc = static_cast<V>(widen(diag[c])) * x;
  acc = acc + static_cast<V>(widen(east[c])) * xe;
  acc = acc + static_cast<V>(widen(west[c])) * xw;
  acc = acc + static_cast<V>(widen(north[c])) * xn;
  acc = acc + static_cast<V>(widen(south[c])) * xs;
  acc = acc + static_cast<V>(widen(top[c])) * xt;
  acc = acc + static_cast<V>(widen(bottom[c])) * xb;
  out[c] = euler ? x - dt * acc : acc;
}

template <typename C, typename V>
int launch_stencil(const void* diag, const void* east, const void* west, const void* north,
                   const void* south, const void* top, const void* bottom, const void* chi,
                   void* out, int nz, int ny, int nx, int tripolar, int euler, double dt,
                   void* stream) {
  const dim3 block(kBlock);
  const dim3 grid((nx + kBlock - 1) / kBlock, ny, nz);
  stencil_kernel<C, V><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(diag), static_cast<const C*>(east), static_cast<const C*>(west),
      static_cast<const C*>(north), static_cast<const C*>(south), static_cast<const C*>(top),
      static_cast<const C*>(bottom), static_cast<const V*>(chi), static_cast<V*>(out), nz, ny,
      nx, tripolar, euler, static_cast<V>(dt));
  return static_cast<int>(cudaGetLastError());
}

// K5: K1 for a batch of B tracers (B, nz, ny, nx) that share one operator.
//
// Replaces the Pallas kernels of otmb_tpu/ops/stencil_pallas.py
// (_stencil_kernel_multi, _stencil_kernel_blocked_multi and the batched
// propagation loop): one kernel here, where the TPU needed two VMEM fits
// and a scan of the single-tracer kernel as a third.
//
// Bound on the H100: device-memory bandwidth. Per cell it reads the 7
// coefficients once and each member's chi and writes each member's y:
// 7 + 2B streams instead of the 9B of B launches of K1. Design: K1's thread
// layout (one thread per (k, j, i), i fastest); the thread holds its 7 legs
// in registers and loops over the B members at a stride of nz*ny*nx, with
// K1's neighbour reads for each member. Offsets are 64-bit: B*nz*ny*nx
// passes 2^31 at 0.25 degrees from B = 19.
//
// Semantics and rounding are K1's (above): the same reads, the same sum
// order in V, no FMA contraction, so member b of the result equals K1
// applied to member b, bit for bit.
template <typename C, typename V>
__global__ void stencil_multi_kernel(const C* __restrict__ diag, const C* __restrict__ east,
                                     const C* __restrict__ west, const C* __restrict__ north,
                                     const C* __restrict__ south, const C* __restrict__ top,
                                     const C* __restrict__ bottom, const V* __restrict__ chi,
                                     V* __restrict__ out, int nmembers, int nz, int ny, int nx,
                                     int tripolar, int euler, V dt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (i >= nx) return;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long member = plane * nz;
  const long long row = k * plane + static_cast<long long>(j) * nx;
  const long long c = row + i;
  const long long ce = row + (i + 1 == nx ? 0 : i + 1);
  const long long cw = row + (i == 0 ? nx - 1 : i - 1);
  const bool has_n = j + 1 < ny || tripolar;
  const long long cn = j + 1 < ny ? c + nx : row + (nx - 1 - i);
  const bool has_s = j > 0;
  const bool has_t = k > 0;
  const bool has_b = k + 1 < nz;

  const V cd = static_cast<V>(widen(diag[c]));
  const V ceast = static_cast<V>(widen(east[c]));
  const V cwest = static_cast<V>(widen(west[c]));
  const V cnorth = static_cast<V>(widen(north[c]));
  const V csouth = static_cast<V>(widen(south[c]));
  const V ctop = static_cast<V>(widen(top[c]));
  const V cbottom = static_cast<V>(widen(bottom[c]));

  for (int m = 0; m < nmembers; ++m) {
    const V* __restrict__ x = chi + m * member;
    const V xc = x[c];
    const V xe = x[ce];
    const V xw = x[cw];
    const V xn = has_n ? x[cn] : V(0);
    const V xs = has_s ? x[c - nx] : V(0);
    const V xt = has_t ? x[c - plane] : V(0);
    const V xb = has_b ? x[c + plane] : V(0);

    V acc = cd * xc;
    acc = acc + ceast * xe;
    acc = acc + cwest * xw;
    acc = acc + cnorth * xn;
    acc = acc + csouth * xs;
    acc = acc + ctop * xt;
    acc = acc + cbottom * xb;
    out[m * member + c] = euler ? xc - dt * acc : acc;
  }
}

template <typename C, typename V>
int launch_stencil_multi(const void* diag, const void* east, const void* west, const void* north,
                         const void* south, const void* top, const void* bottom, const void* chi,
                         void* out, int nmembers, int nz, int ny, int nx, int tripolar, int euler,
                         double dt, void* stream) {
  const dim3 block(kBlock);
  const dim3 grid((nx + kBlock - 1) / kBlock, ny, nz);
  stencil_multi_kernel<C, V><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(diag), static_cast<const C*>(east), static_cast<const C*>(west),
      static_cast<const C*>(north), static_cast<const C*>(south), static_cast<const C*>(top),
      static_cast<const C*>(bottom), static_cast<const V*>(chi), static_cast<V*>(out), nmembers,
      nz, ny, nx, tripolar, euler, static_cast<V>(dt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

#define OTMB_STENCIL_MULTI_ENTRY(NAME, C, V)                                                  \
  OTMB_EXPORT int NAME(const void* diag, const void* east, const void* west,                 \
                       const void* north, const void* south, const void* top,                \
                       const void* bottom, const void* chi, void* out, int nmembers, int nz, \
                       int ny, int nx, int tripolar, int euler, double dt, void* stream) {   \
    return otmb::launch_stencil_multi<C, V>(diag, east, west, north, south, top, bottom, chi, \
                                            out, nmembers, nz, ny, nx, tripolar, euler, dt,  \
                                            stream);                                         \
  }

OTMB_STENCIL_MULTI_ENTRY(otmb_stencil_multi_f32_f32, float, float)
OTMB_STENCIL_MULTI_ENTRY(otmb_stencil_multi_bf16_f32, __nv_bfloat16, float)
OTMB_STENCIL_MULTI_ENTRY(otmb_stencil_multi_f32_f64, float, double)
OTMB_STENCIL_MULTI_ENTRY(otmb_stencil_multi_f64_f64, double, double)

#define OTMB_STENCIL_ENTRY(NAME, C, V)                                                       \
  OTMB_EXPORT int NAME(const void* diag, const void* east, const void* west,                 \
                       const void* north, const void* south, const void* top,                \
                       const void* bottom, const void* chi, void* out, int nz, int ny,       \
                       int nx, int tripolar, int euler, double dt, void* stream) {           \
    return otmb::launch_stencil<C, V>(diag, east, west, north, south, top, bottom, chi, out, \
                                      nz, ny, nx, tripolar, euler, dt, stream);              \
  }

OTMB_STENCIL_ENTRY(otmb_stencil_f32_f32, float, float)
OTMB_STENCIL_ENTRY(otmb_stencil_bf16_f32, __nv_bfloat16, float)
OTMB_STENCIL_ENTRY(otmb_stencil_f32_f64, float, double)
OTMB_STENCIL_ENTRY(otmb_stencil_f64_f64, double, double)

OTMB_EXPORT const char* otmb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library links its own CUDA runtime, whose current device is separate
// from PyTorch's: the wrappers select the input tensors' device before
// every launch.
OTMB_EXPORT int otmb_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
