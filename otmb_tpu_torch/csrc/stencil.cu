// K1: the 7-point transport stencil, y = T @ chi, optionally fused with
// the forward Euler update chi - dt * T @ chi; K5, the same for a batch of
// tracers (below K1); and K7, both on one shard of a process grid, with the
// shard's edge neighbours from halo lines (the kHalo instantiations, at the
// end).
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

// K7's halo lines: the neighbours of a shard's edge cells, which lie on
// other shards (or across the periodic wrap or the tripolar fold). Columns
// are (nz, ny) and rows (nz, nx), per member of a batch; a member's lines
// follow the previous member's. `east[k, j]` is the east neighbour of the
// last column's cell (k, j), `north[k, i]` the north neighbour of the last
// row's cell (k, i). A null line reads as zeros: a neighbour that does not
// exist (past the south edge, past a bipolar north edge), or the halos of
// the overlapped step's bulk launch, which the edge entry patches later.
template <typename V>
struct Halo {
  const V* east;
  const V* west;
  const V* north;
  const V* south;
};

template <typename C, typename V, bool kHalo>
__global__ void stencil_kernel(const C* __restrict__ diag, const C* __restrict__ east,
                               const C* __restrict__ west, const C* __restrict__ north,
                               const C* __restrict__ south, const C* __restrict__ top,
                               const C* __restrict__ bottom, const V* __restrict__ chi,
                               V* __restrict__ out, int nz, int ny, int nx, int tripolar,
                               int euler, V dt, Halo<V> h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (i >= nx) return;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long row = k * plane + static_cast<long long>(j) * nx;
  const long long c = row + i;

  const V x = chi[c];
  V xe, xw, xn, xs;
  if constexpr (kHalo) {
    // K7: an open box; what lies beyond its edges comes from the lines
    const long long hcol = static_cast<long long>(k) * ny + j;
    const long long hrow = static_cast<long long>(k) * nx + i;
    xe = i + 1 < nx ? chi[c + 1] : h.east ? h.east[hcol] : V(0);
    xw = i > 0 ? chi[c - 1] : h.west ? h.west[hcol] : V(0);
    xn = j + 1 < ny ? chi[c + nx] : h.north ? h.north[hrow] : V(0);
    xs = j > 0 ? chi[c - nx] : h.south ? h.south[hrow] : V(0);
  } else {
    xe = chi[row + (i + 1 == nx ? 0 : i + 1)];
    xw = chi[row + (i == 0 ? nx - 1 : i - 1)];
    xn = V(0);
    if (j + 1 < ny) {
      xn = chi[c + nx];
    } else if (tripolar) {
      xn = chi[row + (nx - 1 - i)];
    }
    xs = j > 0 ? chi[c - nx] : V(0);
  }
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

template <typename C, typename V, bool kHalo>
int launch_stencil(const void* diag, const void* east, const void* west, const void* north,
                   const void* south, const void* top, const void* bottom, const void* chi,
                   void* out, int nz, int ny, int nx, int tripolar, int euler, double dt,
                   Halo<V> h, void* stream) {
  const dim3 block(kBlock);
  const dim3 grid((nx + kBlock - 1) / kBlock, ny, nz);
  stencil_kernel<C, V, kHalo><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(diag), static_cast<const C*>(east), static_cast<const C*>(west),
      static_cast<const C*>(north), static_cast<const C*>(south), static_cast<const C*>(top),
      static_cast<const C*>(bottom), static_cast<const V*>(chi), static_cast<V*>(out), nz, ny,
      nx, tripolar, euler, static_cast<V>(dt), h);
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
template <typename C, typename V, bool kHalo>
__global__ void stencil_multi_kernel(const C* __restrict__ diag, const C* __restrict__ east,
                                     const C* __restrict__ west, const C* __restrict__ north,
                                     const C* __restrict__ south, const C* __restrict__ top,
                                     const C* __restrict__ bottom, const V* __restrict__ chi,
                                     V* __restrict__ out, int nmembers, int nz, int ny, int nx,
                                     int tripolar, int euler, V dt, Halo<V> h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (i >= nx) return;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long member = plane * nz;
  const long long row = k * plane + static_cast<long long>(j) * nx;
  const long long c = row + i;
  // K7 (kHalo): an open box whose edge neighbours come from the lines
  const bool in_e = !kHalo || i + 1 < nx;
  const bool in_w = !kHalo || i > 0;
  const bool in_n = !kHalo || j + 1 < ny;
  const bool in_s = !kHalo || j > 0;
  const long long hcol = static_cast<long long>(k) * ny + j;
  const long long hrow = static_cast<long long>(k) * nx + i;
  const long long col_member = static_cast<long long>(nz) * ny;
  const long long row_member = static_cast<long long>(nz) * nx;
  const long long ce = kHalo ? c + 1 : row + (i + 1 == nx ? 0 : i + 1);
  const long long cw = kHalo ? c - 1 : row + (i == 0 ? nx - 1 : i - 1);
  const bool has_n = kHalo || j + 1 < ny || tripolar;
  const long long cn = j + 1 < ny ? c + nx : row + (nx - 1 - i);
  const bool has_s = kHalo || j > 0;
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
    const V xe = in_e ? x[ce] : h.east ? h.east[m * col_member + hcol] : V(0);
    const V xw = in_w ? x[cw] : h.west ? h.west[m * col_member + hcol] : V(0);
    const V xn = !has_n ? V(0) : in_n ? x[cn] : h.north ? h.north[m * row_member + hrow] : V(0);
    const V xs = !has_s ? V(0) : in_s ? x[c - nx] : h.south ? h.south[m * row_member + hrow] : V(0);
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

template <typename C, typename V, bool kHalo>
int launch_stencil_multi(const void* diag, const void* east, const void* west, const void* north,
                         const void* south, const void* top, const void* bottom, const void* chi,
                         void* out, int nmembers, int nz, int ny, int nx, int tripolar, int euler,
                         double dt, Halo<V> h, void* stream) {
  const dim3 block(kBlock);
  const dim3 grid((nx + kBlock - 1) / kBlock, ny, nz);
  stencil_multi_kernel<C, V, kHalo><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(diag), static_cast<const C*>(east), static_cast<const C*>(west),
      static_cast<const C*>(north), static_cast<const C*>(south), static_cast<const C*>(top),
      static_cast<const C*>(bottom), static_cast<const V*>(chi), static_cast<V*>(out), nmembers,
      nz, ny, nx, tripolar, euler, static_cast<V>(dt), h);
  return static_cast<int>(cudaGetLastError());
}

// K7: K1 (nmembers == 0) or K5 (nmembers >= 1) on one shard of a process
// grid, with the shard's edge neighbours in the halo lines.
//
// Replaces the Pallas kernels of otmb_tpu/parallel/halo_pallas.py
// (_stencil_kernel_local, _stencil_kernel_local_multi). Inside the shard
// nothing is periodic and there is no fold: both live in the lines, which
// parallel/halo.py exchanges. Bound and design are K1's and K5's; the lines
// add 4 * (ny + nx) values per level and member. Every read of a value that
// K1 or K5 would read at the same cell of the whole field returns that value,
// and the sum runs in their order, so on each shard K7 equals K1 (K5 per
// member) on the whole field bit for bit. On a 150x180x50 shard the bulk
// kernel runs at 82 % of its byte bound (PERF.md); what a sharded step lost
// was its launch path, about twenty eager launches and a copy per line
// around it, which the pack and edge entries below replace. A null line
// reads as zeros, so the overlapped step's bulk needs no zero lines.
template <typename C, typename V>
int launch_stencil_halo(const void* diag, const void* east, const void* west, const void* north,
                        const void* south, const void* top, const void* bottom, const void* chi,
                        void* out, const void* h_east, const void* h_west, const void* h_north,
                        const void* h_south, int nmembers, int nz, int ny, int nx, int euler,
                        double dt, void* stream) {
  const Halo<V> h{static_cast<const V*>(h_east), static_cast<const V*>(h_west),
                  static_cast<const V*>(h_north), static_cast<const V*>(h_south)};
  if (nmembers == 0) {
    return launch_stencil<C, V, true>(diag, east, west, north, south, top, bottom, chi, out, nz,
                                      ny, nx, 0, euler, dt, h, stream);
  }
  return launch_stencil_multi<C, V, true>(diag, east, west, north, south, top, bottom, chi, out,
                                          nmembers, nz, ny, nx, 0, euler, dt, h, stream);
}

// K7's halo path: the pack and edge entries around the bulk launch.
//
// A shard's overlapped step (parallel/halo_kernel.py:_step) is three
// launches: the pack writes every line the shard sends into one contiguous
// send buffer, the bulk K7 runs on null halos, and when the lines have
// landed in one receive buffer the edge entry adds the halo terms at the
// shard's edge cells. On the TPU the JAX package's exchange (ppermute) and
// its in-kernel halo reads needed no such entries; here they replace about
// twenty eager launches, one device-to-host copy per line and one
// host-to-device copy per line with one launch and one copy each way.
// Both move a few hundred kilobytes: the host's launch floor, not bytes,
// bounds them.
//
// The send buffer holds, for nmembers members (one tracer: 1), the west
// and east columns (nmembers, nz, ny) each, the south and north rows
// (nmembers, nz, nx) each and, with `fold`, the north row i-reversed for
// the tripolar fold, in that order: each line is a contiguous slice that a
// message sends as it is.
template <typename V>
__global__ void halo_pack_kernel(const V* __restrict__ chi, V* __restrict__ send,
                                 long long col_line, long long row_line, int ny, int nx,
                                 long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long plane = static_cast<long long>(ny) * nx;
  long long src;
  if (t < 2 * col_line) {
    const bool east = t >= col_line;
    const long long u = east ? t - col_line : t;  // (member * nz + k) * ny + j
    const long long mk = u / ny;
    const long long j = u - mk * ny;
    src = mk * plane + j * nx + (east ? nx - 1 : 0);
  } else {
    const long long v = t - 2 * col_line;
    const long long seg = v / row_line;  // 0 south, 1 north, 2 fold
    const long long u = v - seg * row_line;  // (member * nz + k) * nx + i
    const long long mk = u / nx;
    const long long i = u - mk * nx;
    src = mk * plane + (seg == 0 ? 0 : static_cast<long long>(ny - 1) * nx) +
          (seg == 2 ? nx - 1 - i : i);
  }
  send[t] = chi[src];
}

template <typename V>
int launch_halo_pack(const void* chi, void* send, int nmembers, int nz, int ny, int nx, int fold,
                     void* stream) {
  const long long col_line = static_cast<long long>(nmembers) * nz * ny;
  const long long row_line = static_cast<long long>(nmembers) * nz * nx;
  const long long total = 2 * col_line + (2 + (fold ? 1 : 0)) * row_line;
  halo_pack_kernel<V><<<blocks_for(total), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(chi), static_cast<V*>(send), col_line, row_line, ny, nx, total);
  return static_cast<int>(cudaGetLastError());
}

// The edge entry: out += (scale * leg) * halo at the shard's edge cells, in
// place, for the east, west, north and south legs in that order, so a
// corner cell receives its two terms in the order of the plain version
// (parallel/halo.py:_boundary_patch, which adds whole columns and rows one
// after another); scale is 1 for an apply and -dt for an Euler step. One
// thread per edge cell and member, so no two threads touch one cell. A
// null line adds nothing. The arithmetic is the plain version's, in V.
template <typename C, typename V>
__global__ void halo_edge_kernel(const C* __restrict__ east, const C* __restrict__ west,
                                 const C* __restrict__ north, const C* __restrict__ south,
                                 V* __restrict__ out, Halo<V> h, int nz, int ny, int nx,
                                 long long per_level, long long total, V scale) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long mk = t / per_level;  // member * nz + k
  long long p = t - mk * per_level;
  // the perimeter of one level, each cell once: the south row, the north
  // row (when ny > 1), then the inner cells of the west and east columns
  const int rows = ny > 1 ? 2 : 1;
  int i, j;
  if (p < static_cast<long long>(rows) * nx) {
    j = p < nx ? 0 : ny - 1;
    i = static_cast<int>(p < nx ? p : p - nx);
  } else {
    p -= static_cast<long long>(rows) * nx;
    const int inner = ny - 2;
    const int side = static_cast<int>(p / inner);  // 0 west, 1 east
    j = 1 + static_cast<int>(p - static_cast<long long>(side) * inner);
    i = side == 0 ? 0 : nx - 1;
  }
  const long long plane = static_cast<long long>(ny) * nx;
  const long long k = mk % nz;
  const long long c = k * plane + static_cast<long long>(j) * nx + i;
  const long long o = (mk - k) * plane + c;
  const long long hcol = mk * ny + j;
  const long long hrow = mk * nx + i;
  V acc = out[o];
  if (i == nx - 1 && h.east) acc = acc + (scale * static_cast<V>(widen(east[c]))) * h.east[hcol];
  if (i == 0 && h.west) acc = acc + (scale * static_cast<V>(widen(west[c]))) * h.west[hcol];
  if (j == ny - 1 && h.north) {
    acc = acc + (scale * static_cast<V>(widen(north[c]))) * h.north[hrow];
  }
  if (j == 0 && h.south) acc = acc + (scale * static_cast<V>(widen(south[c]))) * h.south[hrow];
  out[o] = acc;
}

template <typename C, typename V>
int launch_halo_edge(const void* east, const void* west, const void* north, const void* south,
                     void* out, const void* h_east, const void* h_west, const void* h_north,
                     const void* h_south, int nmembers, int nz, int ny, int nx, double scale,
                     void* stream) {
  const Halo<V> h{static_cast<const V*>(h_east), static_cast<const V*>(h_west),
                  static_cast<const V*>(h_north), static_cast<const V*>(h_south)};
  const long long per_level = static_cast<long long>(ny > 1 ? 2 : 1) * nx +
                              static_cast<long long>(nx > 1 ? 2 : 1) * (ny > 2 ? ny - 2 : 0);
  const long long total = static_cast<long long>(nmembers) * nz * per_level;
  halo_edge_kernel<C, V><<<blocks_for(total), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(east), static_cast<const C*>(west), static_cast<const C*>(north),
      static_cast<const C*>(south), static_cast<V*>(out), h, nz, ny, nx, per_level, total,
      static_cast<V>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

#define OTMB_HALO_PACK_ENTRY(NAME, V)                                                        \
  OTMB_EXPORT int NAME(const void* chi, void* send, int nmembers, int nz, int ny, int nx,    \
                       int fold, void* stream) {                                             \
    return otmb::launch_halo_pack<V>(chi, send, nmembers, nz, ny, nx, fold, stream);         \
  }

OTMB_HALO_PACK_ENTRY(otmb_halo_pack_f32, float)
OTMB_HALO_PACK_ENTRY(otmb_halo_pack_f64, double)

#define OTMB_HALO_EDGE_ENTRY(NAME, C, V)                                                     \
  OTMB_EXPORT int NAME(const void* east, const void* west, const void* north,                \
                       const void* south, void* out, const void* h_east, const void* h_west, \
                       const void* h_north, const void* h_south, int nmembers, int nz,       \
                       int ny, int nx, double scale, void* stream) {                         \
    return otmb::launch_halo_edge<C, V>(east, west, north, south, out, h_east, h_west,       \
                                        h_north, h_south, nmembers, nz, ny, nx, scale,       \
                                        stream);                                             \
  }

OTMB_HALO_EDGE_ENTRY(otmb_halo_edge_f32_f32, float, float)
OTMB_HALO_EDGE_ENTRY(otmb_halo_edge_bf16_f32, __nv_bfloat16, float)
OTMB_HALO_EDGE_ENTRY(otmb_halo_edge_f32_f64, float, double)
OTMB_HALO_EDGE_ENTRY(otmb_halo_edge_f64_f64, double, double)

#define OTMB_STENCIL_MULTI_ENTRY(NAME, C, V)                                                  \
  OTMB_EXPORT int NAME(const void* diag, const void* east, const void* west,                 \
                       const void* north, const void* south, const void* top,                \
                       const void* bottom, const void* chi, void* out, int nmembers, int nz, \
                       int ny, int nx, int tripolar, int euler, double dt, void* stream) {   \
    return otmb::launch_stencil_multi<C, V, false>(diag, east, west, north, south, top,      \
                                                   bottom, chi, out, nmembers, nz, ny, nx,   \
                                                   tripolar, euler, dt, {}, stream);         \
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
    return otmb::launch_stencil<C, V, false>(diag, east, west, north, south, top, bottom,    \
                                             chi, out, nz, ny, nx, tripolar, euler, dt, {},  \
                                             stream);                                        \
  }

OTMB_STENCIL_ENTRY(otmb_stencil_f32_f32, float, float)
OTMB_STENCIL_ENTRY(otmb_stencil_bf16_f32, __nv_bfloat16, float)
OTMB_STENCIL_ENTRY(otmb_stencil_f32_f64, float, double)
OTMB_STENCIL_ENTRY(otmb_stencil_f64_f64, double, double)

#define OTMB_STENCIL_HALO_ENTRY(NAME, C, V)                                                  \
  OTMB_EXPORT int NAME(const void* diag, const void* east, const void* west,                 \
                       const void* north, const void* south, const void* top,                \
                       const void* bottom, const void* chi, void* out, const void* h_east,   \
                       const void* h_west, const void* h_north, const void* h_south,         \
                       int nmembers, int nz, int ny, int nx, int euler, double dt,           \
                       void* stream) {                                                       \
    return otmb::launch_stencil_halo<C, V>(diag, east, west, north, south, top, bottom, chi, \
                                           out, h_east, h_west, h_north, h_south, nmembers,  \
                                           nz, ny, nx, euler, dt, stream);                   \
  }

OTMB_STENCIL_HALO_ENTRY(otmb_stencil_halo_f32_f32, float, float)
OTMB_STENCIL_HALO_ENTRY(otmb_stencil_halo_bf16_f32, __nv_bfloat16, float)
OTMB_STENCIL_HALO_ENTRY(otmb_stencil_halo_f32_f64, float, double)
OTMB_STENCIL_HALO_ENTRY(otmb_stencil_halo_f64_f64, double, double)

OTMB_EXPORT const char* otmb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library links its own CUDA runtime, whose current device is separate
// from PyTorch's: a wrapper selects its tensors' device when it differs
// from the last one selected on its thread (_build.py:launch).
OTMB_EXPORT int otmb_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
