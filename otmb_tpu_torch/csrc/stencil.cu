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
#include <type_traits>

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

// K5: K1 for a batch of B tracers (B, nz, ny, nx) that share one operator;
// with kHalo, K7 multi: the same on one shard, its edge neighbours from the
// halo lines.
//
// Replaces the Pallas kernels of otmb_tpu/ops/stencil_pallas.py
// (_stencil_kernel_multi, _stencil_kernel_blocked_multi and the batched
// propagation loop) and otmb_tpu/parallel/halo_pallas.py
// (_stencil_kernel_local_multi): one kernel here, where the TPU needed two
// VMEM fits, a scan of the single-tracer kernel and a shard kernel.
//
// Bound on the H100: device-memory bandwidth. Per cell it must read the 7
// coefficients once and each member's chi once and write each member's y:
// 7 + 2B streams instead of the 9B of B launches of K1. A thread per cell
// looping over the members (the design before this one) read each level of
// chi again as the top and bottom neighbour after 7 + 2B planes had passed
// through the 50 MB L2, which at 0.25 degrees (6.2 MB a plane) they no
// longer fit: 39 streams at B = 8, 46 % of the byte bound.
//
// Design: k-marching tiles, as K6 (redi.cu). A block of 256 threads owns
// kMJ x kMI = 8 x 32 columns of a group of G members (G = 1, 2, 4 or 8 at
// compile time; the last group may hold fewer) and walks its levels down.
// Three level buffers of the tile and its one-cell ring per member live in
// shared memory: while level k is computed from levels k and k + 1, level
// k + 2 is staged by cp.async into level k - 1's buffer, every member's
// copies issued together. The horizontal and bottom neighbours come from
// shared memory and the top one is the centre carried in a register from
// the step above, so each member's chi leaves device memory once; the ring
// is read again by the neighbouring tiles, from L2. A thread loads its
// column's 7 legs once a step for all members, one step ahead, and widens
// them where they are used so the loads stay in flight. Where the tiles are
// few or leave a short last wave (1 degree, a shard), the walk is split
// into chunks of levels (pick_chunks), each starting with one direct read
// of the centre above it. Offsets are 64-bit: B*nz*ny*nx passes 2^31 at
// 0.25 degrees from B = 19.
//
// Measured (device time, f32, B = 8, on an H100 80GB HBM3 at 700 W;
// scripts/ab_redesign.py and scripts/k5_probe.py, PERF.md): 4.20-4.31 ms
// at 0.25 degrees (74-76 % of the 3.20 ms byte bound; the thread per cell
// took 6.63-6.93 ms) and 0.194-0.198 ms at 1 degree (75-76 % of 0.148 ms;
// 0.234-0.239 ms). At 1 degree a cap of three blocks an SM (80 registers,
// spilling) took 0.208 ms, tiles of 64 x 4 0.206 ms and of 128 x 2 0.225 ms.
//
template <typename V>
struct Src {  // a staged position: member 0's value at level 0 (null: 0)
  const V* p;
  long long level, member;  // strides to the next level and member
};

template <typename V, bool kHalo>
__device__ Src<V> locate_multi(const V* chi, const Halo<V>& h, int gj, int gi, int nz, int ny,
                               int nx, int tripolar) {
  const long long plane = static_cast<long long>(ny) * nx;
  const long long member = plane * nz, col_member = static_cast<long long>(nz) * ny;
  const long long row_member = static_cast<long long>(nz) * nx;
  const bool in_i = gi >= 0 && gi < nx, in_j = gj >= 0 && gj < ny;
  if constexpr (kHalo) {
    if (in_i && in_j) return {chi + static_cast<long long>(gj) * nx + gi, plane, member};
    if (in_j && gi == nx && h.east) return {h.east + gj, ny, col_member};
    if (in_j && gi == -1 && h.west) return {h.west + gj, ny, col_member};
    if (in_i && gj == ny && h.north) return {h.north + gi, nx, row_member};
    if (in_i && gj == -1 && h.south) return {h.south + gi, nx, row_member};
  } else {
    const int i = gi < 0 ? gi + nx : gi % nx;
    if (in_j) return {chi + static_cast<long long>(gj) * nx + i, plane, member};
    if (gj == ny && tripolar) {
      return {chi + static_cast<long long>(ny - 1) * nx + (nx - 1 - i), plane, member};
    }
  }
  return {nullptr, 0, 0};
}

constexpr int kMI = 32, kMJ = 8;  // owned columns along i and j
constexpr int kMPI = kMI + 2;     // positions along i, with the ring
constexpr int kMPos = kMPI * (kMJ + 2), kMThreads = kMI * kMJ;
constexpr int kMPosPerThread = (kMPos + kMThreads - 1) / kMThreads;
constexpr int kLevels = 3;        // level buffers per member

template <typename C>
struct Legs {  // one column's coefficients at one level, as stored
  C d, e, w, n, s, t, b;
};

template <typename C, typename V, bool kHalo, int G>
__global__ void __launch_bounds__(kMThreads)
stencil_multi_kernel(const C* __restrict__ diag, const C* __restrict__ east,
                     const C* __restrict__ west, const C* __restrict__ north,
                     const C* __restrict__ south, const C* __restrict__ top,
                     const C* __restrict__ bottom, const V* __restrict__ chi,
                     V* __restrict__ out, int nmembers, int nz, int ny, int nx, int tripolar,
                     int euler, V dt, Halo<V> h, int nchunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* const xs = reinterpret_cast<V*>(smem_raw);  // [kLevels][G][kMPos]
  const int t = threadIdx.x, tx = t % kMI, ty = t / kMI;
  const int i0 = blockIdx.x * kMI, j0 = blockIdx.y * kMJ, m0 = blockIdx.z / nchunks * G;
  const int nm = nmembers - m0 < G ? nmembers - m0 : G;
  const int span = (nz + nchunks - 1) / nchunks, k_lo = blockIdx.z % nchunks * span;
  const int k_hi = k_lo + span < nz ? k_lo + span : nz;
  if (k_lo >= nz) return;
  const long long plane = static_cast<long long>(ny) * nx, member = plane * nz;

  // this thread's staging positions; those with no source read 0 at every
  // level, so their slots are zeroed once, by the thread that owns them
  int pos[kMPosPerThread];
  Src<V> src[kMPosPerThread];
#pragma unroll
  for (int q = 0; q < kMPosPerThread; ++q) {
    pos[q] = t + q * kMThreads < kMPos ? t + q * kMThreads : -1;
    src[q] = pos[q] < 0 ? Src<V>{nullptr, 0, 0}
                        : locate_multi<V, kHalo>(chi, h, j0 - 1 + pos[q] / kMPI,
                                                 i0 - 1 + pos[q] % kMPI, nz, ny, nx, tripolar);
    if (pos[q] >= 0 && src[q].p == nullptr) {
      for (int b = 0; b < kLevels * G; ++b) xs[b * kMPos + pos[q]] = V(0);
    }
  }
  auto stage = [&](int k) {  // level k of the group's members, if the walk reads it
    if (k <= k_hi && k < nz) {
      V* const dst = xs + (k % kLevels) * G * kMPos;
#pragma unroll
      for (int q = 0; q < kMPosPerThread; ++q) {
        if (src[q].p == nullptr) continue;
        const V* const s = src[q].p + k * src[q].level + m0 * src[q].member;
#pragma unroll
        for (int m = 0; m < G; ++m) {
          if (m < nm) cp_async(dst + m * kMPos + pos[q], s + m * src[q].member);
        }
      }
    }
    cp_async_commit();
  };

  const int i = i0 + tx, j = j0 + ty, pc = (ty + 1) * kMPI + tx + 1;
  const bool live = i < nx && j < ny;
  const long long col = static_cast<long long>(j) * nx + i;
  auto legs_at = [&](int k) {  // widened at their use, so the loads stay in flight
    Legs<C> l{};
    if (live && k < k_hi) {
      const long long c = k * plane + col;
      l = {diag[c], east[c], west[c], north[c], south[c], top[c], bottom[c]};
    }
    return l;
  };
  auto wide = [](C a) { return static_cast<V>(widen(a)); };
  const V* const x0 = chi + m0 * member + col;
  V* const y0 = out + m0 * member + col;
  V xt[G];  // each member's centre one level up: 0 above the surface
#pragma unroll
  for (int m = 0; m < G; ++m) {
    xt[m] = live && k_lo > 0 && m < nm ? x0[m * member + (k_lo - 1) * plane] : V(0);
  }
  stage(k_lo);
  stage(k_lo + 1);
  Legs<C> next = legs_at(k_lo);
  for (int k = k_lo; k < k_hi; ++k) {
    const Legs<C> l = next;
    next = legs_at(k + 1);  // in flight across this step
    cp_async_wait<0>();     // levels k and k + 1, this thread's copies
    __syncthreads();        // everyone's; level k - 1's buffer is read no more
    stage(k + 2);           // into level k - 1's buffer
    const V* const xk = xs + (k % kLevels) * G * kMPos;
    const V* const xb1 = xs + ((k + 1) % kLevels) * G * kMPos;
    const bool has_b = k + 1 < nz;
    const V cd = wide(l.d), ce = wide(l.e), cw = wide(l.w), cn = wide(l.n), cs = wide(l.s);
    const V ct = wide(l.t), cb = wide(l.b);
#pragma unroll
    for (int m = 0; m < G; ++m) {
      if (!live || m >= nm) continue;
      const V* const x = xk + m * kMPos;
      const V xc = x[pc];
      const V xb = has_b ? xb1[m * kMPos + pc] : V(0);
      V acc = cd * xc;
      acc = acc + ce * x[pc + 1];
      acc = acc + cw * x[pc - 1];
      acc = acc + cn * x[pc + kMPI];
      acc = acc + cs * x[pc - kMPI];
      acc = acc + ct * xt[m];
      acc = acc + cb * xb;
      y0[m * member + k * plane] = euler ? xc - dt * acc : acc;
      xt[m] = xc;
    }
  }
}

template <typename C, typename V, bool kHalo, int G>
int launch_multi_group(const void* diag, const void* east, const void* west, const void* north,
                       const void* south, const void* top, const void* bottom, const void* chi,
                       void* out, int nmembers, int nz, int ny, int nx, int tripolar, int euler,
                       double dt, Halo<V> h, void* stream) {
  auto kernel = stencil_multi_kernel<C, V, kHalo, G>;
  const size_t bytes = kLevels * G * kMPos * sizeof(V);
  const dim3 grid((nx + kMI - 1) / kMI, (ny + kMJ - 1) / kMJ, (nmembers + G - 1) / G);
  long long slots = 0;
  const cudaError_t err = block_slots(kernel, kMThreads, bytes, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunks = pick_chunks(static_cast<long long>(grid.x) * grid.y * grid.z, slots, nz);
  kernel<<<dim3(grid.x, grid.y, grid.z * nchunks), kMThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(diag), static_cast<const C*>(east), static_cast<const C*>(west),
      static_cast<const C*>(north), static_cast<const C*>(south), static_cast<const C*>(top),
      static_cast<const C*>(bottom), static_cast<const V*>(chi), static_cast<V*>(out), nmembers,
      nz, ny, nx, tripolar, euler, static_cast<V>(dt), h, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// The group size: the whole batch in one group up to 8 members (rounded up
// to a power of two), groups of 8 beyond. One member goes to K1's (K7's)
// kernel where the planes it streams between reading a level as a centre
// and again as a neighbour fit in half the L2: the walk's pipeline fill
// then costs more than the vertical reuse saves (1 degree, f32: 0.0682 ms
// of device time for the walk, 0.0645 for K1's kernel), and where they do
// not, the walk wins (0.25 degrees: 1.416 against 1.643 ms; both on an
// H100 80GB HBM3 at 700 W, scripts/k5_probe.py).
template <typename C, typename V, bool kHalo>
int launch_stencil_multi(const void* diag, const void* east, const void* west, const void* north,
                         const void* south, const void* top, const void* bottom, const void* chi,
                         void* out, int nmembers, int nz, int ny, int nx, int tripolar, int euler,
                         double dt, Halo<V> h, void* stream) {
  if (nmembers == 1) {
    int device = 0, l2 = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long reuse = static_cast<long long>(ny) * nx * (7 * sizeof(C) + 2 * sizeof(V));
    if (2 * reuse <= l2) {
      return launch_stencil<C, V, kHalo>(diag, east, west, north, south, top, bottom, chi, out,
                                         nz, ny, nx, tripolar, euler, dt, h, stream);
    }
  }
  auto go = [&](auto group) {
    return launch_multi_group<C, V, kHalo, decltype(group)::value>(
        diag, east, west, north, south, top, bottom, chi, out, nmembers, nz, ny, nx, tripolar,
        euler, dt, h, stream);
  };
  if (nmembers > 4) return go(std::integral_constant<int, 8>{});
  if (nmembers > 2) return go(std::integral_constant<int, 4>{});
  if (nmembers > 1) return go(std::integral_constant<int, 2>{});
  return go(std::integral_constant<int, 1>{});
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
// member) on the whole field bit for bit. On a 150x180x50 shard (PERF.md)
// the single-tracer kernel takes 0.018 ms of device time against its
// 0.0145 ms byte bound, and the batched one at B = 8 0.052 ms against
// 0.037 ms (the thread per cell looping over members: 0.075 ms), its walk
// split into chunks of levels to fill the SMs. What a sharded step lost was
// its launch path, about twenty eager launches and a copy per line around
// the kernel, which the pack and edge entries below replace. A null line
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
