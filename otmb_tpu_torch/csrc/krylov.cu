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
// K2 and K1 kernels computes, in one launch that keeps M(z) and the Thomas
// solve's dp out of device memory. M's factor (cp, rden = 1/denom) depends
// on the legs only: K2's factor kernel forms it once per solve, and every
// half-step reads it.
//
// Bound on the H100: device-memory bandwidth. The engine's M is built from
// A's own legs: M's lower and upper are A's bottom and top, and M's
// diagonal is A's guarded (0 -> 1). So the compulsory traffic of a call is
// A's 7 legs, x1, x2 and rhat read once and z and out written once: 12
// streams with combine and dot, 11 with combine only, 10 with dot only, 9
// with neither, against ~30 flops a cell. This kernel moves 15 with
// combine and dot: it reads the factor (cp, rden), and A's top a second
// time as M's upper.
//
// Design: a j-march with two warp roles. A thread block takes `own`
// columns along i (kOwn, or kOwnNarrow where a block's shared memory would
// not fit) and a strip of `rows` rows along j (as many strips as make one
// wave of blocks), and walks the rows j0-1 .. j1 of its strip in turn.
//   * Solver warps, one thread a column: the owned columns and one halo
//     column on each side, so a column is solved once per block (the halo
//     columns, 2 of own + 2, and the two halo rows of a strip are the only
//     repeats). A thread runs its column's Thomas solve on the factor: the
//     forward sweep forms z and dp = (z - upper*dp_prev) * rden, its
//     inputs (x1, x2, cp, rden, upper) loaded into registers a chunk of
//     kChunk levels ahead of their use; dp goes into the row's slot of
//     shared memory and cp beside it; the back substitution overwrites dp
//     with M(z). kSlots rows of M(z) stay in shared memory.
//   * Stencil warps: while the solvers do row q, they apply A to row q-2
//     (rows q-3 and q-1 beside it are complete), one cell a thread at a
//     time, kBatch levels' legs and rhat loaded before the first store,
//     and write out and the dot's terms.
// One __syncthreads a row hands the rows over. What bounds the design is
// the serial column walk: shared memory ((kSlots + 1) values a level a
// column) holds 116-132 columns an SM, so few solver warps walk, and
// nothing hides the latency of a walk's dependent chain. Measured on an H100
// (PERF.md): forming the factor in the walk (two IEEE divisions a level in
// its dependent chain) was slower, and so were a cp.async ring for the
// walk's inputs, one thread doing both the solve and the stencil, and
// keeping A's diag, top and bottom in shared memory for the stencil (12
// streams, half the columns in flight).
//
// Tall columns: where even the narrow tile's state does not fit in shared
// memory (f64 above nz = 176, f32 above nz = 360), the same kernel keeps
// it in a per-block buffer in device memory (kSpill), allocated on the
// stream for the launch and freed after it; the operations are the same.
//
// Neighbours follow K1 and the plain apply_stencil: i is periodic; the
// row past the top is, on a tripolar grid, the fold partner row
// (ny-1, nx-1-i), solved by the strip that holds row ny-1, and zero on a
// bipolar grid; the row below j = 0 and the levels above k = 0 and below
// k = nz-1 read zero.
//
// Operation order, so that z and out equal the K2 + K1 composition bit for
// bit (the library is built with -fmad=false): z = x1 + c2*x2 in two
// roundings; the Thomas solve is K2's (dp = (z - upper*dp_prev) * rden up
// the column, x = dp - cp*x_next down it from x_next = 0); the stencil sum
// is K1's (diag, east, west, north, south, top, bottom).
//
// The dot accumulates rhat*out in double, reduced first in a fixed tree
// per block, then over the blocks in a fixed order by a second small
// kernel: no floating-point atomics, so d is the same bits on every run.
#include "common.cuh"

namespace otmb {

constexpr int kMaxThreads = 256;   // solver and stencil threads of a block
constexpr int kOwn = 56;           // owned columns of a tile along i
constexpr int kOwnNarrow = 30;     // where kOwn's shared memory would not fit;
                                   // ops/krylov.py's MIN_OWN sizes the partials by it
constexpr int kWarps = 4;          // stencil warps of a block
constexpr int kChunk = 8;          // levels of a solver's chunk
constexpr int kSlots = 4;          // rows of M(z) in shared memory
constexpr int kBatch = 4;          // levels a stencil thread loads at once
constexpr int kFinishThreads = 1024;

template <typename T>
struct KrylovParams {
  const T* a[7];                    // A: diag, east, west, north, south, top, bottom
  const T *cp, *rden, *upper;       // M's factor (K2's) and upper leg
  const T *x1, *x2, *c2, *rhat;
  T *z, *out;
  double* partials;
  T* spill;                         // the blocks' state in device memory (kSpill)
  int nz, ny, nx;
  int own, rows;                    // tile width and strip rows, set by the launcher
  int tripolar;
};

__host__ __device__ constexpr int solver_threads(int own) { return (own + 2 + 31) / 32 * 32; }
static_assert(32 * kWarps >= kOwn && solver_threads(kOwn) + 32 * kWarps <= kMaxThreads,
              "a tile's stencil threads cover its columns, and fit in a block");

// A block's state, in values: M(z) of kSlots rows and cp, a value each a
// level (padded to whole chunks) of each of its own + 2 columns
inline size_t krylov_state_values(int nz, int own) {
  const size_t nzp = (static_cast<size_t>(nz) + kChunk - 1) / kChunk * kChunk;
  return (static_cast<size_t>(own) + 2) * (kSlots + 1) * nzp;
}

// A block's state, in shared memory or (kSpill) in its part of p.spill,
// in values of T, each array [...][nth] with the column (pos for M(z), tx
// otherwise) innermost:
//   S[kSlots][nzp] M(z) of rows q % kSlots (dp of the row being solved,
//                  then M(z)), nzp = nz padded to whole chunks
//   C[nzp]         cp of the row being solved
template <typename T, bool kCombine, bool kDot, bool kSpill>
__global__ void __launch_bounds__(kMaxThreads)
krylov_kernel(const KrylovParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double warp_sums[kMaxThreads / 32];

  const int nz = p.nz, ny = p.ny, nx = p.nx, own = p.own;
  const int nth = own + 2;
  const int nsolve = solver_threads(own);
  const long long plane = static_cast<long long>(ny) * nx;
  const int nch = (nz + kChunk - 1) / kChunk;
  const int nzp = nch * kChunk;  // levels padded to whole chunks
  T* const S = kSpill ? p.spill + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) *
                                      (kSlots + 1) * nzp * nth
                      : reinterpret_cast<T*>(smem_raw);
  T* const C = S + kSlots * nzp * nth;

  const int tx = threadIdx.x;
  const int i0 = static_cast<int>(blockIdx.x) * own;
  const int j0 = static_cast<int>(blockIdx.y) * p.rows;
  const int j1 = min(ny, j0 + p.rows);
  const int nrows = j1 - j0 + 2;  // rows j0-1 .. j1, counted by q from j0-1
  double dsum = 0.0;

  if (tx < nsolve) {
    // A solver thread: threads 0 .. own-1 take the owned columns, thread
    // own the west halo column, own+1 the east one (the rest idle).
    const bool active = tx < nth;
    const int pos = tx < own ? tx + 1 : (tx == own ? 0 : own + 1);
    const int i = i0 - 1 + pos;
    const bool col_ok = active && i <= nx;
    const int si = i < 0 ? i + nx : (i >= nx ? i - nx : i);
    const bool owner = active && pos >= 1 && pos <= own && i < nx;
    // The source column of row r: i wraps; row ny is the tripolar fold
    // partner row; every other row outside [0, ny) is empty.
    auto source = [&](int r, long long& col) -> bool {
      if (!col_ok || r < 0) return false;
      if (r < ny) {
        col = static_cast<long long>(r) * nx + si;
        return true;
      }
      if (r == ny && p.tripolar) {
        col = static_cast<long long>(ny - 1) * nx + (nx - 1 - si);
        return true;
      }
      return false;
    };
    // The forward sweep's inputs of a chunk (x1, x2, cp, rden, upper at
    // kChunk levels) are loaded into registers one chunk ahead of their
    // use. The levels of an empty row, and those past nz in the last
    // chunk, take zeros, which give dp = 0 by the same operations: the
    // sweeps run without a branch.
    auto load_chunk = [&](int q, int c, T (&v)[kChunk][5]) {
      long long col = 0;
      const bool valid = q < nrows && source(j0 - 1 + q, col);
      const int k0 = c * kChunk;
      const long long g0 = k0 * plane + col;
#pragma unroll
      for (int l = 0; l < kChunk; ++l) {
        const bool in = valid && k0 + l < nz;
        const long long g = in ? g0 + l * plane : 0;
        v[l][0] = in ? p.x1[g] : T(0);
        v[l][1] = in && kCombine ? p.x2[g] : T(0);
        v[l][2] = in ? p.cp[g] : T(0);
        v[l][3] = in ? p.rden[g] : T(0);
        v[l][4] = in ? p.upper[g] : T(0);
      }
    };

    const T c2 = kCombine ? *p.c2 : T(0);
    T next[kChunk][5];
    if (active) load_chunk(0, 0, next);
    for (int q = 0; q <= nrows; ++q) {
      if (q < nrows && active) {
        const int r = j0 - 1 + q;
        T* const Sq = S + (q % kSlots) * nzp * nth + pos;
        const bool write_z = kCombine && owner && r >= j0 && r < j1;
        T* const zcol = p.z + static_cast<long long>(r) * nx + i;
        // forward sweep: dp of row r's column
        T dp_prev = T(0);
        for (int c = 0; c < nch; ++c) {
          T cur[kChunk][5];
#pragma unroll
          for (int l = 0; l < kChunk; ++l) {
#pragma unroll
            for (int m = 0; m < 5; ++m) cur[l][m] = next[l][m];
          }
          if (c + 1 < nch) {
            load_chunk(q, c + 1, next);
          } else {
            load_chunk(q + 1, 0, next);
          }
          const int k0 = c * kChunk;
          T zk[kChunk];
#pragma unroll
          for (int l = 0; l < kChunk; ++l) {
            zk[l] = kCombine ? cur[l][0] + c2 * cur[l][1] : cur[l][0];
            dp_prev = (zk[l] - cur[l][4] * dp_prev) * cur[l][3];
            C[(k0 + l) * nth + tx] = cur[l][2];
            Sq[(k0 + l) * nth] = dp_prev;
          }
          if (write_z) {
#pragma unroll
            for (int l = 0; l < kChunk; ++l) {
              if (k0 + l < nz) zcol[(k0 + l) * plane] = zk[l];
            }
          }
        }
        // back substitution, chunk by chunk down the column, from x = 0
        // above level nz-1
        T x_next = T(0);
        for (int c = nch - 1; c >= 0; --c) {
          const int k0 = c * kChunk;
          T dp[kChunk], cp[kChunk];
#pragma unroll
          for (int l = 0; l < kChunk; ++l) {
            dp[l] = Sq[(k0 + l) * nth];
            cp[l] = C[(k0 + l) * nth + tx];
          }
#pragma unroll
          for (int l = kChunk - 1; l >= 0; --l) {
            const T x = dp[l] - cp[l] * x_next;
            x_next = k0 + l < nz ? x : T(0);
            Sq[(k0 + l) * nth] = x_next;
          }
        }
      }
      __syncthreads();  // row q's M(z) complete; row q-2's stencil done
    }
  } else {
    // A stencil thread: in iteration q it applies A to row q-2 of the
    // strip (rows q-3, q-2, q-1 of M(z) complete), column i0 + il at the
    // levels kg, kg + kstep, ...
    const int st = tx - nsolve;
    const int kstep = (static_cast<int>(blockDim.x) - nsolve) / own;
    const int il = st % own;
    const int kg = st / own;
    const int i = i0 + il;
    const bool works = kg < kstep && i < nx;
    const int pos = il + 1;
    for (int q = 0; q <= nrows; ++q) {
      const int sq = q - 2;
      if (works && sq >= 1 && sq <= nrows - 2) {
        const T* const Sc = S + (sq % kSlots) * nzp * nth + pos;
        const T* const Sn = S + ((sq + 1) % kSlots) * nzp * nth + pos;
        const T* const Ss = S + ((sq + 3) % kSlots) * nzp * nth + pos;
        const long long g0 = static_cast<long long>(j0 - 1 + sq) * nx + i;
        // kBatch levels at a time: every load of the batch is issued
        // before the first store, so that they are in flight together
        for (int kb = kg; kb < nz; kb += kBatch * kstep) {
          T leg[kBatch][7], rh[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int k = kb + b * kstep;
            if (k < nz) {
              const long long g = k * plane + g0;
#pragma unroll
              for (int m = 0; m < 7; ++m) leg[b][m] = p.a[m][g];
              if (kDot) rh[b] = p.rhat[g];
            }
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int k = kb + b * kstep;
            if (k < nz) {
              const int kc = k * nth;
              const T xt = k > 0 ? Sc[kc - nth] : T(0);
              const T xb = k + 1 < nz ? Sc[kc + nth] : T(0);
              T acc = leg[b][0] * Sc[kc];
              acc = acc + leg[b][1] * Sc[kc + 1];
              acc = acc + leg[b][2] * Sc[kc - 1];
              acc = acc + leg[b][3] * Sn[kc];
              acc = acc + leg[b][4] * Ss[kc];
              acc = acc + leg[b][5] * xt;
              acc = acc + leg[b][6] * xb;
              p.out[k * plane + g0] = acc;
              if (kDot) dsum += static_cast<double>(rh[b]) * static_cast<double>(acc);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (kDot) {
    // Fixed-order block sum: a shuffle tree per warp, then warp 0 over the
    // warp sums.
    const int lane = tx & 31;
    const int warp = tx >> 5;
    const int nwarps = static_cast<int>(blockDim.x) >> 5;
    double v = dsum;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? warp_sums[lane] : 0.0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) p.partials[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = v;
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

// One launch: as many strips of rows as make one wave of blocks on the
// card; with kSpill, the blocks' state allocated on the stream before the
// kernel and freed after it.
template <typename T, bool kCombine, bool kDot, bool kSpill>
cudaError_t launch_variant(KrylovParams<T> p, size_t bytes, cudaStream_t s, int* nblocks) {
  auto kernel = krylov_kernel<T, kCombine, kDot, kSpill>;
  const int threads = solver_threads(p.own) + 32 * kWarps;
  const int nblocks_x = (p.nx + p.own - 1) / p.own;
  long long slots = 0;
  cudaError_t err = block_slots(kernel, threads, bytes, &slots);
  if (err != cudaSuccess) return err;
  long long strips = slots / nblocks_x;
  strips = strips < 1 ? 1 : (strips > p.ny ? p.ny : strips);
  p.rows = static_cast<int>((p.ny + strips - 1) / strips);
  const dim3 grid(nblocks_x, (p.ny + p.rows - 1) / p.rows);
  *nblocks = static_cast<int>(grid.x * grid.y);
  if (kSpill) {
    const size_t values = krylov_state_values(p.nz, p.own) * grid.x * grid.y;
    err = cudaMallocAsync(reinterpret_cast<void**>(&p.spill), sizeof(T) * values, s);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, bytes, s>>>(p);
  err = cudaGetLastError();
  if (kSpill) {
    const cudaError_t freed = cudaFreeAsync(p.spill, s);
    if (err == cudaSuccess) err = freed;
  }
  return err;
}

template <typename T, bool kSpill>
cudaError_t launch_flags(const KrylovParams<T>& p, size_t bytes, int combine, int dot,
                         cudaStream_t s, int* nblocks) {
  if (combine && dot) return launch_variant<T, true, true, kSpill>(p, bytes, s, nblocks);
  if (combine) return launch_variant<T, true, false, kSpill>(p, bytes, s, nblocks);
  if (dot) return launch_variant<T, false, true, kSpill>(p, bytes, s, nblocks);
  return launch_variant<T, false, false, kSpill>(p, bytes, s, nblocks);
}

// The tile: kOwn columns, or kOwnNarrow where kOwn's state would not fit
// in shared memory; with kOwn columns two blocks share an SM at nz = 75 in
// f32, and of the tile widths 32-96 and 2-6 stencil warps timed on an H100
// (PERF.md) it was the fastest at 1440x1080x75. Where neither
// fits, kOwn columns with their state in device memory.
template <typename T>
int launch_krylov(KrylovParams<T> p, void* d, int capacity, int combine, int dot,
                  cudaStream_t s) {
  if (p.nz < 1 || p.ny < 1 || p.nx < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the dynamic shared memory a block may take, beside its static block sums
  const size_t most = kMaxSharedBytes - sizeof(double) * (kMaxThreads / 32);
  const bool spill = sizeof(T) * krylov_state_values(p.nz, kOwnNarrow) > most;
  p.own = !spill && sizeof(T) * krylov_state_values(p.nz, kOwn) > most ? kOwnNarrow : kOwn;
  p.spill = nullptr;
  // a strip is one row or more, so the blocks are at most ceil(nx/own) * ny
  if (dot && static_cast<long long>((p.nx + p.own - 1) / p.own) * p.ny > capacity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int nblocks = 0;
  const cudaError_t err =
      spill ? launch_flags<T, true>(p, 0, combine, dot, s, &nblocks)
            : launch_flags<T, false>(p, sizeof(T) * krylov_state_values(p.nz, p.own), combine,
                                     dot, s, &nblocks);
  if (err != cudaSuccess || !dot) return static_cast<int>(err);
  krylov_dot_finish<T><<<1, kFinishThreads, 0, s>>>(p.partials, nblocks, static_cast<T*>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

// capacity: the f64 partials the caller allocated, at least
// ceil(nx/kOwnNarrow) * ny.
#define OTMB_KRYLOV_ENTRIES(SUFFIX, T)                                                          \
  OTMB_EXPORT int otmb_krylov_##SUFFIX(                                                        \
      const void* diag, const void* east, const void* west, const void* north,                 \
      const void* south, const void* top, const void* bottom, const void* cp,                  \
      const void* rden, const void* upper, const void* x1, const void* x2, const void* c2,     \
      const void* rhat, void* z, void* out, void* partials, void* d, int capacity, int nz,     \
      int ny, int nx, int tripolar, int combine, int dot, void* stream) {                      \
    auto c = [](const void* q) { return static_cast<const T*>(q); };                           \
    const otmb::KrylovParams<T> p = {                                                          \
        {c(diag), c(east), c(west), c(north), c(south), c(top), c(bottom)},                    \
        c(cp), c(rden), c(upper), c(x1), c(x2), c(c2), c(rhat),                                \
        static_cast<T*>(z), static_cast<T*>(out), static_cast<double*>(partials), nullptr,     \
        nz, ny, nx, 0, 0, tripolar};                                                           \
    return otmb::launch_krylov<T>(p, d, capacity, combine, dot,                                \
                                  static_cast<cudaStream_t>(stream));                          \
  }

OTMB_KRYLOV_ENTRIES(f32, float)
OTMB_KRYLOV_ENTRIES(f64, double)
