// K6: the Redi isoneutral-diffusion operator, out = R chi, for one tracer
// (nz, ny, nx) or a batch (B, nz, ny, nx) that shares one read of the
// coefficients; its step mode, the whole explicit T + R step out = chi -
// dt T chi + dt R chi in one walk; its matvec mode, out = T chi - R chi
// for one tracer, the steady-state solves' operator; and K9, K6 on one
// shard of a process grid (kShard, at the end). Replaces the Pallas kernels of
// otmb_tpu/models/redi_pallas.py (_redi_kernel, _redi_kernel_blocked,
// _redi_kernel_multi).
//
// Bound on the H100: device-memory bandwidth. Per cell it must read the 15
// coefficient fields, chi and the wet mask and write out: in f32, 68 bytes
// and one, against ~111 flops; bf16 coefficients take 38 + 1; each further
// member 8 bytes. The step mode reads T's 7 legs besides (28 bytes in f32):
// 153 bytes a cell for 8 f32 tracers, where K5 and then K6 adding into K5's
// output moved 249.
//
// Design: k-marching tiles. A block of 256 threads owns kTJ x kTI = 8 x 32
// columns of a group of G members, G = 1, 2, 4 or 8 fixed at compile time
// (the launch picks it from the batch and the value type, with_group), so
// that every member loop unrolls. It walks k down with four levels of each
// member's chi on the tile and its one-cell ring in shared memory (staged by
// cp.async three levels ahead, masked once landed) and dcz by the level's
// parity: the only values other threads read. A thread stages, masks and
// takes dcz at its own column and, below kRing, at one ring position, so
// one barrier a step makes them visible. What only its thread reads stays in
// registers: dcx, dcy and the top flux carried to the next level. The west
// face is lane tx - 1's east face, passed by shuffle (a warp is a row of the
// tile); the south face, the north face of the row below, is taken again by
// this row. The steps are branch-free: missing neighbours, levels and
// members are computed and 0 selected, so the loads of a step issue
// together.
//
// What bounds it is latency. At G = 8 (f32; G = 2 in f64) a thread needs
// 128 registers, so two blocks (16 warps) share an SM; there the step's
// coefficients are staged in shared memory a step ahead (kBundle, `staged`)
// and the 456 tiles of the 1-degree grid fill 264 slots in two chunks of
// levels (pick_chunks). On an H100 80GB HBM3 at 700 W (scripts/k6_probe.py)
// the step mode at B = 8 takes 0.503 ms against the T + R step's 0.247 ms
// byte bound (K5, 0.197 ms, and then K6 adding dt R chi into its output,
// 0.483 ms, took 0.680 ms); its 1,657 instructions a warp and step (plain
// K6 1,261) issue at about the rate plain K6's do, so what bounds it is
// still latency and issue, not bytes. One tracer (G = 1, four blocks an
// SM) takes 0.149 ms and K9 on a 150 x 180 x 50 shard 0.066 ms, each
// tile's walk split into chunks where the tiles leave SMs idle.
//
// The step mode (Leg, T's leg type; the entries otmb_redi_<types>_step_<legs>,
// ops/stencil.py's propagations with `redi=`) writes chi - dt T chi + dt R
// chi. T's 7-point sum is taken on the levels the walk already holds (the
// column's levels k - 1, k and k + 1, and level k's four neighbours through
// the same locate rule as K5's) in K5's order (diag, east, west, north,
// south, top, bottom), then rounded as K5 writes chi - dt * sum and as the
// Redi half adds dt * div: the two-launch step's bits, in one launch and
// one pass over the batch. T reads chi as stored and R reads it masked, so
// in the step mode chi stays in shared memory as stored (0 where nothing is
// read), beside it each position's wet bit by level buffer, and R selects 0
// where the bit is clear: one AND with a mask of the bit (keep), as
// selects on 14 wet flags a step took 1,838 instructions a warp and step to
// K6's 1,261 and spent about 200 of them on predicates. T's legs are loaded
// a step ahead into registers, as K5 loads them.
//
// The matvec mode (kApply, with Leg; one tracer, G = 1; the entries
// otmb_redi_<types>_apply_<legs>, models/solvers.py's systems with `redi=`)
// is the step mode's walk with another output: T's 7-point sum as K1 takes
// it, less R chi, rounded once, acc - div. The step mode cannot give it:
// with dt = -1 it writes chi + (T - R) chi, and taking chi off again loses
// (T - R) chi in f32 where chi is an age of 1e9 s and T chi about 10. On an
// H100 80GB HBM3 at 700 W it takes 0.249 ms at 1 degree in f32 against a
// 0.157 ms byte bound (97 bytes a cell), and 0.466 ms in f64.
//
// Semantics are those of models/redi.py:redi_apply, the plain version: chi
// is masked by wet; i is periodic; a missing neighbour (j-1 at the south
// edge, j+1 at a bipolar north edge, k-1 at the surface, k+1 at the floor)
// or derived quantity reads 0; the tripolar north neighbour of (k, ny-1, i)
// is (k, ny-1, nx-1-i). Each value is the plain version's expression on the
// same operands in the same order, in the value type V, built without FMA
// contraction: equal bit for bit, and member b of a batch equals a single run.
#include <type_traits>

#include "common.cuh"

namespace otmb {

// The 17 coefficient fields, in the order of models/redi.py:_COEF_FIELDS.
enum RediField {
  kAe, kSe, kAn, kSn, kAt, kSti, kStj, kGt, kCzu, kCzd, kCxe, kCxw, kCyn, kCys,
  kInvDe, kInvDn, kInvV, kRediFields
};

// K9's lines (shard mode), what K6 reads beyond a shard's edges: cz_u, cz_d
// (2, nz, L) east and north, with ae, s_e (west) or an, s_n (south) (4, nz,
// L); inv_de west, inv_dn south; wet and chi (nz, L). L is ny east and west,
// nx north and south; north of the top row, the fold partner's reversed row.
template <typename C, typename V>
struct RediHalo {
  const C *east, *west, *north, *south, *inv_de_w, *inv_dn_s;
  const unsigned char *wet_e, *wet_w, *wet_n, *wet_s;
  const V *chi_e, *chi_w, *chi_n, *chi_s;
  int s_edge;  // the shard's first row has a south neighbour
};

constexpr int kTI = 32, kTJ = 8;        // owned columns along i and j
constexpr int kPI = kTI + 2;            // positions along i, with the ring
constexpr int kPos = kPI * (kTJ + 2);   // positions of the tile and its ring
constexpr int kThreads = kTI * kTJ;
constexpr int kRing = 2 * kPI + 2 * kTJ;  // the ring's positions, one each on threads below

// Ring position r: the south row, the north row, the west and the east column.
__device__ __forceinline__ int ring_position(int r) {
  if (r < kPI) return r;
  if (r < 2 * kPI) return (kTJ + 1) * kPI + r - kPI;
  if (r < 2 * kPI + kTJ) return (r - 2 * kPI + 1) * kPI;
  return (r - 2 * kPI - kTJ + 1) * kPI + kPI - 1;
}

// Where a position reads: offset h in a level of the field (side 0), in a
// shard's line (sides 1..4: east, west, north, south), or nothing (side -1).
struct Loc { int h; int side; };

template <typename P>  // the line of side 1..4
__device__ __forceinline__ P side_of(int side, P e, P w, P n, P s) {
  return side == 1 ? e : side == 2 ? w : side == 3 ? n : s;
}

template <typename C, typename V, bool kShard>
struct Reader {
  const C* f[kRediFields];
  const unsigned char* wet;
  const V* chi;
  RediHalo<C, V> h;
  int plane, nz, ny, nx;  // the launch checks nz * plane < 2^31
  int north;              // the row past the top is read (fold or shard row)

  // The position at (gj, gi): i periodic and the tripolar fold row on the
  // whole field; the edge lines in shard mode.
  __device__ Loc locate(int gj, int gi) const {
    if (!kShard) {
      const int i = ((gi % nx) + nx) % nx;
      if (gj >= 0 && gj < ny) return {gj * nx + i, 0};
      if (gj == ny && north) return {(ny - 1) * nx + (nx - 1 - i), 0};
      return {0, -1};
    }
    const bool in_i = gi >= 0 && gi < nx, in_j = gj >= 0 && gj < ny;
    if (in_i && in_j) return {gj * nx + gi, 0};
    if (in_j && (gi == nx || gi == -1)) return {gj, gi == nx ? 1 : 2};
    if (in_i && gj == ny && north) return {gi, 3};
    if (in_i && gj == -1 && h.s_edge) return {gi, 4};
    return {0, -1};
  }
  __device__ bool has(const Loc& L, int k) const { return L.side >= 0 && k >= 0 && k < nz; }
  __device__ int line(const Loc& L, int k) const { return k * (L.side <= 2 ? ny : nx) + L.h; }
  // The reads below are branch-free, so a step's loads issue back to back:
  // where there is nothing to read they load the first element and select
  // 0 (or false) instead.
  __device__ bool wet_at(const Loc& L, int k) const {
    const bool ok = has(L, k);
    const unsigned char* p = wet + (ok ? k * plane + L.h : 0);
    if (kShard && L.side > 0)
      p = side_of(L.side, h.wet_e, h.wet_w, h.wet_n, h.wet_s) + (ok ? line(L, k) : 0);
    const bool w = *p != 0;
    return ok && w;
  }
  // chi of the member at offset m at level k
  __device__ const V* chi_at(const Loc& L, int k, long long m) const {
    if (kShard && L.side > 0)
      return side_of(L.side, h.chi_e, h.chi_w, h.chi_n, h.chi_s) + line(L, k);
    return chi + m + k * plane + L.h;
  }
  // field `fi` at level k, or field `slot` of the side's coefficient lines
  // (written out rather than through coef_at: that form spilled, measured)
  __device__ V coef(const Loc& L, int fi, int slot, int k) const {
    const bool ok = has(L, k);
    const C* p = f[fi] + (ok ? k * plane + L.h : 0);
    if (kShard && L.side > 0)
      p = side_of(L.side, h.east, h.west, h.north, h.south) + (ok ? line(L, slot * nz + k) : 0);
    const V v = widen(*p);
    return ok ? v : V(0);
  }
  // where coef() reads (has(L, k) must hold)
  __device__ const C* coef_at(const Loc& L, int fi, int slot, int k) const {
    if (kShard && L.side > 0)
      return side_of(L.side, h.east, h.west, h.north, h.south) + line(L, slot * nz + k);
    return f[fi] + (k * plane + L.h);
  }
  // inv_de or inv_dn, (ny, nx); beyond a shard's west or south edge its line
  __device__ V plane_coef(const Loc& L, int fi) const {
    const bool ok = L.side >= 0;
    const C* p = f[fi] + (ok ? L.h : 0);
    if (kShard && L.side > 0) p = (fi == kInvDe ? h.inv_de_w : h.inv_dn_s) + L.h;
    const V v = widen(*p);
    return ok ? v : V(0);
  }
};

// A thread's coefficients for step k: dcz weights of its two positions and
// its column's face coefficients at level k (with its south neighbour's
// north face and, in lane 0, its west neighbour's east face), and dcx, dcy
// and top-face weights at k + 1.
template <typename V>
struct Level {
  V czu[2], czd[2], ae, se, an, sn, invv, cxe, cxw, cyn, cys, at, sti, stj, gt, ae_w, se_w, an_s,
      sn_s;
};

// Those reads, staged in shared memory a step ahead by cp.async (where the
// coefficients take 4 or 8 bytes): the column's 15 fields (slot f, inv_v
// in slot 14), then the ring's cz_u and cz_d, row 0's south neighbours' an
// and s_n, and lane 0's west neighbours' ae and s_e. A field's level: k,
// or k + 1 for the top face's weights and dcx's and dcy's.
constexpr int kOwn = 15, kRimAt = kOwn * kThreads, kSouthAt = kRimAt + 2 * kRing;
constexpr int kWestAt = kSouthAt + 2 * kTI, kBundle = kWestAt + 2 * kTJ;
__device__ __forceinline__ int own_slot(int f) { return f == kInvV ? 14 : f; }
__device__ __forceinline__ bool next_level(int f) {
  return (f >= kAt && f <= kGt) || (f >= kCxe && f <= kCys);
}

template <typename Leg>
constexpr size_t kLegBytes = sizeof(Leg);  // T's leg in the step mode
template <>
constexpr size_t kLegBytes<void> = 0;

// Blocks an SM the register budget is set for: four for one or two f32
// members (three in the step mode, which spilled at 64 registers: one
// tracer's T + R step 0.2373 -> 0.2344 ms at 1 degree, scripts/k6_probe.py),
// three for four, two for eight (128 registers) and for f64.
template <typename V, int G, typename Leg = void>
constexpr int kMinBlocks =
    sizeof(V) == 4 ? (G <= 2 ? (kLegBytes<Leg> ? 3 : 4) : G == 4 ? 3 : 2) : 2;

// Where registers hold a block to two an SM and its step carries several
// members, the step's coefficients are staged (kBundle), if two blocks
// still fit: f32 in groups of 8, f64 in groups of 2. There a step's work
// hides the copies, and the loads' latency is what two blocks cannot hide;
// elsewhere the copies cost more than they save. Measured at 1 degree (the
// accumulating entry at B = 8, the others plain; scripts/k6_probe.py):
// f32 G = 8 0.550 -> 0.516 ms, f64 G = 2 0.385 -> 0.347 ms; but f32 G = 1
// 0.160 -> 0.202, f32 G = 4 0.296 -> 0.309 and f64 G = 1 0.311 -> 0.330 ms.
// The step mode (Leg, the type of T's legs, not void) adds each position's
// wet bits (kWetBytes) to the walk's shared memory: f32 G = 8 takes 2 x
// 99,360 bytes of the SM's 233,472 (the 1 KB each block reserves
// included). T's legs come through registers, a step ahead, as K5 loads
// them: staged with the coefficients (7 x 256 x 4 bytes by the step's
// parity, two blocks still fitting) the step took 0.578 ms at B = 8 and 1
// degree, from registers 0.504 ms (scripts/k6_probe.py, an H100 80GB HBM3
// at 700 W).
template <typename Leg>
struct StepLegs {  // T's legs in K5's order: diag, east, west, north, south, top, bottom
  const Leg* p[7];
};
template <>
struct StepLegs<void> {};
constexpr int kWetBytes = (kPos + 15) / 16 * 16;
template <typename V, int G, typename Leg>
constexpr size_t kWalkBytes = 6 * G * kPos * sizeof(V) + (kLegBytes<Leg> ? kWetBytes : 0);

template <typename C, typename V, int G, typename Leg = void>
constexpr bool staged =
    sizeof(C) >= 4 && G >= 2 && kMinBlocks<V, G, Leg> == 2 &&
    2 * (kWalkBytes<V, G, Leg> + 2 * kBundle * sizeof(C) + 1024) <= 228 * 1024;
template <typename C, typename V, int G, typename Leg>
constexpr size_t kBlockBytes =
    kWalkBytes<V, G, Leg> + (staged<C, V, G, Leg> ? 2 * kBundle * sizeof(C) : 0);

// The step mode's wet bits, as R reads them: a mask of all ones where bit b
// of `bits` is set, else 0, and a value through it (itself, or +0), so
// that R's select is one AND and takes no predicate register.
__device__ __forceinline__ unsigned keep_mask(unsigned bits, int b) {
  return 0u - ((bits >> b) & 1u);
}
__device__ __forceinline__ float keep(unsigned m, float v) {
  return __uint_as_float(__float_as_uint(v) & m);
}
__device__ __forceinline__ double keep(unsigned m, double v) {
  const long long m64 = static_cast<int>(m);  // 0 or all ones
  return __longlong_as_double(__double_as_longlong(v) & m64);
}

// G members at compile time (the last group of a batch may hold fewer, nm);
// the step mode with Leg, T's leg type (void: out = R chi), or with kApply
// the matvec mode.
template <typename C, typename V, bool kShard, int G, typename Leg, bool kApply = false>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<V, G, Leg>))
redi_kernel(Reader<C, V, kShard> R, V* __restrict__ out, int nmembers, int nchunks, V dt,
            StepLegs<Leg> T) {
  static_assert(!kApply || (kLegBytes<Leg> > 0 && G == 1), "the matvec mode: T's legs, G = 1");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = R.nz, t = threadIdx.x, tx = t % kTI, ty = t / kTI;
  // a batch's groups of one tile are neighbours in the grid, so they run
  // together and share each coefficient read through the L2
  const int ngroups = (nmembers + G - 1) / G;
  const int i0 = blockIdx.x / ngroups * kTI, j0 = blockIdx.y * kTJ, m0 = blockIdx.x % ngroups * G;
  const int nm = nmembers - m0 < G ? nmembers - m0 : G;
  // this block's levels [k_lo, k_hi); its walk starts two steps above (or at
  // the surface, k_s = -1) to carry in dcx, dcy and the top flux
  const int span = (nz + nchunks - 1) / nchunks, k_lo = blockIdx.z * span;
  const int k_hi = k_lo + span < nz ? k_lo + span : nz, k_s = k_lo > 0 ? k_lo - 2 : -1;
  if (k_lo >= nz) return;
  const long long member = static_cast<long long>(R.plane) * nz;
  // shared: chi [4][G][kPos]; dcz [2][G][kPos] by the parity of the level;
  // the staged coefficients [2][kBundle] by the step's parity; in the step
  // mode the wet bits [kPos], bit b for level buffer b
  constexpr bool kStep = kLegBytes<Leg> > 0;
  constexpr bool kStaged = staged<C, V, G, Leg>;
  using LS = std::conditional_t<kStep, Leg, unsigned char>;  // T's leg as stored
  V* const chi_s = reinterpret_cast<V*>(smem_raw);
  V* const dcz_s = chi_s + 4 * G * kPos;
  C* const coef_s = reinterpret_cast<C*>(dcz_s + 2 * G * kPos);
  unsigned char* const wet_s =
      reinterpret_cast<unsigned char*>(coef_s + (kStaged ? 2 * kBundle : 0));

  // this thread's column; its two positions, which it stages, masks and
  // takes dcz at: its own, read live or not (a dead column can be a live
  // one's neighbour), and below kRing one of the ring's
  const int i = i0 + tx, j = j0 + ty;
  const bool live = i < R.nx && j < R.ny;
  const bool has_s = j > 0 || (kShard && R.h.s_edge);
  const bool ring = t < kRing;
  const int pc = (ty + 1) * kPI + tx + 1, pe = pc + 1, pw = pc - 1, pn = pc + kPI, ps = pc - kPI;
  const int pr = ring ? ring_position(t) : pc;
  const Loc none{0, -1}, lo = R.locate(j, i);
  const Loc lr = ring ? R.locate(j0 - 1 + pr / kPI, i0 - 1 + pr % kPI) : none;
  const Loc lc = live ? lo : none, lw = live && tx == 0 ? R.locate(j, i - 1) : none;
  const Loc ls = live && has_s ? R.locate(j - 1, i) : none;
  const V ide = R.plane_coef(lc, kInvDe), idn = R.plane_coef(lc, kInvDn);
  const V ide_w = R.plane_coef(lw, kInvDe), idn_s = R.plane_coef(ls, kInvDn);
  auto load = [&](int k) {  // read directly
    Level<V> c;
    c.czu[0] = R.coef(lo, kCzu, 0, k), c.czd[0] = R.coef(lo, kCzd, 1, k);
    c.czu[1] = R.coef(lr, kCzu, 0, k), c.czd[1] = R.coef(lr, kCzd, 1, k);
    auto own = [&](int f, int lev) { return R.coef(lc, f, 0, lev); };
    c.ae = own(kAe, k), c.se = own(kSe, k), c.an = own(kAn, k), c.sn = own(kSn, k);
    c.invv = own(kInvV, k), c.cxe = own(kCxe, k + 1), c.cxw = own(kCxw, k + 1);
    c.cyn = own(kCyn, k + 1), c.cys = own(kCys, k + 1), c.at = own(kAt, k + 1);
    c.sti = own(kSti, k + 1), c.stj = own(kStj, k + 1), c.gt = own(kGt, k + 1);
    c.ae_w = R.coef(lw, kAe, 2, k), c.se_w = R.coef(lw, kSe, 3, k);
    c.an_s = R.coef(ls, kAn, 2, k), c.sn_s = R.coef(ls, kSn, 3, k);
    return c;
  };
  // stage step k's coefficients into its buffer, each by the thread that
  // reads it; rows 1 to 7 read their south neighbours' an and s_n from the
  // row below's own, row 0 stages them from the ring
  auto stage_coef = [&](int k) {
    if constexpr (kStaged) {
      C* const b = coef_s + (k & 1) * kBundle;
      auto put = [&](C* dst, const Loc& at, int f, int slot, int lev) {
        if (R.has(at, lev)) {
          cp_async(dst, R.coef_at(at, f, slot, lev));
        } else {
          *dst = C(0);
        }
      };
#pragma unroll
      for (int f = 0; f < kRediFields; ++f)
        if (f != kInvDe && f != kInvDn)
          put(b + own_slot(f) * kThreads + t, f == kCzu || f == kCzd ? lo : lc, f,
              f == kCzd ? 1 : 0, next_level(f) ? k + 1 : k);
      if (ring) {
        put(b + kRimAt + t, lr, kCzu, 0, k);
        put(b + kRimAt + kRing + t, lr, kCzd, 1, k);
      }
      if (ty == 0) {
        put(b + kSouthAt + tx, ls, kAn, 2, k);
        put(b + kSouthAt + kTI + tx, ls, kSn, 3, k);
      }
      if (tx == 0) {
        put(b + kWestAt + ty, lw, kAe, 2, k);
        put(b + kWestAt + kTJ + ty, lw, kSe, 3, k);
      }
    }
  };
  // step k's staged reads: the dcz weights (this thread's own copies) as
  // the step starts, the rest after its barrier
  auto read_dz = [&](int k, Level<V>& c) {
    const C* const b = coef_s + (k & 1) * kBundle;
    c.czu[0] = widen(b[kCzu * kThreads + t]), c.czd[0] = widen(b[kCzd * kThreads + t]);
    const int r = ring ? t : 0;
    c.czu[1] = widen(b[kRimAt + r]), c.czd[1] = widen(b[kRimAt + kRing + r]);
  };
  auto read_rest = [&](int k, Level<V>& c) {
    const C* const b = coef_s + (k & 1) * kBundle;
    auto own = [&](int f) { return widen(b[own_slot(f) * kThreads + t]); };
    c.ae = own(kAe), c.se = own(kSe), c.an = own(kAn), c.sn = own(kSn), c.invv = own(kInvV);
    c.cxe = own(kCxe), c.cxw = own(kCxw), c.cyn = own(kCyn), c.cys = own(kCys);
    c.at = own(kAt), c.sti = own(kSti), c.stj = own(kStj), c.gt = own(kGt);
    c.ae_w = widen(b[kWestAt + ty]), c.se_w = widen(b[kWestAt + kTJ + ty]);
    c.an_s = widen(ty > 0 ? b[kAn * kThreads + t - kTI] : b[kSouthAt + tx]);
    c.sn_s = widen(ty > 0 ? b[kSn * kThreads + t - kTI] : b[kSouthAt + kTI + tx]);
  };
  // the step mode: T's legs at the column, loaded a step ahead into
  // registers as K5 loads them, widened where used
  struct Legs {
    LS v[7];
  };
  auto legs_at = [&](int k) {
    Legs l{};
    if constexpr (kStep) {
      if (live && k < k_hi) {
#pragma unroll
        for (int q = 0; q < 7; ++q) l.v[q] = T.p[q][k * R.plane + lc.h];
      }
    }
    return l;
  };
  Legs next{};
  if constexpr (kStep) next = legs_at(k_lo);
  auto buf = [](int k) { return (k + 4) & 3; };  // level k's chi buffer (k >= -1)
  auto x = [&](int k, int m, int p) -> V& { return chi_s[(buf(k) * G + m) * kPos + p]; };
  auto stage = [&](int k) {  // level k's chi at this thread's positions, as read
    const bool own = R.has(lo, k), rim = ring && R.has(lr, k);
    const V* src_o = R.chi_at(lo, k, m0 * member);
    const V* src_r = R.chi_at(lr, k, m0 * member);
    V *dst_o = &x(k, 0, pc), *dst_r = &x(k, 0, pr);
#pragma unroll 1
    for (int m = 0; m < nm; ++m, src_o += member, src_r += member, dst_o += kPos, dst_r += kPos) {
      if (own) cp_async(dst_o, src_o);
      if (rim) cp_async(dst_r, src_r);
    }
    cp_async_commit();
  };
  // Once level k has landed at this thread's positions: zero dry chi there;
  // in the step mode, where T reads chi as stored, zero only where nothing
  // was staged and record the positions' wet bits for level k's buffer
  // instead (R reads 0 where clear; set where the value is 0 anyway).
  unsigned own_bits = 0, rim_bits = 0;  // the step mode's wet bits, by buffer
  auto mask = [&](int k, const bool* wet_k) {
    bool own = !wet_k[0], rim = ring && !wet_k[1];
    if constexpr (kStep) {
      own = !R.has(lo, k), rim = ring && !R.has(lr, k);
      const unsigned bit = 1u << buf(k);
      own_bits = wet_k[0] || own ? own_bits | bit : own_bits & ~bit;
      wet_s[pc] = static_cast<unsigned char>(own_bits);
      if (ring) {
        rim_bits = wet_k[1] || rim ? rim_bits | bit : rim_bits & ~bit;
        wet_s[pr] = static_cast<unsigned char>(rim_bits);
      }
    }
#pragma unroll 1
    for (int m = 0; m < nm && (own || rim); ++m) {
      if (own) x(k, m, pc) = V(0);
      if (rim) x(k, m, pr) = V(0);
    }
  };
  const bool wet1[2] = {R.wet_at(lo, k_s + 1), R.wet_at(lr, k_s + 1)};  // for step k_s

  // Step k: dcz of level k; level k's face fluxes and divergence; dcx, dcy
  // and the top flux of level k + 1, carried in registers to the next step.
  // Without `fluxes` (above k_lo) only dcx, dcy and the top flux, from dcx,
  // dcy of 0 in the `first` step (exact at the surface, not read below it).
  // Each thread takes dcz at the positions it staged and masked, so one
  // barrier a step makes dcz (by level parity) and chi visible. Level k + 2
  // lands and is masked at the end; level k + 3 is staged, and step k + 1's
  // coefficients, which land by the step's end. The members are
  // unrolled and branch-free: a group's missing members (m >= nm) compute on
  // whatever their buffers hold and store nothing; where a face or level is
  // missing its value is computed and 0 selected, as the plain version reads.
  // The step mode adds T's sum on the same levels (its top value read before
  // the barrier, whose far side stages level k + 3 into that buffer).
  const V zero = V(0), half = V(0.5);
  V dcx[G], dcy[G], ft[G];
#pragma unroll
  for (int m = 0; m < G; ++m) dcx[m] = dcy[m] = ft[m] = zero;
  // each member's output cell: 32-bit offsets within the group (the launch
  // keeps G * member below 2^32)
  V* const out_g = out + m0 * member;
  const unsigned member32 = static_cast<unsigned>(member);
  // R's view of a value read from chi_s: itself, or in the step mode through
  // its position's mask for its level (keep)
  auto r_of = [&](unsigned m, V v) -> V {
    if constexpr (kStep) {
      return keep(m, v);
    } else {
      return v;
    }
  };
  auto step = [&](int k, bool first, bool fluxes) {
    Level<V> cur;
    if constexpr (kStaged) {
      if (fluxes) read_dz(k, cur);
    } else {
      cur = load(k);
    }
    const bool wet2[2] = {R.wet_at(lo, k + 2), R.wet_at(lr, k + 2)};
    const unsigned cell = static_cast<unsigned>(k * R.plane + lc.h);
    const V* const xu = chi_s + buf(k - 1) * G * kPos;
    const V* const x0 = chi_s + buf(k) * G * kPos;
    const V* const x1 = chi_s + buf(k + 1) * G * kPos;
    V* const dz = dcz_s + (k & 1) * G * kPos;
    V xt[kLegBytes<Leg> > 0 ? G : 1];  // T's top values: the column's level k - 1 as stored
    // the step mode's masks of this thread's positions at levels k - 1, k, k + 1
    const int bu = buf(k - 1), b0 = buf(k), b1 = buf(k + 1);
    unsigned mou = 0, mo0 = 0, mo1 = 0, mru = 0, mr0 = 0, mr1 = 0;
    if constexpr (kStep) {
      mou = keep_mask(own_bits, bu), mo0 = keep_mask(own_bits, b0);
      mo1 = keep_mask(own_bits, b1), mru = keep_mask(rim_bits, bu);
      mr0 = keep_mask(rim_bits, b0), mr1 = keep_mask(rim_bits, b1);
    }
    if (fluxes) {  // dcz at level k on this thread's positions
#pragma unroll
      for (int m = 0; m < G; ++m) {
        const int o = m * kPos;
        const V xo = r_of(mo0, x0[o + pc]), xuo = xu[o + pc];
        if constexpr (kStep) xt[m] = xuo;
        const V d_o =
            cur.czu[0] * (r_of(mou, xuo) - xo) + cur.czd[0] * (xo - r_of(mo1, x1[o + pc]));
        dz[o + pc] = lo.side < 0 ? zero : d_o;
        if (ring) {
          const V xr = r_of(mr0, x0[o + pr]);
          const V d_r = cur.czu[1] * (r_of(mru, xu[o + pr]) - xr) +
                        cur.czd[1] * (xr - r_of(mr1, x1[o + pr]));
          dz[o + pr] = lr.side < 0 ? zero : d_r;
        }
      }
    } else if (first) {
      cp_async_wait<2>();  // its coefficients and level k_s + 1
      mask(k_s + 1, wet1);
      mo1 = kStep ? keep_mask(own_bits, b1) : 0u;  // level k_s + 1's bit, just set
    }
    __syncthreads();
    if constexpr (kStaged) {
      read_rest(k, cur);
      stage_coef(k + 1);  // into step k - 1's buffer, read no more
    }
    cp_async_commit();
    if (!first) {
      stage(k + 3);  // into level k - 1's buffer, read no more
    } else {
      cp_async_commit();
    }
    // the step mode: the neighbours' masks at levels k and k + 1, and T's
    // legs at level k
    unsigned me0 = 0, mw0 = 0, mn0 = 0, ms0 = 0, me1 = 0, mw1 = 0, mn1 = 0, ms1 = 0;
    V leg[7];
    if constexpr (kStep) {
      const unsigned we = wet_s[pe], ww = wet_s[pw], wn = wet_s[pn], ws = wet_s[ps];
      me0 = keep_mask(we, b0), mw0 = keep_mask(ww, b0), mn0 = keep_mask(wn, b0);
      ms0 = keep_mask(ws, b0), me1 = keep_mask(we, b1), mw1 = keep_mask(ww, b1);
      mn1 = keep_mask(wn, b1), ms1 = keep_mask(ws, b1);
      if (fluxes) {
        const Legs l = next;
        next = legs_at(k + 1);  // in flight across this step
#pragma unroll
        for (int q = 0; q < 7; ++q) leg[q] = static_cast<V>(widen(l.v[q]));
      }
    }
    const bool below = k + 1 < nz;
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const int o = m * kPos;
      const V xc = r_of(mo0, x0[o + pc]);
      // the east and north faces of this cell; its west face is lane tx - 1's
      // east face (lane 0 takes it here), its south face is taken here
      V fe = zero, fw = zero, fn = zero, fs = zero;
      if (fluxes) {
        const V* const d = dz + o;
        fe = cur.ae * (ide * (r_of(me0, x0[o + pe]) - xc) + cur.se * (half * (d[pc] + d[pe])));
        fn = cur.an * (idn * (r_of(mn0, x0[o + pn]) - xc) + cur.sn * (half * (d[pc] + d[pn])));
        const V f_s = cur.an_s * (idn_s * (xc - r_of(ms0, x0[o + ps])) +
                                  cur.sn_s * (half * (d[ps] + d[pc])));
        const V f_w = cur.ae_w * (ide_w * (xc - r_of(mw0, x0[o + pw])) +
                                  cur.se_w * (half * (d[pw] + d[pc])));
        const V f_up = __shfl_up_sync(0xffffffffu, fe, 1);
        fs = has_s ? f_s : zero;
        fw = tx == 0 ? f_w : f_up;
      }
      // dcx, dcy and the top face flux of level k + 1, from the carried
      // dcx, dcy of level k (0 above the surface); none below the floor
      const V xb = r_of(mo1, x1[o + pc]);
      const V dcx_b =
          cur.cxe * (r_of(me1, x1[o + pe]) - xb) + cur.cxw * (xb - r_of(mw1, x1[o + pw]));
      const V dcy_b =
          cur.cyn * (r_of(mn1, x1[o + pn]) - xb) + cur.cys * (xb - r_of(ms1, x1[o + ps]));
      const V f_b = cur.at * ((cur.sti * (half * (dcx_b + dcx[m])) +
                               cur.stj * (half * (dcy_b + dcy[m]))) +
                              cur.gt * (xc - xb));
      const V ft_b = below ? f_b : zero;
      dcx[m] = dcx_b;
      dcy[m] = dcy_b;
      if (fluxes) {
        const V div = cur.invv * (((((fe - fw) + fn) - fs) + ft[m]) - ft_b);
        V* const o_m = out_g + (m * member32 + cell);
        if constexpr (kStep) {
          // T's 7-point sum on chi as stored, in K5's order, then K5's
          // rounding of chi - dt T chi and the rounding of + dt R chi
          const V xs = x0[o + pc];
          V acc = leg[0] * xs;
          acc = acc + leg[1] * x0[o + pe];
          acc = acc + leg[2] * x0[o + pw];
          acc = acc + leg[3] * x0[o + pn];
          acc = acc + leg[4] * x0[o + ps];
          acc = acc + leg[5] * xt[m];
          acc = acc + leg[6] * x1[o + pc];
          if constexpr (kApply) {
            if (live && m < nm) *o_m = acc - div;
          } else {
            const V moved = xs - dt * acc;
            if (live && m < nm) *o_m = moved + dt * div;
          }
        } else {
          if (live && m < nm) *o_m = div;
        }
      }
      ft[m] = ft_b;
    }
    cp_async_wait<1>();  // level k + 2 and step k + 1's coefficients
    mask(k + 2, wet2);
  };

  // level k_s reads 0 (level -1: above the surface); step k_s's coefficients
  // and levels k_s + 1 .. k_s + 3 go ahead
  for (int p = t; p < G * kPos; p += kThreads) chi_s[buf(k_s) * G * kPos + p] = zero;
  if constexpr (kStaged) stage_coef(k_s);
  cp_async_commit();
  for (int k = k_s + 1; k < k_s + 4; ++k) stage(k);
  step(k_s, true, false);
  if (k_s < k_lo - 1) step(k_lo - 1, false, false);
  for (int k = k_lo; k < k_hi; ++k) step(k, false, true);
}

// What a launch takes: its member group, blocks an SM, chunks of levels,
// grid and shared memory.
struct RediPlan {
  int group, per_sm, nchunks;
  dim3 grid;
  size_t bytes;
};

template <typename C, typename V, bool kShard, int G, typename Leg, bool kApply>
cudaError_t plan_group(int nmembers, int nz, int ny, int nx, RediPlan* p) {
  p->group = G;
  p->bytes = kBlockBytes<C, V, G, Leg>;
  p->grid = dim3((nx + kTI - 1) / kTI * ((nmembers + G - 1) / G), (ny + kTJ - 1) / kTJ);
  long long slots = 0;
  const cudaError_t err =
      block_slots(redi_kernel<C, V, kShard, G, Leg, kApply>, kThreads, p->bytes, &slots,
                  &p->per_sm);
  if (err != cudaSuccess) return err;
  // a staged walk alone on its SM runs faster than beside another; the
  // others stay bound by their loads' latency (measured: f32 G = 8 in two
  // chunks 0.512 -> 0.488 ms; f32 G = 4 0.290 -> 0.302 ms, f64 G = 4 0.537
  // -> 0.552 ms)
  p->nchunks = pick_chunks(static_cast<long long>(p->grid.x) * p->grid.y * p->grid.z, slots, nz,
                           staged<C, V, G, Leg> ? p->per_sm : 1);
  return cudaSuccess;
}

// The member group: the whole batch in one group up to 8 f32 members (4 in
// f64), rounded up to a power of two; groups of 8 (4) beyond; smaller where
// G members of nz * ny * nx cells would pass 2^32 (the kernel's offsets
// within a group). A shard and the matvec mode take one tracer (kOne), and
// build no other group.
template <typename V, bool kOne, typename F>
int with_group(int nmembers, long long cells, F&& f) {
  auto fits = [&](int g) { return g * cells < (1LL << 32); };
  if constexpr (!kOne) {
    if constexpr (sizeof(V) == 4) {
      if (nmembers > 4 && fits(8)) return f(std::integral_constant<int, 8>{});
    }
    if (nmembers > 2 && fits(4)) return f(std::integral_constant<int, 4>{});
    if (nmembers > 1 && fits(2)) return f(std::integral_constant<int, 2>{});
  }
  return f(std::integral_constant<int, 1>{});
}

template <typename C, typename V, typename Leg, bool kApply = false>
int plan_redi(int nmembers, int nz, int ny, int nx, int* out) {
  RediPlan p{};
  const long long cells = static_cast<long long>(nz) * ny * nx;
  const int err = with_group<V, kApply>(nmembers, cells, [&](auto g) {
    return static_cast<int>(
        plan_group<C, V, false, decltype(g)::value, Leg, kApply>(nmembers, nz, ny, nx, &p));
  });
  out[0] = p.group, out[1] = p.per_sm, out[2] = p.nchunks;
  return err;
}

// K6, K9 (kShard) or, with Leg, the step mode: out = chi - dt T chi + dt R chi;
// with kApply too, the matvec mode: out = T chi - R chi.
template <typename C, typename V, bool kShard, typename Leg = void, bool kApply = false>
int launch_redi(const void* const* fields, const void* wet, const void* chi, void* out,
                int nmembers, int nz, int ny, int nx, int north, RediHalo<C, V> h, void* stream,
                double dt = 0.0, StepLegs<Leg> legs = {}) {
  Reader<C, V, kShard> R{{}, static_cast<const unsigned char*>(wet), static_cast<const V*>(chi),
                         h, ny * nx, nz, ny, nx, north};
  for (int n = 0; n < kRediFields; ++n) R.f[n] = static_cast<const C*>(fields[n]);
  const long long cells = static_cast<long long>(nz) * ny * nx;
  if (cells >= (1LL << 31)) return cudaErrorInvalidValue;
  return with_group<V, kShard || kApply>(nmembers, cells, [&](auto g) {
    constexpr int G = decltype(g)::value;
    RediPlan p{};
    const cudaError_t err = plan_group<C, V, kShard, G, Leg, kApply>(nmembers, nz, ny, nx, &p);
    if (err != cudaSuccess) return static_cast<int>(err);
    redi_kernel<C, V, kShard, G, Leg, kApply>
        <<<dim3(p.grid.x, p.grid.y, p.nchunks), kThreads, p.bytes,
           static_cast<cudaStream_t>(stream)>>>(R, static_cast<V*>(out), nmembers, p.nchunks,
                                                static_cast<V>(dt), legs);
    return static_cast<int>(cudaGetLastError());
  });
}
// K9: K6 on one shard, one tracer (kShard), its edge neighbours in `lines`
// (RediHalo's order). Replaces otmb_tpu/parallel/redi_halo.py's
// _redi_kernel_shard, which receives derived lines. K6 derives everything
// from a one-cell ring, so K9's edge tiles fill their ring from the lines:
// on each shard K9 equals K6 on the whole field bit for bit. `n_edge`: the
// shard's last row has a north neighbour (a shard row, or the fold).
template <typename C, typename V>
int launch_redi_halo(const void* const* fields, const void* wet, const void* chi, void* out,
                     const void* const* lines, int nz, int ny, int nx, int s_edge, int n_edge,
                     void* stream) {
  auto c = [&](int n) { return static_cast<const C*>(lines[n]); };
  auto w = [&](int n) { return static_cast<const unsigned char*>(lines[n]); };
  auto v = [&](int n) { return static_cast<const V*>(lines[n]); };
  const RediHalo<C, V> h{c(0), c(1), c(2), c(3), c(4), c(5), w(6), w(7), w(8), w(9),
                         v(10), v(11), v(12), v(13), s_edge};
  return launch_redi<C, V, true>(fields, wet, chi, out, 1, nz, ny, nx, n_edge, h, stream);
}

}  // namespace otmb

#define OTMB_REDI_ENTRIES(SUFFIX, C, V)                                                         \
  OTMB_EXPORT int otmb_redi_##SUFFIX(const void* const* fields, const void* wet,               \
                                     const void* chi, void* out, int nmembers, int nz, int ny, \
                                     int nx, int tripolar, void* stream) {                     \
    return otmb::launch_redi<C, V, false>(fields, wet, chi, out, nmembers, nz, ny, nx,         \
                                          tripolar, {}, stream);                               \
  }                                                                                            \
  OTMB_EXPORT int otmb_redi_plan_##SUFFIX(int nmembers, int nz, int ny, int nx, int* plan) {   \
    return otmb::plan_redi<C, V, void>(nmembers, nz, ny, nx, plan);                            \
  }                                                                                            \
  OTMB_EXPORT int otmb_redi_halo_##SUFFIX(const void* const* fields, const void* wet,          \
                                          const void* chi, void* out, const void* const* lines, \
                                          int nz, int ny, int nx, int s_edge, int n_edge,      \
                                          void* stream) {                                      \
    return otmb::launch_redi_halo<C, V>(fields, wet, chi, out, lines, nz, ny, nx, s_edge,      \
                                        n_edge, stream);                                       \
  }

// The step mode's entries, one a (T's legs, R's coefficients, values) type
// triple that the propagations take: named after K6's entry, so that
// _build.KERNELS counts them as K6's. `legs`: T's 7 legs in K5's order.
#define OTMB_REDI_STEP_ENTRIES(SUFFIX, C, V, LSUFFIX, L)                                        \
  OTMB_EXPORT int otmb_redi_##SUFFIX##_step_##LSUFFIX(                                         \
      const void* const* fields, const void* wet, const void* const* legs, const void* chi,    \
      void* out, int nmembers, int nz, int ny, int nx, int tripolar, double dt, void* stream) { \
    otmb::StepLegs<L> T;                                                                       \
    for (int q = 0; q < 7; ++q) T.p[q] = static_cast<const L*>(legs[q]);                       \
    return otmb::launch_redi<C, V, false, L>(fields, wet, chi, out, nmembers, nz, ny, nx,      \
                                             tripolar, {}, stream, dt, T);                     \
  }                                                                                            \
  OTMB_EXPORT int otmb_redi_plan_##SUFFIX##_step_##LSUFFIX(int nmembers, int nz, int ny,       \
                                                          int nx, int* plan) {                 \
    return otmb::plan_redi<C, V, L>(nmembers, nz, ny, nx, plan);                               \
  }

// The matvec mode's entries, one tracer: out = T chi - R chi, T's 7 legs in
// K5's order with the system's shift folded into the diagonal. Named after
// K6's entry, so that _build.KERNELS counts them as K6's: f32 throughout for
// the inner solves, f64 throughout for the refinement's defects.
#define OTMB_REDI_APPLY_ENTRIES(SUFFIX, C, V, LSUFFIX, L)                                       \
  OTMB_EXPORT int otmb_redi_##SUFFIX##_apply_##LSUFFIX(                                        \
      const void* const* fields, const void* wet, const void* const* legs, const void* chi,    \
      void* out, int nz, int ny, int nx, int tripolar, void* stream) {                         \
    otmb::StepLegs<L> T;                                                                       \
    for (int q = 0; q < 7; ++q) T.p[q] = static_cast<const L*>(legs[q]);                       \
    return otmb::launch_redi<C, V, false, L, true>(fields, wet, chi, out, 1, nz, ny, nx,       \
                                                   tripolar, {}, stream, 0.0, T);              \
  }                                                                                            \
  OTMB_EXPORT int otmb_redi_plan_##SUFFIX##_apply_##LSUFFIX(int nmembers, int nz, int ny,      \
                                                           int nx, int* plan) {                \
    return otmb::plan_redi<C, V, L, true>(nmembers, nz, ny, nx, plan);                         \
  }

OTMB_REDI_ENTRIES(f32_f32, float, float)
OTMB_REDI_ENTRIES(bf16_f32, __nv_bfloat16, float)
OTMB_REDI_ENTRIES(f64_f64, double, double)
OTMB_REDI_STEP_ENTRIES(f32_f32, float, float, f32, float)
OTMB_REDI_STEP_ENTRIES(f32_f32, float, float, bf16, __nv_bfloat16)
OTMB_REDI_STEP_ENTRIES(bf16_f32, __nv_bfloat16, float, f32, float)
OTMB_REDI_STEP_ENTRIES(bf16_f32, __nv_bfloat16, float, bf16, __nv_bfloat16)
OTMB_REDI_STEP_ENTRIES(f64_f64, double, double, f32, float)
OTMB_REDI_STEP_ENTRIES(f64_f64, double, double, f64, double)
OTMB_REDI_APPLY_ENTRIES(f32_f32, float, float, f32, float)
OTMB_REDI_APPLY_ENTRIES(f64_f64, double, double, f64, double)
