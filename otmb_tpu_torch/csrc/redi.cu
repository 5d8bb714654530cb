// K6: the Redi isoneutral-diffusion operator, out = R chi, for one tracer
// (nz, ny, nx) or a batch (B, nz, ny, nx) that shares one read of the
// coefficients; and K9, K6 on one shard of a process grid (kShard, at the
// end). Replaces the Pallas kernels of otmb_tpu/models/redi_pallas.py
// (_redi_kernel, _redi_kernel_blocked, _redi_kernel_multi).
//
// Bound on the H100: device-memory bandwidth. Per cell it must read the 15
// coefficient fields, chi and the wet mask and write out: in f32, 68 bytes
// and one, against ~111 flops; bf16 coefficients take 38 + 1.
//
// Design: k-marching tiles. A block owns kTJ x kTI columns and a one-cell
// ring and walks k down, with four levels of chi in shared memory (staged by
// cp.async three levels ahead, masked once landed). Each quantity is computed
// once: dcz on tile and ring, the east and north face fluxes on the tile and
// its west and south ring, dcx, dcy and the top flux carried to the next
// level. A thread loads its column's coefficients into registers as its step
// starts; the other blocks of the SM (four at 64 registers in f32) hide the
// latency (measured: staging them through shared memory, or carrying a second
// register set, costs that occupancy and is slower). Where the tiles leave SMs
// idle (a shard), blocks split the levels into chunks, each walk starting two
// steps above its chunk. A batch's members share each coefficient read, as
// many as fit in half an SM per group.
//
// The accumulating entries (otmb_redi_*_acc) add alpha R chi into `out`
// instead of writing R chi: the Redi half of an explicit T + R step, after
// K5 has written chi - dt T chi there (ops/stencil.py, `redi=`). Each output
// cell is read and written by the one thread that computes it, as
// out + alpha * (R chi), two roundings as in the plain composition.
//
// Semantics are those of models/redi.py:redi_apply, the plain version: chi
// is masked by wet; i is periodic; a missing neighbour (j-1 at the south
// edge, j+1 at a bipolar north edge, k-1 at the surface, k+1 at the floor)
// or derived quantity reads 0; the tripolar north neighbour of (k, ny-1, i)
// is (k, ny-1, nx-1-i). Each value is the plain version's expression on the
// same operands in the same order, in the value type V, built without FMA
// contraction: equal bit for bit, and member b of a batch equals a single run.
#include <algorithm>

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
constexpr int kMaxAccGroup = 8;         // members a block of an accumulating entry holds
constexpr int kPI = kTI + 2;            // positions along i, with the ring
constexpr int kPos = kPI * (kTJ + 2);   // positions of the tile and its ring
constexpr int kThreads = kTI * kTJ, kPosPerThread = (kPos + kThreads - 1) / kThreads;

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
  __device__ bool wet_at(const Loc& L, int k) const {
    if (!has(L, k)) return false;
    if (kShard && L.side > 0)
      return side_of(L.side, h.wet_e, h.wet_w, h.wet_n, h.wet_s)[line(L, k)] != 0;
    return wet[k * plane + L.h] != 0;
  }
  // chi of the member at offset m at level k
  __device__ const V* chi_at(const Loc& L, int k, long long m) const {
    if (kShard && L.side > 0)
      return side_of(L.side, h.chi_e, h.chi_w, h.chi_n, h.chi_s) + line(L, k);
    return chi + m + k * plane + L.h;
  }
  // field `fi` at level k, or field `slot` of the side's coefficient lines
  __device__ V coef(const Loc& L, int fi, int slot, int k) const {
    if (!has(L, k)) return V(0);
    if (kShard && L.side > 0)
      return widen(side_of(L.side, h.east, h.west, h.north, h.south)[line(L, slot * nz + k)]);
    return widen(f[fi][k * plane + L.h]);
  }
  // inv_de or inv_dn, (ny, nx); beyond a shard's west or south edge its line
  __device__ V plane_coef(const Loc& L, int fi) const {
    if (L.side < 0) return V(0);
    if (kShard && L.side > 0) return widen((fi == kInvDe ? h.inv_de_w : h.inv_dn_s)[L.h]);
    return widen(f[fi][L.h]);
  }
};

// A thread's reads for step k: dcz weights and face coefficients at level k,
// dcx, dcy and top-face weights at k + 1, wet flags that mask level k + 2.
template <typename V>
struct Level {
  V czu[kPosPerThread], czd[kPosPerThread], ae, se, an, sn, invv, cxe, cxw, cyn, cys, at, sti,
      stj, gt, ae_w, se_w, an_s, sn_s;
  bool wet[kPosPerThread];
};

// The shard mode is held to four blocks an SM (64 registers), as K6 in f32
// compiles by itself, so that its chunks fill the SMs.
template <typename C, typename V, bool kShard, bool kAcc>
__global__ void __launch_bounds__(kThreads, kShard ? 4 : 0)
redi_kernel(Reader<C, V, kShard> R, V* __restrict__ out, int nmembers, int group, int nchunks,
            V alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = R.nz, t = threadIdx.x, tx = t % kTI, ty = t / kTI;
  const int i0 = blockIdx.x * kTI, j0 = blockIdx.y * kTJ, m0 = blockIdx.z / nchunks * group;
  const int nm = nmembers - m0 < group ? nmembers - m0 : group;
  // this block's levels [k_lo, k_hi); its walk starts two steps above (or at
  // the surface, k_s = -1) to carry in dcx, dcy and the top flux
  const int span = (nz + nchunks - 1) / nchunks, k_lo = blockIdx.z % nchunks * span;
  const int k_hi = k_lo + span < nz ? k_lo + span : nz, k_s = k_lo > 0 ? k_lo - 2 : -1;
  if (k_lo >= nz) return;
  const long long member = static_cast<long long>(R.plane) * nz;
  // shared: chi [4][group][kPos]; dcz, fe, fn [group][kPos]; dcx, dcy, 2 ft [group][kThreads]
  V* const chi_s = reinterpret_cast<V*>(smem_raw);
  V *const dcz_s = chi_s + 4 * group * kPos, *const fe_s = dcz_s + group * kPos;
  V *const fn_s = fe_s + group * kPos, *const dcx_s = fn_s + group * kPos;
  V *const dcy_s = dcx_s + group * kThreads, *const ft_s = dcy_s + group * kThreads;

  // this thread's column, its neighbours' positions, its staging positions
  const int i = i0 + tx, j = j0 + ty;
  const bool live = i < R.nx && j < R.ny;
  const bool has_s = j > 0 || (kShard && R.h.s_edge);
  const int pc = (ty + 1) * kPI + tx + 1, pe = pc + 1, pw = pc - 1, pn = pc + kPI, ps = pc - kPI;
  const Loc none{0, -1}, lc = live ? R.locate(j, i) : none;
  const Loc lw = live && tx == 0 ? R.locate(j, i - 1) : none;
  const Loc ls = live && ty == 0 && has_s ? R.locate(j - 1, i) : none;
  int pos[kPosPerThread];
  Loc lp[kPosPerThread];
#pragma unroll
  for (int q = 0; q < kPosPerThread; ++q) {
    pos[q] = t + q * kThreads < kPos ? t + q * kThreads : -1;
    lp[q] = pos[q] < 0 ? none : R.locate(j0 - 1 + pos[q] / kPI, i0 - 1 + pos[q] % kPI);
  }
  const V ide = R.plane_coef(lc, kInvDe), idn = R.plane_coef(lc, kInvDn);
  const V ide_w = R.plane_coef(lw, kInvDe), idn_s = R.plane_coef(ls, kInvDn);
  auto read_wet = [&](int k, bool* w) {
#pragma unroll
    for (int q = 0; q < kPosPerThread; ++q) w[q] = R.wet_at(lp[q], k);
  };
  auto load = [&](int k) {
    Level<V> c;
#pragma unroll
    for (int q = 0; q < kPosPerThread; ++q) {
      c.czu[q] = R.coef(lp[q], kCzu, 0, k);
      c.czd[q] = R.coef(lp[q], kCzd, 1, k);
    }
    auto own = [&](int f, int lev) { return R.coef(lc, f, 0, lev); };
    c.ae = own(kAe, k), c.se = own(kSe, k), c.an = own(kAn, k), c.sn = own(kSn, k);
    c.invv = own(kInvV, k), c.cxe = own(kCxe, k + 1), c.cxw = own(kCxw, k + 1);
    c.cyn = own(kCyn, k + 1), c.cys = own(kCys, k + 1), c.at = own(kAt, k + 1);
    c.sti = own(kSti, k + 1), c.stj = own(kStj, k + 1), c.gt = own(kGt, k + 1);
    c.ae_w = R.coef(lw, kAe, 2, k), c.se_w = R.coef(lw, kSe, 3, k);
    c.an_s = R.coef(ls, kAn, 2, k), c.sn_s = R.coef(ls, kSn, 3, k);
    read_wet(k + 2, c.wet);
    return c;
  };
  auto buf = [](int k) { return (k + 4) & 3; };  // level k's chi buffer (k >= -1)
  auto chi_m = [&](int k, int m, int p) -> V { return chi_s[(buf(k) * group + m) * kPos + p]; };
  auto stage = [&](int k) {  // level k's chi, as read
#pragma unroll
    for (int q = 0; q < kPosPerThread; ++q)
      for (int m = 0; m < nm && pos[q] >= 0 && R.has(lp[q], k); ++m)
        cp_async(chi_s + (buf(k) * group + m) * kPos + pos[q],
                 R.chi_at(lp[q], k, (m0 + m) * member));
    cp_async_commit();
  };
  auto mask = [&](int k, const bool* wet_k) {  // zero dry chi once landed: own positions
#pragma unroll
    for (int q = 0; q < kPosPerThread; ++q)
      for (int m = 0; m < nm && pos[q] >= 0 && !wet_k[q]; ++m)
        chi_s[(buf(k) * group + m) * kPos + pos[q]] = V(0);
  };
  bool wet1[kPosPerThread];  // level k_s + 1's flags, for its mask in step k_s
  read_wet(k_s + 1, wet1);

  // Step k: dcz and face fluxes of level k, dcx, dcy and the top flux of
  // level k + 1, and level k's divergence; without `fluxes` (above k_lo) only
  // dcx, dcy and the top flux, from dcx, dcy of 0 in the `first` step (exact
  // at the surface, not read below it). Level k + 2's chi lands and is
  // masked at the end; level k + 3's is staged.
  const V zero = V(0), half = V(0.5);
  auto step = [&](int k, const Level<V>& cur, bool first, bool fluxes) {
    // the accumulating entries read each member's output cell as the step
    // starts, so the load's latency hides behind the step's work
    V prior[kAcc ? kMaxAccGroup : 1];
    if constexpr (kAcc) {
      if (fluxes && live) {
#pragma unroll
        for (int m = 0; m < kMaxAccGroup; ++m)
          if (m < nm) prior[m] = out[(m0 + m) * member + k * R.plane + lc.h];
      }
    }
    if (fluxes) {  // dcz at level k on every position of the tile and its ring
#pragma unroll
      for (int q = 0; q < kPosPerThread; ++q) {
        for (int m = 0; m < nm && pos[q] >= 0; ++m) {
          const int p = pos[q];
          const V xc = chi_m(k, m, p);
          dcz_s[m * kPos + p] = lp[q].side < 0 ? zero
              : cur.czu[q] * (chi_m(k - 1, m, p) - xc) + cur.czd[q] * (xc - chi_m(k + 1, m, p));
        }
      }
    } else if (first) {
      cp_async_wait<2>();  // level k_s + 1
      mask(k_s + 1, wet1);
    }
    __syncthreads();
    if (!first) stage(k + 3);  // into level k - 1's buffer, read no more
    for (int m = 0; m < nm && live; ++m) {
      const V* dcz = dcz_s + m * kPos;
      const int slot = m * kThreads + t;
      const V xc = chi_m(k, m, pc);
      if (fluxes) {  // face fluxes: east and north of this cell, of the west / south ring
        const V xe = chi_m(k, m, pe), xn = chi_m(k, m, pn);
        fe_s[m * kPos + pc] = cur.ae * (ide * (xe - xc) + cur.se * (half * (dcz[pc] + dcz[pe])));
        fn_s[m * kPos + pc] = cur.an * (idn * (xn - xc) + cur.sn * (half * (dcz[pc] + dcz[pn])));
        if (tx == 0)
          fe_s[m * kPos + pw] = cur.ae_w * (ide_w * (xc - chi_m(k, m, pw)) +
                                            cur.se_w * (half * (dcz[pw] + dcz[pc])));
        if (ty == 0)
          fn_s[m * kPos + ps] = has_s ? cur.an_s * (idn_s * (xc - chi_m(k, m, ps)) +
                                                   cur.sn_s * (half * (dcz[ps] + dcz[pc])))
                                      : zero;
      }
      // dcx, dcy and the top face flux of level k + 1, from the carried
      // dcx, dcy of level k (0 above the surface); ft in slot (k + 1) & 1
      V ft = zero;
      if (k + 1 < nz) {
        const V xb = chi_m(k + 1, m, pc);
        const V dcx_c = first ? zero : dcx_s[slot], dcy_c = first ? zero : dcy_s[slot];
        const V dcx_b = cur.cxe * (chi_m(k + 1, m, pe) - xb) + cur.cxw * (xb - chi_m(k + 1, m, pw));
        const V dcy_b = cur.cyn * (chi_m(k + 1, m, pn) - xb) + cur.cys * (xb - chi_m(k + 1, m, ps));
        ft = cur.at * ((cur.sti * (half * (dcx_b + dcx_c)) + cur.stj * (half * (dcy_b + dcy_c))) +
                       cur.gt * (xc - xb));
        dcx_s[slot] = dcx_b;
        dcy_s[slot] = dcy_b;
      }
      ft_s[((k + 1) & 1) * group * kThreads + slot] = ft;
    }
    cp_async_wait<1>();  // level k + 2
    mask(k + 2, cur.wet);
    __syncthreads();
    auto divergence = [&](int m) {
      const V* fe = fe_s + m * kPos;
      const V* fn = fn_s + m * kPos;
      const int slot = m * kThreads + t;
      const V ft_c = ft_s[(k & 1) * group * kThreads + slot];
      const V ft_b = ft_s[((k + 1) & 1) * group * kThreads + slot];
      return cur.invv * (((((fe[pc] - fe[pw]) + fn[pc]) - fn[ps]) + ft_c) - ft_b);
    };
    if constexpr (kAcc) {  // unrolled, so that `prior` stays in registers
#pragma unroll
      for (int m = 0; m < kMaxAccGroup; ++m)
        if (m < nm && live && fluxes)
          out[(m0 + m) * member + k * R.plane + lc.h] = prior[m] + alpha * divergence(m);
    } else {
      for (int m = 0; m < nm && live && fluxes; ++m)
        out[(m0 + m) * member + k * R.plane + lc.h] = divergence(m);
    }
  };

  // level k_s reads 0 (level -1: above the surface); k_s + 1 .. k_s + 3 go ahead
  for (int p = t; p < group * kPos; p += kThreads) chi_s[buf(k_s) * group * kPos + p] = zero;
  for (int k = k_s + 1; k < k_s + 4; ++k) stage(k);
  step(k_s, load(k_s), true, false);
  if (k_s < k_lo - 1) step(k_lo - 1, load(k_lo - 1), false, false);
  for (int k = k_lo; k < k_hi; ++k) step(k, load(k), false, true);
}

template <typename C, typename V, bool kShard, bool kAcc = false>
int launch_redi(const void* const* fields, const void* wet, const void* chi, void* out,
                int nmembers, int nz, int ny, int nx, int north, RediHalo<C, V> h, void* stream,
                double alpha = 0.0) {
  Reader<C, V, kShard> R{{}, static_cast<const unsigned char*>(wet), static_cast<const V*>(chi),
                         h, ny * nx, nz, ny, nx, north};
  for (int n = 0; n < kRediFields; ++n) R.f[n] = static_cast<const C*>(fields[n]);
  if (static_cast<long long>(nz) * ny * nx >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t per_member = (7 * kPos + 4 * kThreads) * sizeof(V);
  int group = static_cast<int>(kMaxSharedBytes / 2 / per_member);
  group = group < nmembers ? group : nmembers;
  if (kAcc) group = group < kMaxAccGroup ? group : kMaxAccGroup;
  const size_t bytes = group * per_member;
  auto kernel = redi_kernel<C, V, kShard, kAcc>;
  const dim3 grid((nx + kTI - 1) / kTI, (ny + kTJ - 1) / kTJ, (nmembers + group - 1) / group);
  long long slots = 0;
  const cudaError_t err = block_slots(kernel, kThreads, bytes, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many chunks of the levels as the SMs hold tiles beyond one each
  const long long fill = slots / (grid.x * grid.y * grid.z);
  const int nchunks = static_cast<int>(std::max(1LL, std::min<long long>(fill, nz / kMinChunk)));
  kernel<<<dim3(grid.x, grid.y, grid.z * nchunks), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      R, static_cast<V*>(out), nmembers, group, nchunks, static_cast<V>(alpha));
  return static_cast<int>(cudaGetLastError());
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
  OTMB_EXPORT int otmb_redi_##SUFFIX##_acc(const void* const* fields, const void* wet,         \
                                          const void* chi, void* out, int nmembers, int nz,    \
                                          int ny, int nx, int tripolar, double alpha,          \
                                          void* stream) {                                      \
    return otmb::launch_redi<C, V, false, true>(fields, wet, chi, out, nmembers, nz, ny, nx,   \
                                                tripolar, {}, stream, alpha);                  \
  }                                                                                            \
  OTMB_EXPORT int otmb_redi_halo_##SUFFIX(const void* const* fields, const void* wet,          \
                                          const void* chi, void* out, const void* const* lines, \
                                          int nz, int ny, int nx, int s_edge, int n_edge,      \
                                          void* stream) {                                      \
    return otmb::launch_redi_halo<C, V>(fields, wet, chi, out, lines, nz, ny, nx, s_edge,      \
                                        n_edge, stream);                                       \
  }

OTMB_REDI_ENTRIES(f32_f32, float, float)
OTMB_REDI_ENTRIES(bf16_f32, __nv_bfloat16, float)
OTMB_REDI_ENTRIES(f64_f64, double, double)
