// K6: the Redi isoneutral-diffusion operator, out = R chi, for one tracer
// (nz, ny, nx) or a batch of B tracers (B, nz, ny, nx) that share one read
// of the coefficients; and K9, K6 on one shard of a process grid (the kShard
// instantiations, at the end).
//
// Replaces the Pallas kernels of otmb_tpu/models/redi_pallas.py
// (_redi_kernel, _redi_kernel_blocked, _redi_kernel_multi). The TPU
// kernels sweep k from the floor up and carry seven VMEM slabs, deferring
// each slab's divergence by one step, because a cell's top-face flux needs
// the horizontal derivatives of both slabs; at 0.25 degrees they also need
// j-blocking with side streams, and a scan for batches that overflow VMEM.
// None of that carries over: blocks run in parallel on Hopper, in no order.
//
// Design: one thread per cell, i fastest, as K1. The thread recomputes
// every intermediate it needs from neighbour reads (which the neighbouring
// threads, rows and levels read too, so they hit L1/L2): the vertical
// derivative dcz at the cell and its four horizontal neighbours, dcx and
// dcy at the cell and the levels above and below, then the six face fluxes
// f_e at the cell and its west neighbour, f_n at the cell and its south
// neighbour, f_t at the cell and the one below. No scratch fields, one
// launch. The thread reads its 43 coefficient values into registers once
// and loops over the batch's members at a 64-bit member stride
// (B * nz * ny * nx passes 2^31 at 0.25 degrees from B = 19).
//
// Bound on the H100: device-memory bandwidth. Per cell it must read the 15
// coefficient fields, chi and the wet mask and write out: in f32, 68 bytes
// and one, against ~46 flops; bf16 coefficients take 38 + 1.
//
// Semantics are those of models/redi.py:redi_apply, the plain version: every
// chi read is masked by wet; i is periodic; a missing neighbour (j-1 at the
// south edge, j+1 at a bipolar north edge, k-1 at the surface, k+1 at the
// floor) reads 0, and so does a missing derived quantity (dcz north of a
// bipolar top row, dcx and dcy above the surface, f_n south of the south
// edge, f_t below the floor), and nothing outside the field is read; the
// tripolar north neighbour of (k, ny-1, i) is (k, ny-1, nx-1-i), read
// directly. Each expression runs the plain version's operations in its
// order in the value type V, and the library is built without FMA
// contraction, so the kernel rounds where the plain version does. Member b
// of a batch runs the same code as a single tracer.
#include "common.cuh"

namespace otmb {

// The 17 coefficient fields, in the order of models/redi.py:_COEF_FIELDS.
enum RediField {
  kAe, kSe, kAn, kSn, kAt, kSti, kStj, kGt,
  kCzu, kCzd, kCxe, kCxw, kCyn, kCys,
  kInvDe, kInvDn, kInvV, kRediFields
};

template <typename C>
struct RediFields {
  const C* f[kRediFields];
};

template <typename C, typename V>
__device__ __forceinline__ V coef(const C* p, long long x) {
  return static_cast<V>(widen(p[x]));
}

// K9's lines (shard mode): what K6 reads at a shard's edge neighbours, which
// lie on other shards. Static per operator: the neighbours' dcz weights
// (cz_u, cz_d) on all four sides, the west neighbours' east faces (ae, s_e,
// inv_de) and the south neighbours' north faces (an, s_n, inv_dn), and the
// wet flags; per apply: chi. Per level, a line is (nz, ny) for the east and
// west columns and (nz, nx) for the north and south rows; the coefficient
// lines stack their fields first: east and north (2, nz, L), west and south
// (4, nz, L). The north row of the global top shard row is the fold
// partner's top row, i-reversed (tripolar), or never read (bipolar).
template <typename C, typename V>
struct RediHalo {
  const C* east;
  const C* west;
  const C* north;
  const C* south;
  const C* inv_de_w;
  const C* inv_dn_s;
  const unsigned char* wet_e;
  const unsigned char* wet_w;
  const unsigned char* wet_n;
  const unsigned char* wet_s;
  const V* chi_e;
  const V* chi_w;
  const V* chi_n;
  const V* chi_s;
  int s_edge;  // the shard's first row has a south neighbour
};

// A horizontal neighbour of a thread's cell: its offset `h` within a level
// of the whole field; in shard mode, whether it lies beyond the shard's edge
// (`far`), and then its position `pos` in the lines of length `len`.
struct Side {
  long long h;
  bool far;
  long long pos;
  long long len;
};

template <typename C, typename V, bool kShard>
__global__ void __launch_bounds__(kBlock)
redi_kernel(RediFields<C> F, const unsigned char* __restrict__ wet, const V* __restrict__ chi,
            V* __restrict__ out, int nmembers, int nz, int ny, int nx, int tripolar,
            RediHalo<C, V> h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (i >= nx) return;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long member = plane * nz;
  const bool has_t = k > 0;
  const bool has_b = k + 1 < nz;
  // shard mode: `tripolar` says whether the shard's last row has a north
  // neighbour (the next shard row, or the fold)
  const bool has_s = j > 0 || (kShard && h.s_edge);
  const bool has_n = j + 1 < ny || tripolar;

  // Offsets within a level: the cell and its east, west, north (the fold
  // at a tripolar top row) and south neighbours; then the level offsets.
  const long long row = static_cast<long long>(j) * nx;
  const long long hc = row + i;
  const long long lc = k * plane;
  const long long lt = lc - plane;
  const long long lb = lc + plane;
  const Side side_e{row + (i + 1 == nx ? 0 : i + 1), kShard && i + 1 == nx, j, ny};
  const Side side_w{row + (i == 0 ? nx - 1 : i - 1), kShard && i == 0, j, ny};
  const Side side_n{j + 1 < ny ? hc + nx : row + (nx - 1 - i), kShard && j + 1 == ny, i, nx};
  const Side side_s{hc - nx, kShard && j == 0, i, nx};
  // A neighbour's value at level offset `lo` (lc, lt or lb) of a field, or
  // beyond the shard's edge at level `lev` of its line. Outside shard mode
  // these are K6's own reads, field[lo + h].
  auto wet_at = [&](const unsigned char* line, const Side& s, long long lo, int lev) -> bool {
    if constexpr (kShard) {
      if (s.far) return line[lev * s.len + s.pos] != 0;
    }
    return wet[lo + s.h] != 0;
  };
  auto chi_at = [&](const V* x, const V* line, const Side& s, long long lo, int lev) -> V {
    if constexpr (kShard) {
      if (s.far) return line[lev * s.len + s.pos];
    }
    return x[lo + s.h];
  };
  // field `field` at level k, or field `slot` of the side's coefficient lines
  auto coef_at = [&](int field, const C* lines, int slot, const Side& s) -> V {
    if constexpr (kShard) {
      if (s.far) {
        const long long lev = static_cast<long long>(slot) * nz + k;
        return static_cast<V>(widen(lines[lev * s.len + s.pos]));
      }
    }
    return coef<C, V>(F.f[field], lc + s.h);
  };

  // Wet flags of the 15 cells the stencil reaches (false where missing).
  const bool wc = wet[lc + hc] != 0;
  const bool we = wet_at(h.wet_e, side_e, lc, k);
  const bool ww = wet_at(h.wet_w, side_w, lc, k);
  const bool wn = has_n && wet_at(h.wet_n, side_n, lc, k);
  const bool ws = has_s && wet_at(h.wet_s, side_s, lc, k);
  const bool wt = has_t && wet[lt + hc] != 0;
  const bool wte = has_t && wet_at(h.wet_e, side_e, lt, k - 1);
  const bool wtw = has_t && wet_at(h.wet_w, side_w, lt, k - 1);
  const bool wtn = has_t && has_n && wet_at(h.wet_n, side_n, lt, k - 1);
  const bool wts = has_t && has_s && wet_at(h.wet_s, side_s, lt, k - 1);
  const bool wb = has_b && wet[lb + hc] != 0;
  const bool wbe = has_b && wet_at(h.wet_e, side_e, lb, k + 1);
  const bool wbw = has_b && wet_at(h.wet_w, side_w, lb, k + 1);
  const bool wbn = has_b && has_n && wet_at(h.wet_n, side_n, lb, k + 1);
  const bool wbs = has_b && has_s && wet_at(h.wet_s, side_s, lb, k + 1);

  const V zero = V(0);
  // dcz weights at the cell and its four horizontal neighbours
  const V czu_c = coef<C, V>(F.f[kCzu], lc + hc), czd_c = coef<C, V>(F.f[kCzd], lc + hc);
  const V czu_e = coef_at(kCzu, h.east, 0, side_e), czd_e = coef_at(kCzd, h.east, 1, side_e);
  const V czu_w = coef_at(kCzu, h.west, 0, side_w), czd_w = coef_at(kCzd, h.west, 1, side_w);
  const V czu_n = has_n ? coef_at(kCzu, h.north, 0, side_n) : zero;
  const V czd_n = has_n ? coef_at(kCzd, h.north, 1, side_n) : zero;
  const V czu_s = has_s ? coef_at(kCzu, h.south, 0, side_s) : zero;
  const V czd_s = has_s ? coef_at(kCzd, h.south, 1, side_s) : zero;
  // dcx and dcy weights at the cell and the levels above and below
  const V cxe_c = coef<C, V>(F.f[kCxe], lc + hc), cxw_c = coef<C, V>(F.f[kCxw], lc + hc);
  const V cyn_c = coef<C, V>(F.f[kCyn], lc + hc), cys_c = coef<C, V>(F.f[kCys], lc + hc);
  const V cxe_t = has_t ? coef<C, V>(F.f[kCxe], lt + hc) : zero;
  const V cxw_t = has_t ? coef<C, V>(F.f[kCxw], lt + hc) : zero;
  const V cyn_t = has_t ? coef<C, V>(F.f[kCyn], lt + hc) : zero;
  const V cys_t = has_t ? coef<C, V>(F.f[kCys], lt + hc) : zero;
  const V cxe_b = has_b ? coef<C, V>(F.f[kCxe], lb + hc) : zero;
  const V cxw_b = has_b ? coef<C, V>(F.f[kCxw], lb + hc) : zero;
  const V cyn_b = has_b ? coef<C, V>(F.f[kCyn], lb + hc) : zero;
  const V cys_b = has_b ? coef<C, V>(F.f[kCys], lb + hc) : zero;
  // east faces of the cell and its west neighbour
  const V ae_c = coef<C, V>(F.f[kAe], lc + hc), se_c = coef<C, V>(F.f[kSe], lc + hc);
  const V ae_w = coef_at(kAe, h.west, 2, side_w), se_w = coef_at(kSe, h.west, 3, side_w);
  const V ide_c = coef<C, V>(F.f[kInvDe], hc);
  const V ide_w = side_w.far ? static_cast<V>(widen(h.inv_de_w[j]))
                              : coef<C, V>(F.f[kInvDe], side_w.h);
  // north faces of the cell and its south neighbour
  const V an_c = coef<C, V>(F.f[kAn], lc + hc), sn_c = coef<C, V>(F.f[kSn], lc + hc);
  const V an_s = has_s ? coef_at(kAn, h.south, 2, side_s) : zero;
  const V sn_s = has_s ? coef_at(kSn, h.south, 3, side_s) : zero;
  const V idn_c = coef<C, V>(F.f[kInvDn], hc);
  const V idn_s = !has_s       ? zero
                  : side_s.far ? static_cast<V>(widen(h.inv_dn_s[i]))
                               : coef<C, V>(F.f[kInvDn], side_s.h);
  // top faces of the cell and the one below
  const V at_c = coef<C, V>(F.f[kAt], lc + hc), sti_c = coef<C, V>(F.f[kSti], lc + hc);
  const V stj_c = coef<C, V>(F.f[kStj], lc + hc), gt_c = coef<C, V>(F.f[kGt], lc + hc);
  const V at_b = has_b ? coef<C, V>(F.f[kAt], lb + hc) : zero;
  const V sti_b = has_b ? coef<C, V>(F.f[kSti], lb + hc) : zero;
  const V stj_b = has_b ? coef<C, V>(F.f[kStj], lb + hc) : zero;
  const V gt_b = has_b ? coef<C, V>(F.f[kGt], lb + hc) : zero;
  const V invv_c = coef<C, V>(F.f[kInvV], lc + hc);
  const V half = V(0.5);

  for (int m = 0; m < nmembers; ++m) {
    const V* __restrict__ x = chi + m * member;
    // chi masked by wet, 0 where the cell is missing
    const V xc = wc ? x[lc + hc] : zero;
    const V xe = we ? chi_at(x, h.chi_e, side_e, lc, k) : zero;
    const V xw = ww ? chi_at(x, h.chi_w, side_w, lc, k) : zero;
    const V xn = wn ? chi_at(x, h.chi_n, side_n, lc, k) : zero;
    const V xs = ws ? chi_at(x, h.chi_s, side_s, lc, k) : zero;
    const V xt = wt ? x[lt + hc] : zero;
    const V xte = wte ? chi_at(x, h.chi_e, side_e, lt, k - 1) : zero;
    const V xtw = wtw ? chi_at(x, h.chi_w, side_w, lt, k - 1) : zero;
    const V xtn = wtn ? chi_at(x, h.chi_n, side_n, lt, k - 1) : zero;
    const V xts = wts ? chi_at(x, h.chi_s, side_s, lt, k - 1) : zero;
    const V xb = wb ? x[lb + hc] : zero;
    const V xbe = wbe ? chi_at(x, h.chi_e, side_e, lb, k + 1) : zero;
    const V xbw = wbw ? chi_at(x, h.chi_w, side_w, lb, k + 1) : zero;
    const V xbn = wbn ? chi_at(x, h.chi_n, side_n, lb, k + 1) : zero;
    const V xbs = wbs ? chi_at(x, h.chi_s, side_s, lb, k + 1) : zero;

    // cell-centred derivatives
    const V dcz_c = czu_c * (xt - xc) + czd_c * (xc - xb);
    const V dcz_e = czu_e * (xte - xe) + czd_e * (xe - xbe);
    const V dcz_w = czu_w * (xtw - xw) + czd_w * (xw - xbw);
    const V dcz_n = has_n ? czu_n * (xtn - xn) + czd_n * (xn - xbn) : zero;
    const V dcz_s = czu_s * (xts - xs) + czd_s * (xs - xbs);
    const V dcx_c = cxe_c * (xe - xc) + cxw_c * (xc - xw);
    const V dcy_c = cyn_c * (xn - xc) + cys_c * (xc - xs);
    const V dcx_t = has_t ? cxe_t * (xte - xt) + cxw_t * (xt - xtw) : zero;
    const V dcy_t = has_t ? cyn_t * (xtn - xt) + cys_t * (xt - xts) : zero;
    const V dcx_b = cxe_b * (xbe - xb) + cxw_b * (xb - xbw);
    const V dcy_b = cyn_b * (xbn - xb) + cys_b * (xb - xbs);

    // face fluxes: east of the cell and of its west neighbour, north of the
    // cell and of its south neighbour, top of the cell and of the one below
    const V fe_c = ae_c * (ide_c * (xe - xc) + se_c * (half * (dcz_c + dcz_e)));
    const V fe_w = ae_w * (ide_w * (xc - xw) + se_w * (half * (dcz_w + dcz_c)));
    const V fn_c = an_c * (idn_c * (xn - xc) + sn_c * (half * (dcz_c + dcz_n)));
    const V fn_s =
        has_s ? an_s * (idn_s * (xc - xs) + sn_s * (half * (dcz_s + dcz_c))) : zero;
    const V ft_c = at_c * ((sti_c * (half * (dcx_c + dcx_t)) + stj_c * (half * (dcy_c + dcy_t))) +
                           gt_c * (xt - xc));
    const V ft_b =
        has_b ? at_b * ((sti_b * (half * (dcx_b + dcx_c)) + stj_b * (half * (dcy_b + dcy_c))) +
                        gt_b * (xc - xb))
              : zero;

    out[m * member + lc + hc] = invv_c * (((((fe_c - fe_w) + fn_c) - fn_s) + ft_c) - ft_b);
  }
}

template <typename C, typename V, bool kShard>
int launch_redi(const void* const* fields, const void* wet, const void* chi, void* out,
                int nmembers, int nz, int ny, int nx, int tripolar, RediHalo<C, V> h,
                void* stream) {
  RediFields<C> F;
  for (int n = 0; n < kRediFields; ++n) F.f[n] = static_cast<const C*>(fields[n]);
  const dim3 block(kBlock);
  const dim3 grid((nx + kBlock - 1) / kBlock, ny, nz);
  redi_kernel<C, V, kShard><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const unsigned char*>(wet), static_cast<const V*>(chi), static_cast<V*>(out),
      nmembers, nz, ny, nx, tripolar, h);
  return static_cast<int>(cudaGetLastError());
}

// K9: K6 on one shard of a process grid, one tracer (kShard), with the
// shard's edge neighbours in `lines` (RediHalo above, in its field order).
//
// Replaces the Pallas kernel of otmb_tpu/parallel/redi_halo.py
// (_redi_kernel_shard). That kernel receives chi and dcz lines and the
// west and south interface fluxes, which the receiver evaluates outside the
// kernel. K6 instead recomputes every derivative and flux from reads in a
// one-cell ring (k +- 1, no diagonal neighbours), so K9 receives what K6
// reads in that ring beyond the shard's edges and runs K6's own
// expressions: on each shard K9 equals K6 on the whole field bit for bit.
// The static lines are exchanged once per operator and only chi's per
// apply: one round of messages, as in the JAX package. `n_edge` says
// whether the shard's last row has a north neighbour (a shard row above,
// or the tripolar fold). Bound and design are K6's.
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

#define OTMB_REDI_ENTRY(NAME, C, V)                                                      \
  OTMB_EXPORT int NAME(const void* const* fields, const void* wet, const void* chi,      \
                       void* out, int nmembers, int nz, int ny, int nx, int tripolar,    \
                       void* stream) {                                                   \
    return otmb::launch_redi<C, V, false>(fields, wet, chi, out, nmembers, nz, ny, nx,   \
                                          tripolar, {}, stream);                         \
  }

OTMB_REDI_ENTRY(otmb_redi_f32_f32, float, float)
OTMB_REDI_ENTRY(otmb_redi_bf16_f32, __nv_bfloat16, float)
OTMB_REDI_ENTRY(otmb_redi_f64_f64, double, double)

#define OTMB_REDI_HALO_ENTRY(NAME, C, V)                                                 \
  OTMB_EXPORT int NAME(const void* const* fields, const void* wet, const void* chi,      \
                       void* out, const void* const* lines, int nz, int ny, int nx,      \
                       int s_edge, int n_edge, void* stream) {                           \
    return otmb::launch_redi_halo<C, V>(fields, wet, chi, out, lines, nz, ny, nx, s_edge, \
                                        n_edge, stream);                                 \
  }

OTMB_REDI_HALO_ENTRY(otmb_redi_halo_f32_f32, float, float)
OTMB_REDI_HALO_ENTRY(otmb_redi_halo_bf16_f32, __nv_bfloat16, float)
OTMB_REDI_HALO_ENTRY(otmb_redi_halo_f64_f64, double, double)
