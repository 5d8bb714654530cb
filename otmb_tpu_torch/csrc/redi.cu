// K6: the Redi isoneutral-diffusion operator, out = R chi, for one tracer
// (nz, ny, nx) or a batch of B tracers (B, nz, ny, nx) that share one read
// of the coefficients.
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

template <typename C, typename V>
__global__ void __launch_bounds__(kBlock)
redi_kernel(RediFields<C> F, const unsigned char* __restrict__ wet, const V* __restrict__ chi,
            V* __restrict__ out, int nmembers, int nz, int ny, int nx, int tripolar) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int k = blockIdx.z;
  if (i >= nx) return;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long member = plane * nz;
  const bool has_t = k > 0;
  const bool has_b = k + 1 < nz;
  const bool has_s = j > 0;
  const bool has_n = j + 1 < ny || tripolar;

  // Offsets within a level: the cell and its east, west, north (the fold
  // at a tripolar top row) and south neighbours; then the level offsets.
  const long long row = static_cast<long long>(j) * nx;
  const long long hc = row + i;
  const long long he = row + (i + 1 == nx ? 0 : i + 1);
  const long long hw = row + (i == 0 ? nx - 1 : i - 1);
  const long long hn = j + 1 < ny ? hc + nx : row + (nx - 1 - i);
  const long long hs = hc - nx;
  const long long lc = k * plane;
  const long long lt = lc - plane;
  const long long lb = lc + plane;

  // Wet flags of the 15 cells the stencil reaches (false where missing).
  const bool wc = wet[lc + hc] != 0;
  const bool we = wet[lc + he] != 0;
  const bool ww = wet[lc + hw] != 0;
  const bool wn = has_n && wet[lc + hn] != 0;
  const bool ws = has_s && wet[lc + hs] != 0;
  const bool wt = has_t && wet[lt + hc] != 0;
  const bool wte = has_t && wet[lt + he] != 0;
  const bool wtw = has_t && wet[lt + hw] != 0;
  const bool wtn = has_t && has_n && wet[lt + hn] != 0;
  const bool wts = has_t && has_s && wet[lt + hs] != 0;
  const bool wb = has_b && wet[lb + hc] != 0;
  const bool wbe = has_b && wet[lb + he] != 0;
  const bool wbw = has_b && wet[lb + hw] != 0;
  const bool wbn = has_b && has_n && wet[lb + hn] != 0;
  const bool wbs = has_b && has_s && wet[lb + hs] != 0;

  const V zero = V(0);
  // dcz weights at the cell and its four horizontal neighbours
  const V czu_c = coef<C, V>(F.f[kCzu], lc + hc), czd_c = coef<C, V>(F.f[kCzd], lc + hc);
  const V czu_e = coef<C, V>(F.f[kCzu], lc + he), czd_e = coef<C, V>(F.f[kCzd], lc + he);
  const V czu_w = coef<C, V>(F.f[kCzu], lc + hw), czd_w = coef<C, V>(F.f[kCzd], lc + hw);
  const V czu_n = has_n ? coef<C, V>(F.f[kCzu], lc + hn) : zero;
  const V czd_n = has_n ? coef<C, V>(F.f[kCzd], lc + hn) : zero;
  const V czu_s = has_s ? coef<C, V>(F.f[kCzu], lc + hs) : zero;
  const V czd_s = has_s ? coef<C, V>(F.f[kCzd], lc + hs) : zero;
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
  const V ae_w = coef<C, V>(F.f[kAe], lc + hw), se_w = coef<C, V>(F.f[kSe], lc + hw);
  const V ide_c = coef<C, V>(F.f[kInvDe], hc), ide_w = coef<C, V>(F.f[kInvDe], hw);
  // north faces of the cell and its south neighbour
  const V an_c = coef<C, V>(F.f[kAn], lc + hc), sn_c = coef<C, V>(F.f[kSn], lc + hc);
  const V an_s = has_s ? coef<C, V>(F.f[kAn], lc + hs) : zero;
  const V sn_s = has_s ? coef<C, V>(F.f[kSn], lc + hs) : zero;
  const V idn_c = coef<C, V>(F.f[kInvDn], hc);
  const V idn_s = has_s ? coef<C, V>(F.f[kInvDn], hs) : zero;
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
    const V xe = we ? x[lc + he] : zero;
    const V xw = ww ? x[lc + hw] : zero;
    const V xn = wn ? x[lc + hn] : zero;
    const V xs = ws ? x[lc + hs] : zero;
    const V xt = wt ? x[lt + hc] : zero;
    const V xte = wte ? x[lt + he] : zero;
    const V xtw = wtw ? x[lt + hw] : zero;
    const V xtn = wtn ? x[lt + hn] : zero;
    const V xts = wts ? x[lt + hs] : zero;
    const V xb = wb ? x[lb + hc] : zero;
    const V xbe = wbe ? x[lb + he] : zero;
    const V xbw = wbw ? x[lb + hw] : zero;
    const V xbn = wbn ? x[lb + hn] : zero;
    const V xbs = wbs ? x[lb + hs] : zero;

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

template <typename C, typename V>
int launch_redi(const void* const* fields, const void* wet, const void* chi, void* out,
                int nmembers, int nz, int ny, int nx, int tripolar, void* stream) {
  RediFields<C> F;
  for (int n = 0; n < kRediFields; ++n) F.f[n] = static_cast<const C*>(fields[n]);
  const dim3 block(kBlock);
  const dim3 grid((nx + kBlock - 1) / kBlock, ny, nz);
  redi_kernel<C, V><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      F, static_cast<const unsigned char*>(wet), static_cast<const V*>(chi), static_cast<V*>(out),
      nmembers, nz, ny, nx, tripolar);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

#define OTMB_REDI_ENTRY(NAME, C, V)                                                      \
  OTMB_EXPORT int NAME(const void* const* fields, const void* wet, const void* chi,      \
                       void* out, int nmembers, int nz, int ny, int nx, int tripolar,    \
                       void* stream) {                                                   \
    return otmb::launch_redi<C, V>(fields, wet, chi, out, nmembers, nz, ny, nx, tripolar, \
                                   stream);                                              \
  }

OTMB_REDI_ENTRY(otmb_redi_f32_f32, float, float)
OTMB_REDI_ENTRY(otmb_redi_bf16_f32, __nv_bfloat16, float)
OTMB_REDI_ENTRY(otmb_redi_f64_f64, double, double)
