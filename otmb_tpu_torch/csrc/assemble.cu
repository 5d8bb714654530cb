// K4: fused assembly of T = Tadv + TkH + TkVML + TkVdeep from raw umo,
// vmo and v3d, in one bottom-up k sweep per column.
//
// Replaces the Pallas kernels of otmb_tpu/ops/assemble_pallas.py
// (_assembly_kernel, _assembly_kernel_blocked) and computes what they
// compute, in their operation order:
//   * sanitised, no-flux-masked east/north face fluxes; the west and south
//     faces are the i-1 and j-1 neighbours' east and north faces, which
//     each thread recomputes from their umo/vmo and wet factors;
//   * the vertical closure phi_top[k] = phi_top[k+1] + (W + S - E - N)[k],
//     carried in a register down the column (the suffix sum);
//   * upwind or centered advection with the tripolar seam's north outflux
//     (ops/coeffs.py:_advection_north_outflux), per-face masses from a
//     scalar rho or from pair means of a 3D rho;
//   * horizontal diffusion with the min-face-area rule and the seam case
//     where the far face is the fold partner's north face;
//   * mixed-layer and background vertical diffusion from per-level kappa/dz
//     rows prepared outside (ops/assemble.py).
// The surface top face (k = 0) is skipped. The tripolar partner
// (k, ny-1, nx-1-i) is read directly. The partner's face area is
// (vclean * (1/area)) * edge_north, the same expression as the cell's own
// p_n, so the min-face-area comparison sees identical roundings on both
// sides of the seam.
//
// NaN is data: land volumes are NaN. Wet tests use isnan explicitly and
// the library is never built with fast-math, which could fold them.
//
// Bound on the H100: device-memory bandwidth and L1/L2 traffic. Per cell
// it reads umo, vmo, v3d (+ rho) and writes 7 legs: 10 (11) streams, 40
// (44) bytes in f32; the neighbour reads hit lines other threads read. The
// (ny, nx) metric fields are read once per column. Design: one thread per
// (j, i) column with i fastest, the k loop inside the thread, carries
// (phi_top, the level below's wet factor and rho) in registers.
#include "common.cuh"

namespace otmb {

template <typename T>
struct Flow {
  bool upwind;
  __device__ T pos(T x) const { return upwind ? (x > T(0) ? x : T(0)) : x * T(0.5); }
  __device__ T neg(T x) const { return upwind ? -(x < T(0) ? x : T(0)) : x * T(-0.5); }
};

template <typename T>
__device__ __forceinline__ T wet_of(T v) {
  return isnan(v) ? T(0) : T(1);
}

template <typename T>
__device__ __forceinline__ T clean_of(T v) {
  return isnan(v) ? T(1) : v;
}

template <typename T>
__device__ __forceinline__ T sanitize(T x) {
  return isfinite(x) ? x : T(0);
}

// NaN-propagating minimum, as jnp.minimum / torch.minimum.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if (isnan(a) || isnan(b)) return a + b;
  return b < a ? b : a;
}

// Resident (ny, nx) fields, in the order ops/assemble.py packs them.
enum Resident { kEdgeE, kEdgeW, kEdgeN, kEdgeS, kKhdE, kKhdW, kKhdN, kKhdS, kArea, kInvArea, kMl };
// Per-level rows of kpack.
enum Level { kZupMax, kZdnMax, kUpDeep, kUpMl, kDnDeep, kDnMl, kNumLevel };

template <typename T>
__global__ void assemble_kernel(const T* __restrict__ umo, const T* __restrict__ vmo,
                                const T* __restrict__ v3d, const T* __restrict__ rho,
                                const T* __restrict__ res, const T* __restrict__ kpack,
                                T* __restrict__ out, int nz, int ny, int nx, int tripolar,
                                int upwind, T inv_rho) {
  const long long plane = static_cast<long long>(ny) * nx;
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= plane) return;
  const int j = static_cast<int>(col / nx);
  const int i = static_cast<int>(col - static_cast<long long>(j) * nx);
  const long long rowj = static_cast<long long>(j) * nx;
  const long long ce = rowj + (i + 1 == nx ? 0 : i + 1);
  const long long cw = rowj + (i == 0 ? nx - 1 : i - 1);
  const bool has_s = j > 0;
  const long long cs = has_s ? col - nx : col;
  const bool interior_n = j + 1 < ny;
  const bool has_n = interior_n || tripolar;
  // north neighbour: the next row, or the fold partner on the tripolar top row
  const long long cn = interior_n ? col + nx : rowj + (nx - 1 - i);
  const long long n3 = nz * plane;
  const Flow<T> f{upwind != 0};

  auto R = [&](int field, long long c2) { return res[field * plane + c2]; };
  const T el_e = R(kEdgeE, col), el_w = R(kEdgeW, col);
  const T el_n = R(kEdgeN, col), el_s = R(kEdgeS, col);
  const T khd_e = R(kKhdE, col), khd_w = R(kKhdW, col);
  const T khd_n = R(kKhdN, col), khd_s = R(kKhdS, col);
  const T area = R(kArea, col), inva = R(kInvArea, col), ml = R(kMl, col);
  // neighbour metric factors that enter their face areas
  const T inva_e = R(kInvArea, ce), el_w_e = R(kEdgeW, ce);
  const T inva_w = R(kInvArea, cw), el_e_w = R(kEdgeE, cw);
  const T inva_n = R(kInvArea, cn);
  const T el_nb_n = interior_n ? R(kEdgeS, cn) : R(kEdgeN, cn);  // seam: partner's north face
  const T inva_s = R(kInvArea, cs), el_n_s = R(kEdgeN, cs);

  T carry = T(0);     // phi_top[k+1]; zero at the seafloor
  T prev_wet = T(0);  // wet factor of level k+1
  T prev_rho = T(0);  // rho of level k+1 (3D-rho mode)

  for (int k = nz - 1; k >= 0; --k) {
    const long long o = k * plane;
    const T v = v3d[o + col];
    const T wetf = wet_of(v);
    const T vclean = clean_of(v);
    const T inv_v = wetf / vclean;  // exact 0 on land

    const T v_e = v3d[o + ce], v_w = v3d[o + cw];
    const T v_n = v3d[o + cn], v_s = v3d[o + cs];
    const T wetf_e = wet_of(v_e), wetf_w = wet_of(v_w);
    const T wetf_n = has_n ? wet_of(v_n) : T(0);
    const T wetf_s = has_s ? wet_of(v_s) : T(0);
    const T wetuf = k > 0 ? wet_of(v3d[o - plane + col]) : T(0);

    // --- face fluxes (velocities.jl:190-243) ---------------------------
    const T mask_e = wetf * wetf_e;
    const T mask_n = wetf * wetf_n;
    const T mask_w = wetf * wetf_w;
    const T mask_s = wetf * wetf_s;
    const T phi_e = sanitize(umo[o + col]) * mask_e;
    const T phi_n = sanitize(vmo[o + col]) * mask_n;
    const T phi_w = sanitize(umo[o + cw]) * (wetf_w * wetf);
    const T phi_s = has_s ? sanitize(vmo[o + cs]) * (wetf_s * wetf) : T(0);
    const T phi_b = carry;
    const T phi_t = phi_b + (phi_w + phi_s - phi_e - phi_n);
    carry = phi_t;
    const T not_surf = k > 0 ? T(1) : T(0);

    // --- advection legs (matrixbuilding.jl:226-299) ---------------------
    const T in_e = f.neg(phi_e), in_w = f.pos(phi_w);
    const T in_n = f.neg(phi_n), in_s = f.pos(phi_s);
    const T in_b = f.pos(phi_b);
    const T in_t = not_surf * f.neg(phi_t);
    T out_n;
    if (interior_n) {
      out_n = f.pos(phi_n);
    } else if (tripolar) {
      // the fold partner receives through its own north face
      out_n = f.neg(sanitize(vmo[o + cn]) * (wetf_n * wetf));
    } else {
      out_n = T(0);
    }

    T im_e, im_w, im_n, im_s, im_t, im_b, adv_diag;
    if (rho != nullptr) {
      const T half = T(0.5);
      const T rho_c = rho[o + col];
      const T rho_n = has_n ? rho[o + cn] : T(1);
      const T rho_up = k > 0 ? rho[o - plane + col] : rho_c;
      im_e = inv_v / ((rho_c + rho[o + ce]) * half);
      im_w = inv_v / ((rho_c + rho[o + cw]) * half);
      im_n = inv_v / ((rho_c + rho_n) * half);
      im_s = inv_v / ((rho_c + rho[o + cs]) * half);
      im_t = inv_v / ((rho_c + rho_up) * half);
      im_b = inv_v / ((rho_c + prev_rho) * half);
      prev_rho = rho_c;
      adv_diag = f.pos(phi_e) * im_e + f.neg(phi_w) * im_w + f.neg(phi_s) * im_s +
                 out_n * im_n + f.neg(phi_b) * im_b + not_surf * f.pos(phi_t) * im_t;
    } else {
      const T inv_m = inv_v * inv_rho;
      im_e = im_w = im_n = im_s = im_t = im_b = inv_m;
      const T out_sum = f.pos(phi_e) + f.neg(phi_w) + f.neg(phi_s) + out_n + f.neg(phi_b) +
                        not_surf * f.pos(phi_t);
      adv_diag = out_sum * inv_m;
    }

    // --- horizontal diffusion (matrixbuilding.jl:337-418) ---------------
    const T thk = vclean * inva;
    const T p_e = thk * el_e, p_w = thk * el_w, p_n = thk * el_n, p_s = thk * el_s;
    const T a_nb_e = (clean_of(v_e) * inva_e) * el_w_e;
    const T a_nb_w = (clean_of(v_w) * inva_w) * el_e_w;
    const T a_nb_n = has_n ? (clean_of(v_n) * inva_n) * el_nb_n : T(0);
    const T a_nb_s = has_s ? (clean_of(v_s) * inva_s) * el_n_s : p_n;
    const T tv_e = nan_min(p_e, a_nb_e) * khd_e * inv_v * mask_e;
    const T tv_w = nan_min(p_w, a_nb_w) * khd_w * inv_v * mask_w;
    const T tv_n = nan_min(p_n, a_nb_n) * khd_n * inv_v * mask_n;
    const T tv_s = nan_min(p_s, a_nb_s) * khd_s * inv_v * mask_s;

    // --- vertical diffusion (matrixbuilding.jl:438-479) -----------------
    const T* lv = kpack + k * kNumLevel;
    const T om_up = lv[kZupMax] < ml ? T(1) : T(0);
    const T om_dn = lv[kZdnMax] < ml ? T(1) : T(0);
    const T a_over_v = area * inv_v;
    const T tot_up = a_over_v * (lv[kUpDeep] + lv[kUpMl] * om_up) * (wetf * wetuf);
    const T tot_dn = a_over_v * (lv[kDnDeep] + lv[kDnMl] * om_dn) * (wetf * prev_wet);
    prev_wet = wetf;

    // --- the seven legs, in StencilCoeffs order -------------------------
    T* o_c = out + o + col;
    o_c[0 * n3] = adv_diag + tv_e + tv_w + tv_n + tv_s + tot_up + tot_dn;
    o_c[1 * n3] = -(in_e * im_e) - tv_e;
    o_c[2 * n3] = -(in_w * im_w) - tv_w;
    o_c[3 * n3] = -(in_n * im_n) - tv_n;
    o_c[4 * n3] = -(in_s * im_s) - tv_s;
    o_c[5 * n3] = -(in_t * im_t) - tot_up;
    o_c[6 * n3] = -(in_b * im_b) - tot_dn;
  }
}

template <typename T>
int launch_assemble(const void* umo, const void* vmo, const void* v3d, const void* rho,
                    const void* res, const void* kpack, void* out, int nz, int ny, int nx,
                    int tripolar, int upwind, double inv_rho, void* stream) {
  const long long plane = static_cast<long long>(ny) * nx;
  assemble_kernel<T><<<blocks_for(plane), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(umo), static_cast<const T*>(vmo), static_cast<const T*>(v3d),
      static_cast<const T*>(rho), static_cast<const T*>(res), static_cast<const T*>(kpack),
      static_cast<T*>(out), nz, ny, nx, tripolar, upwind, static_cast<T>(inv_rho));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace otmb

OTMB_EXPORT int otmb_assemble_f32(const void* umo, const void* vmo, const void* v3d,
                                  const void* rho, const void* res, const void* kpack, void* out,
                                  int nz, int ny, int nx, int tripolar, int upwind, double inv_rho,
                                  void* stream) {
  return otmb::launch_assemble<float>(umo, vmo, v3d, rho, res, kpack, out, nz, ny, nx, tripolar,
                                      upwind, inv_rho, stream);
}

OTMB_EXPORT int otmb_assemble_f64(const void* umo, const void* vmo, const void* v3d,
                                  const void* rho, const void* res, const void* kpack, void* out,
                                  int nz, int ny, int nx, int tripolar, int upwind, double inv_rho,
                                  void* stream) {
  return otmb::launch_assemble<double>(umo, vmo, v3d, rho, res, kpack, out, nz, ny, nx, tripolar,
                                       upwind, inv_rho, stream);
}
