// K4: fused assembly of T = Tadv + TkH + TkVML + TkVdeep from raw umo,
// vmo and v3d; and K8, the same on one shard of a process grid (the kShard
// instantiations, at the end); and the prep entry that writes their
// resident fields and per-level rows.
//
// Replaces the Pallas kernels of otmb_tpu/ops/assemble_pallas.py
// (_assembly_kernel, _assembly_kernel_blocked) and computes what they
// compute, in their operation order:
//   * sanitised, no-flux-masked east/north face fluxes; the west and south
//     faces are the i-1 and j-1 neighbours' east and north faces, which
//     each thread recomputes from their umo/vmo and wet factors;
//   * the vertical closure phi_top[k] = phi_top[k+1] + (W + S - E - N)[k],
//     carried in a register up the column from the floor (the suffix sum);
//   * upwind or centered advection with the tripolar seam's north outflux
//     (ops/coeffs.py:_advection_north_outflux), per-face masses from a
//     scalar rho or from pair means of a 3D rho;
//   * horizontal diffusion with the min-face-area rule and the seam case
//     where the far face is the fold partner's north face;
//   * mixed-layer and background vertical diffusion from per-level kappa/dz
//     rows (the prep entry, below, or ops/assemble.py's plain version).
// The surface top face (k = 0) is skipped. The tripolar partner
// (k, ny-1, nx-1-i) is read directly. The partner's face area is
// (vclean * (1/area)) * edge_north, the same expression as the cell's own
// p_n, so the min-face-area comparison sees identical roundings on both
// sides of the seam.
//
// NaN is data: land volumes are NaN. Wet tests use isnan explicitly and
// the library is never built with fast-math, which could fold them.
//
// Bound on the H100: device-memory bandwidth. Per cell it reads umo, vmo,
// v3d (+ rho) and writes 7 legs: 10 (11) streams, 40 (44) bytes in f32;
// the neighbour reads hit lines other threads read. The (ny, nx) metric
// fields are read once per column. The TPU kernel carried the suffix sum
// through a sequential grid of k planes. Design: one thread per (j, i)
// column with i fastest, the k loop inside the thread, unrolled by two so
// that two levels' loads are in flight; it carries (phi_top, the level
// below's wet factor and rho) in registers. The walk is latency-bound where
// columns are few (about 1.3 waves of blocks at 1 degree, 47 % of the
// bound; 61 % at 0.25 degrees). A cell-parallel design (tiles of 32 x 4
// columns, the divergences and their suffix sums in shared memory, the legs
// over (level, column)) was measured slower on the whole field at 1 and
// 0.25 degrees, since it reads each cell's neighbours twice, and faster only
// on a shard's few columns (PERF.md); the walk was kept.
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

// K8's lines (shard mode): what K4 reads at a shard's edge neighbours, which
// lie on other shards. Per level, (F, nz, ny) for the east and west columns
// and (F, nz, nx) for the north and south rows, fields v3d, the transport
// (umo for columns, vmo for rows) and, in 3D-rho mode, rho; per column or
// row, (2, ny) or (2, nx) resident fields 1/area and the edge length that
// enters the neighbour's face area (the east neighbour's west edge, the west
// neighbour's east edge, the north neighbour's south edge or, across the
// tripolar fold, its north edge, the south neighbour's north edge). The
// north row of the global top shard row is the fold partner's top row,
// i-reversed (tripolar), or zeros (bipolar, never read).
template <typename T>
struct AssembleHalo {
  const T* east;
  const T* west;
  const T* north;
  const T* south;
  const T* res_east;
  const T* res_west;
  const T* res_north;
  const T* res_south;
  int s_edge;      // the shard's first row has a south neighbour
  int n_interior;  // the shard's last row has a north neighbour that is not the fold
};

// NaN-propagating maximum, as torch.maximum (the first NaN operand).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a < b ? b : a;
}

template <typename T>
__device__ __forceinline__ T largest();
template <>
__device__ __forceinline__ float largest<float>() { return 3.402823466e+38f; }
template <>
__device__ __forceinline__ double largest<double>() { return 1.7976931348623157e+308; }

// The prep entry: K4's resident fields (11, ny, nx) and per-level rows
// (nz, 6), one thread per (j, i) column and one per level, in one launch.
// The expressions are those of ops/assemble.py:_residents and _levels, its
// plain version, in the same type: kappa rounded to T before it divides,
// IEEE divisions (a correctly rounded 1/area), nan_to_num's replacements
// (0 for NaN, the largest finite value for an infinity), isfinite tests.
template <typename T>
__global__ void assemble_prep_kernel(const T* __restrict__ el_e, const T* __restrict__ el_w,
                                     const T* __restrict__ el_n, const T* __restrict__ el_s,
                                     const T* __restrict__ d_e, const T* __restrict__ d_w,
                                     const T* __restrict__ d_n, const T* __restrict__ d_s,
                                     const T* __restrict__ area, const T* __restrict__ ml,
                                     const T* __restrict__ zt, T* __restrict__ res,
                                     T* __restrict__ levels, int nz, long long plane,
                                     T kappa_h, T kappa_vml, T kappa_vdeep) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < plane) {
    auto khd = [&](T d) { return isfinite(d) ? kappa_h / d : T(0); };
    const T a = area[t];
    res[kEdgeE * plane + t] = el_e[t];
    res[kEdgeW * plane + t] = el_w[t];
    res[kEdgeN * plane + t] = el_n[t];
    res[kEdgeS * plane + t] = el_s[t];
    res[kKhdE * plane + t] = khd(d_e[t]);
    res[kKhdW * plane + t] = khd(d_w[t]);
    res[kKhdN * plane + t] = khd(d_n[t]);
    res[kKhdS * plane + t] = khd(d_s[t]);
    res[kArea * plane + t] = isnan(a) ? T(0) : isinf(a) ? (a > T(0) ? largest<T>() : -largest<T>()) : a;
    res[kInvArea * plane + t] = isfinite(a) ? T(1) / a : T(0);
    res[kMl * plane + t] = ml[t];
  } else if (t < plane + nz) {
    const int k = static_cast<int>(t - plane);
    const T inf = static_cast<T>(INFINITY);
    const T z = zt[k];
    const T dz_up = k > 0 ? fabs(z - zt[k - 1]) : inf;
    const T dz_dn = k + 1 < nz ? fabs(z - zt[k + 1]) : inf;
    T* lv = levels + static_cast<long long>(k) * kNumLevel;
    lv[kZupMax] = k > 0 ? nan_max(z, zt[k - 1]) : inf;
    lv[kZdnMax] = k + 1 < nz ? nan_max(z, zt[k + 1]) : inf;
    lv[kUpDeep] = kappa_vdeep / dz_up;
    lv[kUpMl] = kappa_vml / dz_up;
    lv[kDnDeep] = kappa_vdeep / dz_dn;
    lv[kDnMl] = kappa_vml / dz_dn;
  }
}

template <typename T>
int launch_assemble_prep(const void* const* fields, void* res, void* levels, int nz, int ny,
                         int nx, double kappa_h, double kappa_vml, double kappa_vdeep,
                         void* stream) {
  const long long plane = static_cast<long long>(ny) * nx;
  auto F = [&](int n) { return static_cast<const T*>(fields[n]); };
  assemble_prep_kernel<T><<<blocks_for(plane + nz), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      F(0), F(1), F(2), F(3), F(4), F(5), F(6), F(7), F(8), F(9), F(10), static_cast<T*>(res),
      static_cast<T*>(levels), nz, plane, static_cast<T>(kappa_h), static_cast<T>(kappa_vml),
      static_cast<T>(kappa_vdeep));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kShard>
__global__ void assemble_kernel(const T* __restrict__ umo, const T* __restrict__ vmo,
                                const T* __restrict__ v3d, const T* __restrict__ rho,
                                const T* __restrict__ res, const T* __restrict__ kpack,
                                T* __restrict__ out, int nz, int ny, int nx, int tripolar,
                                int upwind, T inv_rho, AssembleHalo<T> h) {
  const long long plane = static_cast<long long>(ny) * nx;
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= plane) return;
  const int j = static_cast<int>(col / nx);
  const int i = static_cast<int>(col - static_cast<long long>(j) * nx);
  const long long rowj = static_cast<long long>(j) * nx;
  const long long ce = rowj + (i + 1 == nx ? 0 : i + 1);
  const long long cw = rowj + (i == 0 ? nx - 1 : i - 1);
  const bool has_s = j > 0 || (kShard && h.s_edge);
  const long long cs = j > 0 ? col - nx : col;
  const bool interior_n = j + 1 < ny || (kShard && h.n_interior);
  const bool has_n = interior_n || tripolar;
  // north neighbour: the next row, or the fold partner on the tripolar top row
  const long long cn = j + 1 < ny ? col + nx : rowj + (nx - 1 - i);
  const long long n3 = nz * plane;
  const Flow<T> f{upwind != 0};
  // Shard mode: which neighbours lie beyond the shard's edges, and where
  // they are in the lines (`slot` counts the fields of a line).
  const bool far_e = kShard && i + 1 == nx;
  const bool far_w = kShard && i == 0;
  const bool far_n = kShard && j + 1 == ny;
  const bool far_s = kShard && j == 0 && h.s_edge;
  auto at = [&](const T* lines, int slot, int lev, long long len, long long pos) {
    return lines[(static_cast<long long>(slot) * nz + lev) * len + pos];
  };
  auto line_e = [&](int slot, int lev) { return at(h.east, slot, lev, ny, j); };
  auto line_w = [&](int slot, int lev) { return at(h.west, slot, lev, ny, j); };
  auto line_n = [&](int slot, int lev) { return at(h.north, slot, lev, nx, i); };
  auto line_s = [&](int slot, int lev) { return at(h.south, slot, lev, nx, i); };

  auto R = [&](int field, long long c2) { return res[field * plane + c2]; };
  const T el_e = R(kEdgeE, col), el_w = R(kEdgeW, col);
  const T el_n = R(kEdgeN, col), el_s = R(kEdgeS, col);
  const T khd_e = R(kKhdE, col), khd_w = R(kKhdW, col);
  const T khd_n = R(kKhdN, col), khd_s = R(kKhdS, col);
  const T area = R(kArea, col), inva = R(kInvArea, col), ml = R(kMl, col);
  // neighbour metric factors that enter their face areas
  const T inva_e = far_e ? h.res_east[j] : R(kInvArea, ce);
  const T el_w_e = far_e ? h.res_east[ny + j] : R(kEdgeW, ce);
  const T inva_w = far_w ? h.res_west[j] : R(kInvArea, cw);
  const T el_e_w = far_w ? h.res_west[ny + j] : R(kEdgeE, cw);
  const T inva_n = far_n ? h.res_north[i] : R(kInvArea, cn);
  // seam: the partner's north face
  const T el_nb_n = far_n ? h.res_north[nx + i] : interior_n ? R(kEdgeS, cn) : R(kEdgeN, cn);
  const T inva_s = far_s ? h.res_south[i] : R(kInvArea, cs);
  const T el_n_s = far_s ? h.res_south[nx + i] : R(kEdgeN, cs);

  T carry = T(0);     // phi_top[k+1]; zero at the seafloor
  T prev_wet = T(0);  // wet factor of level k+1
  T prev_rho = T(0);  // rho of level k+1 (3D-rho mode)

  // two levels' loads in flight per thread
#pragma unroll 2
  for (int k = nz - 1; k >= 0; --k) {
    const long long o = k * plane;
    const T v = v3d[o + col];
    const T wetf = wet_of(v);
    const T vclean = clean_of(v);
    const T inv_v = wetf / vclean;  // exact 0 on land

    const T v_e = far_e ? line_e(0, k) : v3d[o + ce];
    const T v_w = far_w ? line_w(0, k) : v3d[o + cw];
    const T v_n = far_n ? line_n(0, k) : v3d[o + cn];
    const T v_s = far_s ? line_s(0, k) : v3d[o + cs];
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
    const T phi_w = sanitize(far_w ? line_w(1, k) : umo[o + cw]) * (wetf_w * wetf);
    const T phi_s = has_s ? sanitize(far_s ? line_s(1, k) : vmo[o + cs]) * (wetf_s * wetf) : T(0);
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
      out_n = f.neg(sanitize(far_n ? line_n(1, k) : vmo[o + cn]) * (wetf_n * wetf));
    } else {
      out_n = T(0);
    }

    T im_e, im_w, im_n, im_s, im_t, im_b, adv_diag;
    if (rho != nullptr) {
      const T half = T(0.5);
      const T rho_c = rho[o + col];
      const T rho_n = has_n ? (far_n ? line_n(2, k) : rho[o + cn]) : T(1);
      const T rho_up = k > 0 ? rho[o - plane + col] : rho_c;
      im_e = inv_v / ((rho_c + (far_e ? line_e(2, k) : rho[o + ce])) * half);
      im_w = inv_v / ((rho_c + (far_w ? line_w(2, k) : rho[o + cw])) * half);
      im_n = inv_v / ((rho_c + rho_n) * half);
      im_s = inv_v / ((rho_c + (far_s ? line_s(2, k) : rho[o + cs])) * half);
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

template <typename T, bool kShard>
int launch_assemble(const void* umo, const void* vmo, const void* v3d, const void* rho,
                    const void* res, const void* kpack, void* out, int nz, int ny, int nx,
                    int tripolar, int upwind, double inv_rho, AssembleHalo<T> h, void* stream) {
  const long long plane = static_cast<long long>(ny) * nx;
  assemble_kernel<T, kShard>
      <<<blocks_for(plane), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(umo), static_cast<const T*>(vmo), static_cast<const T*>(v3d),
          static_cast<const T*>(rho), static_cast<const T*>(res), static_cast<const T*>(kpack),
          static_cast<T*>(out), nz, ny, nx, tripolar, upwind, static_cast<T>(inv_rho), h);
  return static_cast<int>(cudaGetLastError());
}

// K8: K4 on one shard of a process grid (kShard), with the shard's edge
// neighbours in the lines of `lines` (east, west, north, south per level,
// then their resident fields; AssembleHalo above).
//
// Replaces the Pallas kernel of otmb_tpu/parallel/assemble_halo.py
// (_assembly_kernel_shard). That kernel receives derived lines (masked
// fluxes, wet factors, face areas, the seam outflux) and rebuilds K4's
// shifts from them. K4 instead recomputes its west and south faces and the
// neighbours' face areas from the neighbours' raw inputs, so K8 receives
// those raw inputs and runs K4's own expressions on them: every value K4
// reads at a cell of the whole field, K8 reads at the same cell of its
// shard, and K8 equals K4 bit for bit by construction. Bound and design are
// K4's; the lines add 2-3 values per level and edge cell.
template <typename T>
int launch_assemble_halo(const void* umo, const void* vmo, const void* v3d, const void* rho,
                         const void* res, const void* kpack, void* out, const void* const* lines,
                         int nz, int ny, int nx, int tripolar, int upwind, double inv_rho,
                         int s_edge, int n_interior, void* stream) {
  auto L = [&](int n) { return static_cast<const T*>(lines[n]); };
  const AssembleHalo<T> h{L(0), L(1), L(2), L(3), L(4), L(5), L(6), L(7), s_edge, n_interior};
  return launch_assemble<T, true>(umo, vmo, v3d, rho, res, kpack, out, nz, ny, nx, tripolar,
                                  upwind, inv_rho, h, stream);
}

}  // namespace otmb

#define OTMB_ASSEMBLE_ENTRY(NAME, T)                                                         \
  OTMB_EXPORT int NAME(const void* umo, const void* vmo, const void* v3d, const void* rho,   \
                       const void* res, const void* kpack, void* out, int nz, int ny, int nx, \
                       int tripolar, int upwind, double inv_rho, void* stream) {             \
    return otmb::launch_assemble<T, false>(umo, vmo, v3d, rho, res, kpack, out, nz, ny, nx,  \
                                           tripolar, upwind, inv_rho, {}, stream);           \
  }

OTMB_ASSEMBLE_ENTRY(otmb_assemble_f32, float)
OTMB_ASSEMBLE_ENTRY(otmb_assemble_f64, double)

// fields: edge lengths E, W, N, S; distances E, W, N, S; area; mlotst; zt.
#define OTMB_ASSEMBLE_PREP_ENTRY(NAME, T)                                                    \
  OTMB_EXPORT int NAME(const void* const* fields, void* res, void* levels, int nz, int ny,   \
                       int nx, double kappa_h, double kappa_vml, double kappa_vdeep,         \
                       void* stream) {                                                       \
    return otmb::launch_assemble_prep<T>(fields, res, levels, nz, ny, nx, kappa_h,           \
                                         kappa_vml, kappa_vdeep, stream);                    \
  }

OTMB_ASSEMBLE_PREP_ENTRY(otmb_assemble_prep_f32, float)
OTMB_ASSEMBLE_PREP_ENTRY(otmb_assemble_prep_f64, double)

#define OTMB_ASSEMBLE_HALO_ENTRY(NAME, T)                                                    \
  OTMB_EXPORT int NAME(const void* umo, const void* vmo, const void* v3d, const void* rho,   \
                       const void* res, const void* kpack, void* out,                        \
                       const void* const* lines, int nz, int ny, int nx, int tripolar,       \
                       int upwind, double inv_rho, int s_edge, int n_interior,               \
                       void* stream) {                                                       \
    return otmb::launch_assemble_halo<T>(umo, vmo, v3d, rho, res, kpack, out, lines, nz, ny, \
                                         nx, tripolar, upwind, inv_rho, s_edge, n_interior,  \
                                         stream);                                            \
  }

OTMB_ASSEMBLE_HALO_ENTRY(otmb_assemble_halo_f32, float)
OTMB_ASSEMBLE_HALO_ENTRY(otmb_assemble_halo_f64, double)
