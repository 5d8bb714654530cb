"""Redi isoneutral diffusion as a matrix-free conservative operator.

Counterpart of `otmb_tpu.models.redi`: the small-slope Redi tensor
(Redi 1982) with slopes from the same triads, clamp and taper as the GM
path (RediGM.jl:52-64),

    K = kappa * [[1,   0,   Sx ],
                 [0,   1,   Sy ],
                 [Sx,  Sy,  S^2]]        (coordinates x, y, zeta=height)

    d(chi)/dt = div(K grad chi),

discretised as one flux per face (+x on east faces, +y on north faces, up
on top faces), added to its cell and subtracted from the neighbour. So the
volume integral is conserved to rounding, across the periodic boundary and
the tripolar seam (the cross term is disabled on seam faces, where the j
orientation flips), and constants lie in the null space.

`build_redi_operator` folds every mask, NaN guard and distance into 17
chi-independent coefficient fields; `redi_apply` is then a branch-free
19-point stencil of multiply-adds, and the plain version of the CUDA
kernel K6 (`models/redi_kernel.py`). The propagations compose it with the
7-point operator, dchi/dt = -T chi + R chi, as
`euler_propagate_multi(T, chis, dt, nsteps, topo, redi=R)` (and
`euler_propagate`): one launch of K6's step mode a step on the card (README,
quick start).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import KAPPA_GM_DEFAULT, MAXSLOPE_DEFAULT
from ..grid.geometry import GridMetrics
from ..grid.topology import GridTopology, neighbor_valid, neighbor_values
from ..utils.tracing import traced
from .redigm import _clamped_tapered, _slopes

#: The 17 coefficient fields of the operator, in the order the kernel takes
#: them: 15 of shape (nz, ny, nx), `inv_de` and `inv_dn` of (ny, nx). `wet`
#: and the topology are not numeric streams and keep their types.
_COEF_FIELDS = (
    "ae", "s_e", "an", "s_n", "at", "s_ti", "s_tj", "g_t",
    "cz_u", "cz_d", "cx_e", "cx_w", "cy_n", "cy_s",
    "inv_de", "inv_dn", "inv_v",
)


def _safe(x):
    return torch.where(torch.isfinite(x), x, 0.0)


@dataclasses.dataclass(frozen=True)
class RediOperator:
    """Face geometry, tapered slopes and derivative weights, in linear-
    coefficient form: the cell-centred derivatives are

        dc/dzeta = cz_u * (chi_up - chi) + cz_d * (chi - chi_dn)

    with the one-sided estimates' weights (the NaN-aware mean of dyads.jl)
    and 1/distance folded in. Every `a*` face factor is exactly 0 on faces
    that touch land or the domain boundary (no-flux boundaries)."""

    ae: torch.Tensor  # east faces: kappa * A
    s_e: torch.Tensor  # east-face slope S_x
    an: torch.Tensor  # north faces: kappa * A
    s_n: torch.Tensor
    at: torch.Tensor  # top faces: kappa * A
    s_ti: torch.Tensor  # top-face S_x
    s_tj: torch.Tensor  # top-face S_y
    g_t: torch.Tensor  # top faces: (S_x^2 + S_y^2) / dz
    cz_u: torch.Tensor  # weights of the cell-centred derivatives
    cz_d: torch.Tensor
    cx_e: torch.Tensor
    cx_w: torch.Tensor
    cy_n: torch.Tensor
    cy_s: torch.Tensor
    inv_de: torch.Tensor  # (ny, nx) 1 / centre-to-east-neighbour distance
    inv_dn: torch.Tensor  # (ny, nx) 1 / centre-to-north-neighbour distance
    inv_v: torch.Tensor  # 1/V on wet cells, 0 on land
    wet: torch.Tensor  # bool
    topology: GridTopology

    def to(self, *args, **kwargs) -> "RediOperator":
        """Every coefficient field through `torch.Tensor.to`; `wet` follows
        their device."""
        fields = {k: getattr(self, k).to(*args, **kwargs) for k in _COEF_FIELDS}
        return dataclasses.replace(self, **fields, wet=self.wet.to(fields["ae"].device))


@traced
def build_redi_operator(rho, gridmetrics: GridMetrics, wet3d,
                        kappa_redi: float = KAPPA_GM_DEFAULT,
                        maxslope: float = MAXSLOPE_DEFAULT, slopes=None) -> RediOperator:
    """Precompute geometry and density slopes for the Redi operator from
    `rho` or from `slopes`, the other None: the unclamped triad slopes
    (S_i, S_j) in `density_slopes`' convention, such as
    `potential_density_slopes`', in place of `density_slopes(rho)`
    (`add_bolus_transports` takes the same). The fields follow the device
    of the grid metrics and the promoted dtype of the slopes and the
    metrics (`.to(dtype)` casts them)."""
    gm = gridmetrics
    topo = gm.topology
    wet = torch.as_tensor(wet3d, device=gm.v3d.device).to(torch.bool)
    ny = topo.ny
    nb = lambda x, d, fill=float("nan"): neighbor_values(x, d, topo, fill=fill)

    # Cell-centred isoneutral slopes, clamped and tapered (RediGM.jl:56-64).
    # The triad gives rho_x / rho_zeta; the slope of the rotated tensor is
    # S_x = -rho_x / rho_zeta.
    s_i, s_j = (_safe(-s) for s in _slopes(rho, gm, wet, slopes))
    s_i, s_j = _clamped_tapered(s_i, s_j, maxslope)

    def face_mean(x, direction):
        return 0.5 * (x + _safe(nb(x, direction)))

    # --- east faces ---
    e_wet = wet & nb(wet, "east", False)
    thk_e = torch.minimum(gm.thkcello, nb(gm.thkcello, "east"))
    area_e = torch.where(e_wet, thk_e * gm.edge_length.east, 0.0)
    ae = kappa_redi * _safe(area_e)
    s_e = torch.where(e_wet, face_mean(s_i, "east"), 0.0)

    # --- north faces ---
    n_wet = wet & nb(wet, "north", False) & neighbor_valid("north", topo, device=wet.device)
    thk_n = torch.minimum(gm.thkcello, nb(gm.thkcello, "north"))
    area_n = torch.where(n_wet, thk_n * gm.edge_length.north, 0.0)
    an = kappa_redi * _safe(area_n)
    s_n = torch.where(n_wet, face_mean(s_j, "north"), 0.0)
    if topo.is_tripolar:
        # Across the seam the j orientation flips, which would break the
        # antisymmetric pairing of the cross term: disable it there (the
        # horizontal part remains and pairs exactly).
        seam_mask = torch.ones((1, ny, 1), dtype=torch.bool, device=wet.device)
        seam_mask[:, ny - 1] = False
        s_n = torch.where(seam_mask, s_n, 0.0)

    # --- top faces (between each cell and the one above) ---
    t_wet = wet & nb(wet, "top", False)
    z = gm.z3d
    dz_up = torch.abs(nb(z, "top") - z)
    dz_up_safe = torch.where(t_wet, dz_up, 1.0)
    b_wet = wet & nb(wet, "bottom", False)
    dz_dn = torch.abs(nb(z, "bottom") - z)
    dz_dn_safe = torch.where(torch.isfinite(dz_dn), dz_dn, 1.0)
    at = torch.where(t_wet, kappa_redi * gm.area2d, 0.0)
    s_ti = torch.where(t_wet, face_mean(s_i, "top"), 0.0)
    s_tj = torch.where(t_wet, face_mean(s_j, "top"), 0.0)
    g_t = (s_ti**2 + s_tj**2) / dz_up_safe

    # --- cell-centred derivative weights (chi-independent) ---
    # dcz = cz_u*(chi_up - chi) + cz_d*(chi - chi_dn): the NaN-aware mean of
    # the one-sided estimates, weight 1 only where both cells of the leg
    # are wet (and the neighbour exists), 1/distance folded in.
    dist = gm.distance_to_neighbour

    def deriv_weights(w_fwd, d_fwd, w_bwd, d_bwd):
        wf = w_fwd & torch.isfinite(d_fwd)
        wb = w_bwd & torch.isfinite(d_bwd)
        den = torch.clamp_min(wf.to(at.dtype) + wb.to(at.dtype), 1.0)
        cf = torch.where(wf, 1.0 / (den * torch.where(wf, d_fwd, 1.0)), 0.0)
        cb = torch.where(wb, 1.0 / (den * torch.where(wb, d_bwd, 1.0)), 0.0)
        return cf, cb

    w_wet = wet & nb(wet, "west", False)
    s_wetm = wet & nb(wet, "south", False) & neighbor_valid("south", topo, device=wet.device)
    cz_u, cz_d = deriv_weights(t_wet, dz_up_safe, b_wet, dz_dn_safe)
    cx_e, cx_w = deriv_weights(e_wet, dist.east, w_wet, dist.west)
    cy_n, cy_s = deriv_weights(n_wet, dist.north, s_wetm, dist.south)

    return RediOperator(
        ae=ae, s_e=s_e, an=an, s_n=s_n,
        at=at, s_ti=s_ti, s_tj=s_tj, g_t=g_t,
        cz_u=cz_u, cz_d=cz_d, cx_e=cx_e, cx_w=cx_w, cy_n=cy_n, cy_s=cy_s,
        inv_de=_safe(1.0 / dist.east),
        inv_dn=_safe(1.0 / dist.north),
        inv_v=torch.where(wet, 1.0 / gm.v3d, 0.0),
        wet=wet,
        topology=topo,
    )


def redi_apply(op: RediOperator, chi: torch.Tensor) -> torch.Tensor:
    """d(chi)/dt of Redi isoneutral diffusion (chi/s), the plain version of
    K6. `chi` is (nz, ny, nx) or a batch (B, nz, ny, nx): every step
    broadcasts over the leading axis. chi is masked by `wet` first; a
    missing neighbour reads 0."""
    topo = op.topology
    chi = torch.where(op.wet, chi, 0.0)

    nb = lambda x, d: neighbor_values(x, d, topo, fill=0.0)
    chi_e, chi_w = nb(chi, "east"), nb(chi, "west")
    chi_n, chi_s = nb(chi, "north"), nb(chi, "south")
    chi_u, chi_d = nb(chi, "top"), nb(chi, "bottom")

    # Cell-centred derivatives (the weights carry masks and 1/distance).
    dcz = op.cz_u * (chi_u - chi) + op.cz_d * (chi - chi_d)
    dcx = op.cx_e * (chi_e - chi) + op.cx_w * (chi - chi_w)
    dcy = op.cy_n * (chi_n - chi) + op.cy_s * (chi - chi_s)

    # east-face flux (+x)
    dcz_e = 0.5 * (dcz + nb(dcz, "east"))
    f_e = op.ae * (op.inv_de * (chi_e - chi) + op.s_e * dcz_e)
    # north-face flux (+y; the seam's cross term is disabled by s_n = 0)
    dcz_n = 0.5 * (dcz + nb(dcz, "north"))
    f_n = op.an * (op.inv_dn * (chi_n - chi) + op.s_n * dcz_n)
    # top-face flux (+zeta, upward)
    dcx_t = 0.5 * (dcx + nb(dcx, "top"))
    dcy_t = 0.5 * (dcy + nb(dcy, "top"))
    f_t = op.at * (op.s_ti * dcx_t + op.s_tj * dcy_t + op.g_t * (chi_u - chi))

    # Divergence: + the cell's own faces, - the shared faces owned by the
    # west, south and lower neighbours.
    return op.inv_v * (f_e - nb(f_e, "west") + f_n - nb(f_n, "south") + f_t - nb(f_t, "bottom"))


def vertical_legs(op: RediOperator, dtype: torch.dtype | None = None):
    """R's pure vertical legs: the g_t term of its top-face flux,
    at g_t (chi_up - chi), as one tridiagonal operator a column,

        (R_v chi)_k = upper_k chi_(k-1) + diag_k chi_k + lower_k chi_(k+1),

    upper = inv_v at g_t of the cell's top face, lower = inv_v at g_t of its
    bottom face (the top face of the cell below), diag = -(upper + lower);
    0 where a face touches land or the domain's ends. In `dtype` (the
    fields' own by default). The steady-state solves' Thomas
    preconditioner takes them off T's vertical legs (`models.solvers`)."""
    dtype = dtype or op.at.dtype
    at, g_t, inv_v = (getattr(op, k).to(dtype) for k in ("at", "g_t", "inv_v"))
    w = at * g_t
    upper = inv_v * w
    lower = inv_v * neighbor_values(w, "bottom", op.topology, fill=0.0)
    return upper, -(upper + lower), lower


def redi_max_rate(op: RediOperator) -> float:
    """A bound on R's infinity norm (1/s), so on its spectral radius:
    max |R chi| <= redi_max_rate(R) * max |chi|. Each face flux is bounded
    by its weights' magnitudes, each chi difference by 2 max |chi|, and
    each cell sums its six faces. An explicit step of chi' = -T chi + R chi
    is stable for dt well below 1 / (max|diag T| + redi_max_rate(R))."""
    op = op.to(torch.float64)
    nb = lambda x, d: neighbor_values(x, d, op.topology, fill=0.0)
    c_z = op.cz_u.abs() + op.cz_d.abs()  # |dcz| <= 2 c_z max|chi|
    c_x = op.cx_e.abs() + op.cx_w.abs()
    c_y = op.cy_n.abs() + op.cy_s.abs()
    f_e = op.ae.abs() * (2 * op.inv_de.abs() + op.s_e.abs() * (c_z + nb(c_z, "east")))
    f_n = op.an.abs() * (2 * op.inv_dn.abs() + op.s_n.abs() * (c_z + nb(c_z, "north")))
    f_t = op.at.abs() * (op.s_ti.abs() * (c_x + nb(c_x, "top"))
                         + op.s_tj.abs() * (c_y + nb(c_y, "top")) + 2 * op.g_t.abs())
    rate = op.inv_v.abs() * (f_e + nb(f_e, "west") + f_n + nb(f_n, "south")
                             + f_t + nb(f_t, "bottom"))
    return float(rate.max())


def redi_operator_to_bf16(op: RediOperator) -> RediOperator:
    """The coefficient fields in bfloat16 (mixed precision): half the
    coefficient traffic of K6, which widens them to the tracer's f32 in
    registers, so the tracer arithmetic stays f32."""
    return op.to(torch.bfloat16)
