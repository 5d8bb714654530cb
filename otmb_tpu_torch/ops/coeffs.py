"""Transport-operator assembly as dense stencil coefficients.

T is seven dense (nz, ny, nx) coefficient tensors, one per stencil leg:

    (T @ chi)[c] = diag[c] * chi[c] + sum_d coef[d][c] * chi[neighbor_d(c)]

Semantics mirror `otmb_tpu.ops.coeffs` and the reference
(matrixbuilding.jl:226-479): the donor-side diagonal of the advection
scheme is written in cell-local form, except across the tripolar seam,
where the receiver uses its own north flux (`_advection_north_outflux`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..grid.geometry import GridMetrics
from ..grid.topology import DIRECTIONS, GridTopology, fold_i, neighbor_valid, neighbor_values
from .fluxes import FaceFluxes


class StencilCoeffs(NamedTuple):
    """T as seven dense legs in (nz, ny, nx) layout. `east[c]` multiplies
    chi at c's east neighbour; `top` is the k-1 leg, `bottom` the k+1 leg.
    Units 1/s. Entries are exactly 0 on land and across missing
    neighbours."""

    diag: torch.Tensor
    east: torch.Tensor
    west: torch.Tensor
    north: torch.Tensor
    south: torch.Tensor
    top: torch.Tensor
    bottom: torch.Tensor

    def __getitem__(self, key):
        if isinstance(key, str):
            return getattr(self, key)
        return tuple.__getitem__(self, key)

    def to(self, *args, **kwargs) -> "StencilCoeffs":
        """Every leg through `torch.Tensor.to`."""
        return StencilCoeffs(*(leg.to(*args, **kwargs) for leg in self))


def add_coeffs(*cs: StencilCoeffs) -> StencilCoeffs:
    """Sum of operators (the reference's sparse `+`, matrixbuilding.jl:147)."""
    return StencilCoeffs(*(sum(legs) for legs in zip(*cs)))


def _pair_mean_rho(rho, direction, topology):
    """(rho_c + rho_neighbour)/2 per face; scalar rho passes through
    (matrixbuilding.jl:194,207-214)."""
    if not isinstance(rho, torch.Tensor) or rho.ndim == 0:
        return rho
    return 0.5 * (rho + neighbor_values(rho, direction, topology))


def _safe_div(num, den):
    """num/den where num != 0, exact 0 elsewhere (masked faces carry
    exactly-zero fluxes, and their masses may be NaN)."""
    nz = num != 0
    den = torch.as_tensor(den, dtype=num.dtype, device=num.device)
    return torch.where(nz, num, 0.0) / torch.where(nz, den, 1.0)


def advection_coeffs(phi: FaceFluxes, gridmetrics: GridMetrics, wet3d, rho,
                     upwind: bool = True) -> StencilCoeffs:
    """Advection operator Tadv (`advection_operator_sparse_entries`,
    matrixbuilding.jl:226-299): upwind or centered flux divergence, surface
    top face skipped (matrixbuilding.jl:290), per-face masses
    m = mean(rho_c, rho_nb) * v."""
    topo = gridmetrics.topology
    v3d = gridmetrics.v3d
    wet = wet3d.to(torch.bool)
    not_surface = (torch.arange(topo.nz, device=v3d.device) > 0).reshape(topo.nz, 1, 1)

    if upwind:
        pos = lambda x: torch.clamp(x, min=0.0)
        neg = lambda x: -torch.clamp(x, max=0.0)
    else:
        pos = lambda x: x / 2
        neg = lambda x: -x / 2

    # Receiver-side influx magnitude ("From <dir>" branches,
    # matrixbuilding.jl:244-296).
    influx = {
        "west": pos(phi.west),
        "east": neg(phi.east),
        "south": pos(phi.south),
        "north": neg(phi.north),
        "bottom": pos(phi.bottom),
        "top": torch.where(not_surface, neg(phi.top), 0.0),
    }
    # Donor-side outflux through each face of c (adds +phi/m_c to diag[c]).
    outflux = {
        "east": pos(phi.east),
        "west": neg(phi.west),
        "south": neg(phi.south),
        "north": _advection_north_outflux(phi.north, topo, pos, neg),
        "bottom": neg(phi.bottom),
        # surface top outflow is evaporation: no diagonal term
        "top": torch.where(not_surface, pos(phi.top), 0.0),
    }

    coefs = {}
    diag = torch.zeros_like(v3d)
    for d in DIRECTIONS:
        m = _pair_mean_rho(rho, d, topo) * v3d
        coefs[d] = -_safe_div(influx[d], m)
        diag = diag + _safe_div(outflux[d], m)

    mask = lambda x: torch.where(wet, x, 0.0)
    return StencilCoeffs(diag=mask(diag), **{d: mask(coefs[d]) for d in DIRECTIONS})


def _advection_north_outflux(phi_north, topo: GridTopology, pos, neg):
    """Donor-side flux for the north face: pos(phi.north) on interior rows;
    on the tripolar top row the folded neighbour receives through its own
    north face, neg(fold_i(phi.north)). Bipolar top-row fluxes are zero."""
    interior = pos(phi_north)
    if not topo.is_tripolar:
        return interior
    seam = neg(fold_i(phi_north[..., -1:, :]))
    return torch.cat([interior[..., :-1, :], seam], dim=-2)


def horizontal_diffusion_coeffs(gridmetrics: GridMetrics, wet3d, kappa_h) -> StencilCoeffs:
    """Horizontal diffusion TkappaH (matrixbuilding.jl:337-418): interface
    area = min of the two directed face areas, distance = centre-to-centre
    haversine, Tval = kappa * a / (d * V). Across the tripolar seam the far
    face is the folded cell's north face (matrixbuilding.jl:405-409)."""
    topo = gridmetrics.topology
    v3d = gridmetrics.v3d
    thk = gridmetrics.thkcello
    wet = wet3d.to(torch.bool)
    opposite_2d = {"east": "west", "west": "east", "south": "north", "north": "south"}

    diag = torch.zeros_like(v3d)
    coefs = {}
    for d in ("east", "west", "north", "south"):
        a_own = thk * gridmetrics.edge_length[d]
        a_nb = neighbor_values(thk * gridmetrics.edge_length[opposite_2d[d]], d, topo)
        if d == "north" and topo.is_tripolar:
            seam = fold_i((thk * gridmetrics.edge_length["north"])[..., -1:, :])
            a_nb = torch.cat([a_nb[..., :-1, :], seam], dim=-2)

        a = torch.minimum(a_own, a_nb)
        dist = gridmetrics.distance_to_neighbour[d]
        nb_wet = neighbor_values(wet, d, topo, fill=False) & neighbor_valid(
            d, topo, device=wet.device)
        active = wet & nb_wet
        a_clean = torch.where(active, a, 0.0)
        denom = torch.where(active, dist * v3d, 1.0)
        tval = kappa_h * a_clean / denom
        coefs[d] = -tval
        diag = diag + tval

    zeros = torch.zeros_like(v3d)
    return StencilCoeffs(diag=diag, top=zeros, bottom=zeros, **coefs)


def vertical_diffusion_coeffs(gridmetrics: GridMetrics, wet3d, kappa_v,
                              omega=None) -> StencilCoeffs:
    """Vertical diffusion (matrixbuilding.jl:438-479): a = area2D,
    d = |zt[k] - zt[k']|, Tval = kappa * a / (d * V); both cells inside
    the mask `omega` (None: the whole ocean)."""
    topo = gridmetrics.topology
    v3d = gridmetrics.v3d
    wet = wet3d.to(torch.bool)
    nz = topo.nz
    active_cell = wet if omega is None else (wet & omega.to(torch.bool))

    zt = gridmetrics.zt.reshape(nz, 1, 1)
    dz_up = torch.abs(zt - neighbor_values(zt, "top", topo))
    dz_dn = torch.abs(zt - neighbor_values(zt, "bottom", topo))
    area = gridmetrics.area2d

    m_up = active_cell & neighbor_values(active_cell, "top", topo, fill=False)
    m_dn = active_cell & neighbor_values(active_cell, "bottom", topo, fill=False)
    ones = torch.ones_like(v3d)
    a_up = torch.where(m_up, area * ones, 0.0)
    a_dn = torch.where(m_dn, area * ones, 0.0)
    tval_up = kappa_v * a_up / torch.where(m_up, dz_up * v3d, 1.0)
    tval_dn = kappa_v * a_dn / torch.where(m_dn, dz_dn * v3d, 1.0)

    zeros = torch.zeros_like(v3d)
    return StencilCoeffs(diag=tval_up + tval_dn, east=zeros, west=zeros,
                         north=zeros, south=zeros, top=-tval_up, bottom=-tval_dn)


def mixed_layer_mask(gridmetrics: GridMetrics, mlotst: torch.Tensor) -> torch.Tensor:
    """Omega for the mixed-layer diffusivity: zt[k] < mlotst[j,i]; NaN
    mlotst (land) is False (matrixbuilding.jl:85)."""
    nz = gridmetrics.topology.nz
    zt = gridmetrics.zt.reshape(nz, 1, 1)
    return torch.isfinite(mlotst) & (zt < mlotst)
