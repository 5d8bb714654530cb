"""The transport-operator front door: T = Tadv + TkH + TkVML + TkVdeep.

Counterpart of `otmb_tpu.models.transport` and the reference
`transportmatrix` (matrixbuilding.jl:128-150), with the same physics
defaults. Each component can be passed in pre-built, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import KAPPA_H_DEFAULT, KAPPA_VDEEP_DEFAULT, KAPPA_VML_DEFAULT, RHO_DEFAULT
from ..grid.geometry import GridMetrics
from ..grid.indices import Indices
from ..ops.coeffs import (
    StencilCoeffs,
    add_coeffs,
    advection_coeffs,
    horizontal_diffusion_coeffs,
    mixed_layer_mask,
    vertical_diffusion_coeffs,
)
from ..ops.fluxes import FaceFluxes, facefluxes


@dataclasses.dataclass(frozen=True)
class TransportOperators:
    """The total operator and its four components (matrixbuilding.jl:149)."""

    T: StencilCoeffs
    Tadv: StencilCoeffs
    TkH: StencilCoeffs
    TkVML: StencilCoeffs
    TkVdeep: StencilCoeffs


def _as_grid(x, gridmetrics: GridMetrics) -> torch.Tensor:
    v3d = gridmetrics.v3d
    return torch.as_tensor(x, dtype=v3d.dtype, device=v3d.device)


def _checked(c: StencilCoeffs, name: str) -> StencilCoeffs:
    """NaN guard, as the reference's `any(isnan.(Tvals)) && error`
    (matrixbuilding.jl:39,61,90,114)."""
    for leg, arr in zip(c._fields, c):
        if not bool(torch.isfinite(arr).all()):
            raise FloatingPointError(f"{name}.{leg} contains non-finite values")
    return c


def buildTadv(*, phi: FaceFluxes, gridmetrics: GridMetrics, indices: Indices,
              rho=RHO_DEFAULT, upwind: bool = True) -> StencilCoeffs:
    """Advection operator (reference buildTadv, matrixbuilding.jl:31-44)."""
    c = advection_coeffs(phi, gridmetrics, indices.wet3d, rho, upwind=upwind)
    return _checked(c, "Tadv")


def buildTkH(*, gridmetrics: GridMetrics, indices: Indices,
             kappa_h=KAPPA_H_DEFAULT) -> StencilCoeffs:
    """Horizontal diffusion (reference buildTkappaH, matrixbuilding.jl:51-66)."""
    return _checked(horizontal_diffusion_coeffs(gridmetrics, indices.wet3d, kappa_h), "TkH")


def buildTkVML(*, mlotst, gridmetrics: GridMetrics, indices: Indices,
               kappa_vml=KAPPA_VML_DEFAULT) -> StencilCoeffs:
    """Mixed-layer vertical diffusion, active where zt[k] < mlotst
    (reference buildTkappaVML, matrixbuilding.jl:74-95)."""
    omega = mixed_layer_mask(gridmetrics, _as_grid(mlotst, gridmetrics))
    c = vertical_diffusion_coeffs(gridmetrics, indices.wet3d, kappa_vml, omega)
    return _checked(c, "TkVML")


def buildTkVdeep(*, gridmetrics: GridMetrics, indices: Indices,
                 kappa_vdeep=KAPPA_VDEEP_DEFAULT) -> StencilCoeffs:
    """Background vertical diffusion over the whole ocean (reference
    buildTkappaVdeep, matrixbuilding.jl:103-120)."""
    c = vertical_diffusion_coeffs(gridmetrics, indices.wet3d, kappa_vdeep, None)
    return _checked(c, "TkVdeep")


def assemble_transport(umo, vmo, mlotst, gridmetrics: GridMetrics, wet3d,
                       rho=RHO_DEFAULT, kappa_h=KAPPA_H_DEFAULT,
                       kappa_vml=KAPPA_VML_DEFAULT, kappa_vdeep=KAPPA_VDEEP_DEFAULT,
                       upwind: bool = True) -> TransportOperators:
    """Raw transports -> all operators, from plain tensors (no `Indices`).
    Same physics as `transportmatrix`, without its NaN guard. `rho` is a
    scalar or a (nz, ny, nx) tensor."""
    wet3d = wet3d.to(torch.bool)
    phi = facefluxes(_as_grid(umo, gridmetrics), _as_grid(vmo, gridmetrics),
                     wet3d, gridmetrics.topology)
    Tadv = advection_coeffs(phi, gridmetrics, wet3d, rho, upwind=upwind)
    TkH = horizontal_diffusion_coeffs(gridmetrics, wet3d, kappa_h)
    omega = mixed_layer_mask(gridmetrics, _as_grid(mlotst, gridmetrics))
    TkVML = vertical_diffusion_coeffs(gridmetrics, wet3d, kappa_vml, omega)
    TkVdeep = vertical_diffusion_coeffs(gridmetrics, wet3d, kappa_vdeep, None)
    T = add_coeffs(Tadv, TkH, TkVML, TkVdeep)
    return TransportOperators(T=T, Tadv=Tadv, TkH=TkH, TkVML=TkVML, TkVdeep=TkVdeep)


def transportmatrix(*, phi: FaceFluxes, mlotst, gridmetrics: GridMetrics,
                    indices: Indices, rho=RHO_DEFAULT, kappa_h=KAPPA_H_DEFAULT,
                    kappa_vml=KAPPA_VML_DEFAULT, kappa_vdeep=KAPPA_VDEEP_DEFAULT,
                    Tadv: StencilCoeffs | None = None, TkH: StencilCoeffs | None = None,
                    TkVML: StencilCoeffs | None = None,
                    TkVdeep: StencilCoeffs | None = None,
                    upwind: bool = True) -> TransportOperators:
    """The flux-divergence operator T (units 1/s, d(chi)/dt = -T chi), with
    the signature and defaults of the reference `transportmatrix`."""
    if Tadv is None:
        Tadv = buildTadv(phi=phi, gridmetrics=gridmetrics, indices=indices,
                         rho=rho, upwind=upwind)
    if TkH is None:
        TkH = buildTkH(gridmetrics=gridmetrics, indices=indices, kappa_h=kappa_h)
    if TkVML is None:
        TkVML = buildTkVML(mlotst=mlotst, gridmetrics=gridmetrics, indices=indices,
                           kappa_vml=kappa_vml)
    if TkVdeep is None:
        TkVdeep = buildTkVdeep(gridmetrics=gridmetrics, indices=indices,
                               kappa_vdeep=kappa_vdeep)
    T = add_coeffs(Tadv, TkH, TkVML, TkVdeep)
    return TransportOperators(T=T, Tadv=Tadv, TkH=TkH, TkVML=TkVML, TkVdeep=TkVdeep)
