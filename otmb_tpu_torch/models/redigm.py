"""Gent-McWilliams bolus velocity from density slopes.

Counterpart of `otmb_tpu.models.redigm` (reference RediGM.jl:17-79):
isoneutral slopes from vertical-face triads, slope clamping, the tanh
taper, the vertical dyad derivative of kappa_GM * S, and the bolus mass
transports added to the resolved ones, so that the transport operator
carries resolved plus eddy-induced advection. Everything follows the
device and dtype of its tensor inputs.

The GM path takes the triad slopes of the density it is given, or the
slopes it is handed (`slopes=`): those of the locally referenced potential
density (`potential_density_slopes`), which the reference's neutral
physics uses, and which `build_redi_operator` then takes too.
"""

from __future__ import annotations

import torch

from ..config import KAPPA_GM_DEFAULT, MAXSLOPE_DEFAULT, SLOPE_TAPER_SC, SLOPE_TAPER_SD
from ..grid.geometry import GridMetrics
from ..ops.derivatives import (
    vertical_dyad_derivative,
    vertical_face_triad_derivative,
    vertical_face_triad_derivative_group,
    vertical_face_triad_group_values,
)
from ..ops.velocities import velocity2fluxes
from ..utils.tracing import traced


@traced
def density_slopes(rho, gridmetrics: GridMetrics, wet3d=None):
    """Isoneutral density slopes (S_i, S_j) from vertical-face triads
    (RediGM.jl:52-53)."""
    return (vertical_face_triad_derivative(rho, gridmetrics, "i", wet3d),
            vertical_face_triad_derivative(rho, gridmetrics, "j", wet3d))


def potential_density_slope(eos, so, ct, gridmetrics: GridMetrics, direction: str,
                            wet3d=None):
    """Isoneutral slope of the locally referenced potential density
    (`localpotentialdensityslope`, RediGM.jl:17-35): for every centre cell
    `eos(so, ct, zref)` is evaluated at all 6 triad-group members with the
    centre's depth as `zref`, which removes the compressibility signal.
    `eos` is any elementwise callable, e.g. `rho_teos10`."""
    so_g = vertical_face_triad_group_values(so, gridmetrics, direction)
    ct_g = vertical_face_triad_group_values(ct, gridmetrics, direction)
    zref = gridmetrics.z3d
    vals = {tag: eos(so_g[tag], ct_g[tag], zref) for tag in so_g}
    return vertical_face_triad_derivative_group(vals, gridmetrics, direction, wet3d)


@traced
def potential_density_slopes(eos, so, ct, gridmetrics: GridMetrics, wet3d=None):
    """(S_i, S_j) from the locally referenced potential density
    (RediGM.jl:25-35)."""
    return (potential_density_slope(eos, so, ct, gridmetrics, "i", wet3d),
            potential_density_slope(eos, so, ct, gridmetrics, "j", wet3d))


def slope_taper(s_i, s_j, sc: float = SLOPE_TAPER_SC, sd: float = SLOPE_TAPER_SD):
    """The tanh taper 0.5 * (1 + tanh((Sc - |S|) / Sd)) (RediGM.jl:59-62)."""
    return 0.5 * (1.0 + torch.tanh((sc - torch.sqrt(s_i**2 + s_j**2)) / sd))


def _clamped_tapered(s_i, s_j, maxslope: float):
    """Slopes clamped to +-maxslope, then tapered (RediGM.jl:56-64); the
    GM and Redi paths share this step."""
    s_i = torch.clip(s_i, -maxslope, maxslope)
    s_j = torch.clip(s_j, -maxslope, maxslope)
    taper = slope_taper(s_i, s_j)
    return taper * s_i, taper * s_j


def _slopes(rho, gridmetrics: GridMetrics, wet3d, slopes):
    """The triad slopes the GM and Redi paths start from: `slopes` as given,
    or `density_slopes(rho)`; exactly one of the two."""
    if slopes is None:
        if rho is None:
            raise ValueError("give rho or slopes: both are None")
        return density_slopes(rho, gridmetrics, wet3d)
    if rho is not None:
        raise ValueError("give rho or slopes, not both: with slopes, rho is not used")
    return slopes


def bolus_gm_velocity(rho, gridmetrics: GridMetrics, wet3d=None,
                      kappa_gm: float = KAPPA_GM_DEFAULT, maxslope: float = MAXSLOPE_DEFAULT,
                      slopes=None):
    """GM bolus velocity (u, v) from the density field
    (`bolus_GM_velocity`, RediGM.jl:46-79): triad slopes clamped to
    +-maxslope, tapered, and u = d/dz (kappa_GM * S_i), v = d/dz
    (kappa_GM * S_j) by the vertical dyad derivative. `slopes`: the
    unclamped (S_i, S_j) in `density_slopes`' convention, in place of
    `density_slopes(rho)`; give `rho` or `slopes`, the other None."""
    s_i, s_j = _clamped_tapered(*_slopes(rho, gridmetrics, wet3d, slopes), maxslope)
    return (vertical_dyad_derivative(kappa_gm * s_i, gridmetrics, wet3d),
            vertical_dyad_derivative(kappa_gm * s_j, gridmetrics, wet3d))


@traced
def add_bolus_transports(umo, vmo, rho, gridmetrics: GridMetrics, wet3d=None,
                         kappa_gm: float = KAPPA_GM_DEFAULT,
                         maxslope: float = MAXSLOPE_DEFAULT, rho_flux=None, slopes=None):
    """(umo + bolus, vmo + bolus): the GM bolus velocity through
    `velocity2fluxes` on the default C-grid faces, NaN (land, missing
    legs) meaning no eddy transport. `rho_flux` is the density of the
    velocity-to-flux conversion (default: `rho`; a scalar is fine). `umo`
    and `vmo` may be numpy; they move to the grid's device and keep their
    dtype, which promotes with the bolus fluxes' as in the JAX package.
    `slopes`: the unclamped (S_i, S_j) as in `bolus_gm_velocity`, in place
    of `rho`'s own; `rho` still converts the velocities."""
    u_b, v_b = bolus_gm_velocity(rho if slopes is None else None, gridmetrics, wet3d,
                                 kappa_gm=kappa_gm, maxslope=maxslope, slopes=slopes)
    u_b = torch.where(torch.isfinite(u_b), u_b, 0.0)
    v_b = torch.where(torch.isfinite(v_b), v_b, 0.0)
    rho_f = rho if rho_flux is None else rho_flux
    phi_i, phi_j = velocity2fluxes(u_b, None, None, v_b, None, None, gridmetrics, rho_f,
                                   arakawa_kind="C")
    phi_i = torch.where(torch.isfinite(phi_i), phi_i, 0.0)
    phi_j = torch.where(torch.isfinite(phi_j), phi_j, 0.0)
    device = gridmetrics.v3d.device
    return (torch.as_tensor(umo, device=device) + phi_i,
            torch.as_tensor(vmo, device=device) + phi_j)
