"""Hydrography for the neutral-physics cells: `thetao` and `so` of a raw
case, made from the seed as the case is.

The case (`case.py`) carries no temperature or salinity, and CMIP's would
come with ACCESS-ESM1-5's bathymetry, which the case does not have. So the
fields are drawn from the case's generator after its draws (from a copy of
it, so the case's generator stays where it is and every call gives the same
fields): a few amplitudes and phases of a smooth ocean with the structure
the neutral physics acts on:

  * a surface mixed layer 25-120 m deep (deepest at high latitudes), with
    a weak vertical gradient (1e-4 C/m): isopycnals nearly vertical there,
    so the slopes are clamped at `maxslope` and the taper switches them off;
  * a thermocline under it whose e-folding depth tilts with latitude
    (100 m at the equator, up to ~600 m at mid latitudes), so isopycnals
    slope by 1e-4 to a few 1e-3: the range the tanh taper passes;
  * deep water that keeps a fraction of the surface anomaly, decaying over
    1200 m, stably stratified everywhere;
  * salinity fresher towards the poles in the upper ocean.

Conservative Temperature in C, Absolute Salinity in g/kg (polyTEOS10-bsq's
variables), computed in float64 on the case's device and stored as
float32, NaN on land, as CMIP stores them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ML_GRADIENT = 1e-4  # C/m inside the mixed layer
DEEP_SCALE = 1200.0  # m, the deep water's decay


def hydrography(case) -> tuple[torch.Tensor, torch.Tensor]:
    """(thetao, so) of the case: (nz, ny, nx) float32 on its device, NaN on
    land. Draws from a copy of `case.rng`, after the case's draws."""
    rng = np.random.default_rng()
    rng.bit_generator.state = case.rng.bit_generator.state
    t_eq, t_pole = rng.uniform(26.0, 29.0), rng.uniform(-1.0, 1.5)
    h_eq, h_mid = rng.uniform(80.0, 120.0), rng.uniform(450.0, 600.0)
    q_deep = rng.uniform(0.2, 0.35)
    s_mean, s_amp = rng.uniform(34.5, 34.9), rng.uniform(0.6, 1.0)
    phases = rng.uniform(0.0, 2 * math.pi, 3)

    dev = case.wet.device
    f64 = dict(dtype=torch.float64, device=dev)
    phi = torch.deg2rad(torch.as_tensor(np.asarray(case.lat, dtype=np.float64), **f64))[None]
    lam = torch.deg2rad(torch.as_tensor(np.asarray(case.lon, dtype=np.float64), **f64))[None]
    z = torch.as_tensor(np.asarray(case.lev, dtype=np.float64), **f64).reshape(-1, 1, 1)

    cos2 = torch.cos(phi) ** 2
    t_surf = t_pole + (t_eq - t_pole) * cos2 * (1.0 + 0.05 * torch.sin(2 * lam + phases[0]))
    t_bottom = t_pole - 0.5
    mld = 25.0 + 95.0 * torch.sin(phi) ** 2 * (1.0 + 0.3 * torch.cos(lam + phases[1])) / 1.3
    h = h_eq + (h_mid - h_eq) * torch.sin(2 * phi) ** 2 * (1.0 + 0.2 * torch.cos(lam + phases[2]))

    def deep(depth):
        return t_bottom + (t_surf - t_bottom) * q_deep * torch.exp(-depth / DEEP_SCALE)

    t_base = t_surf - ML_GRADIENT * mld  # the mixed layer's base
    below = deep(z) + (t_base - deep(mld)) * torch.exp(-(z - mld) / h)
    thetao = torch.where(z < mld, t_surf - ML_GRADIENT * z, below)
    so = s_mean + s_amp * (cos2 - 0.5) * torch.exp(-torch.clamp(z - mld, min=0.0) / h)
    land = ~case.wet
    f32 = lambda x: torch.where(land, math.nan, x).to(torch.float32)
    return f32(thetao), f32(so)
