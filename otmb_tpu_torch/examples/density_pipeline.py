"""Density pipeline demo: thetao/so -> TEOS-10 rho -> isoneutral slopes
-> GM bolus transports -> transport operator (+ the Redi operator).

The JAX package's `examples/density_pipeline.py` on the port, at its size
and seed (48x32x12 tripolar, seed 0), in float64: the reference's density
path (test/LocalBuiltMatrix.jl:71-72 computes rho = gsw_rho.(so, ct,
Z3D); src/RediGM.jl feeds it into the potential-density slopes), with
the built-in polyTEOS10-bsq polynomial (`physics/eos.py`). The Redi apply
is K6 on the card.

    python -m otmb_tpu_torch.examples.density_pipeline [--device cpu]
"""

from __future__ import annotations

import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.utils.device import default_device

from . import parser

MYR = 1e6 * 365.25 * 24 * 3600


def _nanmax(x: torch.Tensor) -> float:
    return float(x[~torch.isnan(x)].max())


def _nanmin(x: torch.Tensor) -> float:
    return float(x[~torch.isnan(x)].min())


def main(device=None) -> dict:
    """Run the example on `device` (None: the current CUDA device); returns
    the printed numbers."""
    device = default_device(device)
    ds = P.synthetic_dataset(nx=48, ny=32, nz=12, topology="tripolar", seed=0)
    gm = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
        device=device)
    idx = P.makeindices(gm.v3d)
    wet = idx.wet3d

    # 1. Hydrography (CMIP names: thetao ~ Conservative Temperature proxy,
    # so ~ Absolute Salinity proxy). NaN on land, like the reference.
    so = torch.where(wet, 35.0 + 0.3 * torch.cos(torch.deg2rad(gm.lat))
                     * torch.sin(torch.deg2rad(gm.lon)), torch.nan)
    ct = torch.where(wet, 20.0 - 0.004 * gm.z3d
                     - 6.0 * torch.sin(torch.deg2rad(gm.lat)) ** 2, torch.nan)

    # 2. In-situ density from the built-in TEOS-10 polynomial
    # (drop-in for the reference's gsw_rho.(so, ct, Z3D)).
    rho = P.rho_teos10(so, ct, gm.z3d)
    out = {"rho": (_nanmin(rho), _nanmax(rho))}
    print(f"rho: [{out['rho'][0]:.2f}, {out['rho'][1]:.2f}] kg/m^3")

    # 3. Isoneutral slopes of the LOCALLY-REFERENCED potential density
    # (each cell's neighbours evaluated at the centre's depth, removing the
    # compressibility signal — RediGM.jl:17-35).
    s_i, s_j = P.potential_density_slopes(P.rho_teos10, so, ct, gm, wet)
    out["slopes"] = (_nanmax(s_i.abs()), _nanmax(s_j.abs()))
    print(f"slopes: |S_i| up to {out['slopes'][0]:.2e}, |S_j| up to {out['slopes'][1]:.2e}")

    # 4. GM bolus velocity -> extra mass transports -> operator carrying
    # resolved + eddy-induced advection.
    umo2, vmo2 = P.add_bolus_transports(ds.umo, ds.vmo, rho, gm, wet)
    phi = P.facefluxesfrommasstransport(umo=umo2, vmo=vmo2, gridmetrics=gm, indices=idx)
    ops = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx)
    d = P.operator_diagnostics(ops.T, gm.v3d, wet, gm.topology)
    out["tau_vol_myr"] = float(d["tau_vol_s"]) / MYR
    print(f"T with bolus: tau_vol {out['tau_vol_myr']:.3g} Myr (volume conservation)")

    # 5. The 19-point conservative Redi isoneutral-diffusion operator from
    # the same density field (beyond the reference's capability set). As
    # in the JAX example, R is built from the f32 density on the f64 grid,
    # and chi is rounded to f32 and applied in R's f64 (K6 on the card).
    rho32 = torch.where(wet, rho, torch.nan).to(torch.float32)
    redi = P.build_redi_operator(rho32, gm, wet)
    chi = torch.where(wet, 1.0 + 0.1 * torch.sin(gm.z3d / 300.0), 0.0)
    tchi = P.redi_apply_fused(redi, chi.to(torch.float32).to(redi.ae.dtype))
    out["redi_max"] = float(tchi.abs().max())
    print(f"Redi apply: max |T chi| {out['redi_max']:.3e} 1/s")

    print("OK")
    return out


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
