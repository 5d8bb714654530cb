"""Request: `steps` explicit T + R Euler steps of an ensemble of `members`
tracers through the public batched propagation with the Redi operator,
`euler_propagate_multi(T, chis, dt, steps, topo, redi=R)` (K5, then K6
adding dt R chi, each step).

Set-up, once: the case's grid (`makegridmetrics`, `makeindices`), its
hydrography (`hydrography.py`), then the density path a modeller runs on
CMIP's thetao and so: TEOS-10 in-situ density (`rho_teos10`), the slopes
of the locally referenced potential density (`potential_density_slopes`),
the GM bolus transports added to umo and vmo (`add_bolus_transports`),
their face fluxes (`facefluxesfrommasstransport`) and T (`assemble_T`,
K4), and R (`build_redi_operator`), with the configuration's
`neutral_physics` parameters. The density path runs in float64 (the
slopes are ratios of density differences a float32 density cannot
resolve); T and R are stored, and the tracers stepped, in the cell's
precision. The ensemble is drawn from the seed.

Traffic parameters: `members`, `steps`, `dt_s`.

Checked: the grid, the GM-augmented face fluxes, the density, the tapered
slopes on R's faces, T's legs and R applied to a fixed probe field, each
against the plain reference (`reference_neutral.py`); for the sampled
requests every member finite on wet cells (else failed) and its gap to
the reference's `steps` float64 T + R steps from the same ensemble.

The control hands the reference's products to the program's
lower-precision paths: its grid, fluxes, density and slopes rounded to
bfloat16, T's legs in bfloat16 (K5's (bf16, f32) path) and R built in
float64 from the reference's density and slopes, then
`redi_operator_to_bf16` (K6's (bf16, f32) path).
"""

from __future__ import annotations

import math

import torch

from .. import case as cases
from .. import check as C
from .. import reference as REF
from .. import reference_neutral as RN
from ..hydrography import hydrography
from ..program import GRID_FIELDS, SIDES, legs, port
from ..window import Record

FACE_SLOPES = ("s_e", "s_n", "s_ti", "s_tj")
PROBE_SEED = 0  # the probe field R is checked on: the same for every seed


def physics(config: dict) -> dict:
    """The configuration's neutral-physics parameters, by the program's
    keyword names."""
    p = config["neutral_physics"]
    return {"kappa_gm": p["kappa_gm"], "kappa_redi": p["kappa_redi"], "maxslope": p["maxslope"],
            "sc": p["taper_sc"], "sd": p["taper_sd"]}


class ReferenceNeutral:
    """The reference's neutral-physics products of one raw case, float64."""

    def __init__(self, case, phys: dict, grid: dict | None = None):
        self.tripolar = tri = case.topology == "tripolar"
        self.wet = wet = torch.isfinite(case.volcello)
        self.grid = REF.grid_metrics(case) if grid is None else grid
        thetao, so = hydrography(case)
        taper = (phys["maxslope"], phys["sc"], phys["sd"])
        self.rho = RN.rho_teos10(so, thetao, self.grid["z3d"])
        self.slopes = RN.neutral_slopes(so, thetao, self.grid, wet, tri)
        self.umo, self.vmo = RN.bolus_transports(case.umo, case.vmo, self.rho, self.slopes,
                                                 self.grid, wet, tri, phys["kappa_gm"], *taper)
        self.fluxes = REF.face_fluxes(self.umo, self.vmo, wet, tri)
        self.legs = REF.operator(self.grid, self.fluxes, case.mlotst, case.lev, tri)
        self.redi = RN.Redi(self.slopes, self.grid, wet, tri, phys["kappa_redi"], *taper)


class Program:
    def __init__(self, ctx):
        self.ctx, t, case = ctx, ctx.traffic, ctx.case
        P, dtype, phys = port(), ctx.dtype, physics(ctx.config)
        self.topo = P.detect_topology(case.lon_vertices, case.lat_vertices, case.shape[0])
        gm = P.makegridmetrics(areacello=case.areacello, volcello=case.volcello.cpu().numpy(),
                               lon=case.lon, lat=case.lat, lev=case.lev,
                               lon_vertices=case.lon_vertices, lat_vertices=case.lat_vertices,
                               dtype=torch.float64 if ctx.control else dtype, device=ctx.device)
        idx = P.makeindices(gm.v3d)
        self.wet = wet = idx.wet3d
        if ctx.control:
            self._control(P, phys, gm, dtype)
        else:
            thetao, so = (x.to(torch.float64) for x in hydrography(case))
            self.rho = P.rho_teos10(so, thetao, gm.z3d.to(torch.float64))
            slopes = P.potential_density_slopes(P.rho_teos10, so, thetao, gm, wet)
            umo, vmo = P.add_bolus_transports(case.umo, case.vmo, self.rho, gm, wet,
                                              kappa_gm=phys["kappa_gm"],
                                              maxslope=phys["maxslope"], slopes=slopes)
            phi = P.facefluxesfrommasstransport(umo=umo, vmo=vmo, gridmetrics=gm, indices=idx)
            self.T = P.assemble_T(umo, vmo, case.mlotst, gm)
            self.R = P.build_redi_operator(None, gm, wet, kappa_redi=phys["kappa_redi"],
                                           maxslope=phys["maxslope"], slopes=slopes).to(dtype)
            self.grid = {name: getattr(gm, name) for name in GRID_FIELDS}
            for group in ("edge_length", "distance_to_edge", "distance_to_neighbour"):
                for d in SIDES:
                    self.grid[f"{group}.{d}"] = getattr(gm, group)[d]
            self.fluxes = phi._asdict()
        self.chis = cases.ensemble(case, t["members"], ctx.seed)
        self.probe = cases.ensemble(case, 1, PROBE_SEED)[0]
        self.r_probe = P.redi_apply_fused(self.R, self.probe)
        self.work = {"neutral": {"shape": case.shape, "vec_bytes": 4,
                                 "coef_bytes": self.T.diag.dtype.itemsize, "batch": t["members"],
                                 "redi_coef_bytes": self.R.ae.dtype.itemsize}}

    def _control(self, P, phys: dict, gm64, dtype):
        """The reference's products in `dtype`; R folded in float64 by the
        program from the reference's density and slopes, then rounded."""
        ref = ReferenceNeutral(self.ctx.case, phys)
        lower = lambda d: {k: v.to(dtype) for k, v in d.items()}
        self.grid = lower(ref.grid)
        self.fluxes = lower(ref.fluxes)
        self.rho = ref.rho.to(dtype)
        self.T = P.StencilCoeffs(**lower(ref.legs))
        self.R = P.redi_operator_to_bf16(P.build_redi_operator(
            None, gm64, self.wet, kappa_redi=phys["kappa_redi"], maxslope=phys["maxslope"],
            slopes=ref.slopes))

    def request(self, i: int):
        t = self.ctx.traffic
        out = port().euler_propagate_multi(self.T, self.chis, t["dt_s"], t["steps"], self.topo,
                                           redi=self.R)
        return Record(0.0, t["steps"], {}, True), {"chis": out}

    def failed(self, kept: dict) -> int:
        return sum(not C.finite_on_wet(a["chis"], self.wet[None]) for a in kept.values())

    def check(self, kept: dict, ref: C.Reference) -> dict:
        t, case, wet = self.ctx.traffic, ref.case, ref.wet
        rn = ReferenceNeutral(case, physics(self.ctx.config), ref.grid)
        out = {"grid_gap": C.worst_gap(self.grid, ref.grid),
               "flux_gap": C.worst_gap(self.fluxes, rn.fluxes),
               "density_gap": C.gap(torch.where(wet, self.rho, math.nan), rn.rho),
               "slope_gap": C.worst_gap({k: getattr(self.R, k) for k in FACE_SLOPES},
                                        rn.redi.face_slopes()),
               "operator_gap": C.worst_gap(legs(self.T), rn.legs),
               "redi_gap": C.gap(self.r_probe, rn.redi(self.probe))}
        worst = 0.0
        for m in range(t["members"]):
            want = RN.euler(rn.legs, rn.redi, self.chis[m], t["dt_s"], t["steps"], ref.tripolar)
            for ans in kept.values():
                got = ans["chis"][m]
                worst = max(worst, C.gap(torch.where(wet, got, 0.0), want)
                            if C.finite_on_wet(got, wet) else math.inf)
        out["propagate_gap"] = worst
        return out
