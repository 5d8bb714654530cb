"""Request: `assemble_T` on one season's GM-augmented transports, then the
refined steady ideal age of T - R, `ideal_age(refine=True, redi=R)`: on the
card K6's matvec mode in the graphed BiCGStab(1) loop, K2 on T - R's
Thomas legs and K13, the f64 defects through K6's f64 matvec mode.

Set-up, once: the case's grid, its hydrography and the density path in
float64, as `esm1deg.redi-step8` runs them, R in the cell's precision,
and each season's umo and vmo with the GM bolus transports added
(`add_bolus_transports`; the bolus depends on the density alone, so each
season gets the same one). The seasons are cycled in an order drawn from
the seed.

Traffic parameters: `snapshots`, `tol`, `algorithm`, `surface_rate`.

Checked: every request's residual against `tol` (else failed); the grid,
the GM-augmented face fluxes of the first season, the density, the slopes
on R's faces and R on a fixed probe against the plain reference, as
`esm1deg.redi-step8` checks them; for the sampled requests T's legs against
the reference's for the same season, and the age's residual against the
float64 reference of T - R + M (`reference_redi_age.py`) in its largest
cell, relative to 1.

The control hands the reference's products to the program's
lower-precision paths: T's legs and the grid in bfloat16, R built in
float64 by the program from the reference's density and slopes, then
`redi_operator_to_bf16`; its age runs the bf16-narrow mode (K1's and K6's
(bf16, f32) kernels beside each other, f32 vectors).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import case as cases
from .. import check as C
from .. import reference as REF
from .. import reference_neutral as RN
from ..hydrography import hydrography
from ..program import GRID_FIELDS, SIDES, legs, port, surface
from ..reference_redi_age import largest_residual
from ..window import Record
from .propagate_neutral import FACE_SLOPES, PROBE_SEED, ReferenceNeutral, physics


def _matvec_runs():
    """Runs of K6's matvec mode so far (eager or inside a replay), or None
    where the program has no matvec mode."""
    from otmb_tpu_torch import _build
    from otmb_tpu_torch.models import redi_kernel

    names = getattr(redi_kernel, "APPLY_ENTRIES", None)
    return None if names is None else _build.calls(names)


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
        self.snaps = cases.seasons(case, t["snapshots"])
        self.order = [int(s) for s in np.random.default_rng([ctx.seed, 3]).permutation(
            t["snapshots"])]
        if ctx.control:
            self._control(P, phys, gm, dtype)
        else:
            thetao, so = (x.to(torch.float64) for x in hydrography(case))
            self.rho = P.rho_teos10(so, thetao, gm.z3d.to(torch.float64))
            slopes = P.potential_density_slopes(P.rho_teos10, so, thetao, gm, wet)
            # each season's transports with the bolus of the one density
            self.seasons = [(*P.add_bolus_transports(umo, vmo, self.rho, gm, wet,
                                                     kappa_gm=phys["kappa_gm"],
                                                     maxslope=phys["maxslope"], slopes=slopes),
                             mlotst) for umo, vmo, mlotst in self.snaps]
            umo, vmo, _ = self.seasons[0]
            phi = P.facefluxesfrommasstransport(umo=umo, vmo=vmo, gridmetrics=gm, indices=idx)
            self.R = P.build_redi_operator(None, gm, wet, kappa_redi=phys["kappa_redi"],
                                           maxslope=phys["maxslope"], slopes=slopes).to(dtype)
            self.grid = {name: getattr(gm, name) for name in GRID_FIELDS}
            for group in ("edge_length", "distance_to_edge", "distance_to_neighbour"):
                for d in SIDES:
                    self.grid[f"{group}.{d}"] = getattr(gm, group)[d]
            self.fluxes = phi._asdict()
            self.gm = gm
        self.probe = cases.ensemble(case, 1, PROBE_SEED)[0]
        self.r_probe = P.redi_apply_fused(self.R, self.probe)
        self.work = {"krylov": {"shape": case.shape, "vec_bytes": 4,
                                "coef_bytes": dtype.itemsize, "batch": 1,
                                "redi_coef_bytes": self.R.ae.dtype.itemsize}}

    def _control(self, P, phys: dict, gm64, dtype):
        """The reference's products in `dtype`, each season's T from its
        GM-augmented transports; R folded in float64 by the program from
        the reference's density and slopes, then rounded."""
        ref = ReferenceNeutral(self.ctx.case, phys)
        lower = lambda d: {k: v.to(dtype) for k, v in d.items()}
        self.grid = lower(ref.grid)
        self.rho = ref.rho.to(dtype)
        self.season_T = []
        for umo, vmo, mlotst in self.snaps:
            aug = RN.bolus_transports(umo, vmo, ref.rho, ref.slopes, ref.grid, ref.wet,
                                      ref.tripolar, phys["kappa_gm"], phys["maxslope"],
                                      phys["sc"], phys["sd"])
            phi = REF.face_fluxes(*aug, ref.wet, ref.tripolar)
            if not self.season_T:
                self.fluxes = lower(phi)
            legs_s = REF.operator(ref.grid, phi, mlotst, self.ctx.case.lev, ref.tripolar)
            self.season_T.append(P.StencilCoeffs(**lower(legs_s)))
        self.R = P.redi_operator_to_bf16(P.build_redi_operator(
            None, gm64, self.wet, kappa_redi=phys["kappa_redi"], maxslope=phys["maxslope"],
            slopes=ref.slopes))

    def assemble(self, s: int):
        if self.ctx.control:
            return self.season_T[s]
        return port().assemble_T(*self.seasons[s], self.gm)

    def request(self, i: int):
        t, s = self.ctx.traffic, self.order[i % len(self.order)]
        T = self.assemble(s)
        stats = {}
        before = _matvec_runs()
        age, res = port().ideal_age(T, self.wet, self.topo, tol=t["tol"],
                                    surface_rate=t["surface_rate"], refine=True,
                                    algorithm=t["algorithm"], stats=stats, redi=self.R)
        after = _matvec_runs()
        iters = sum(p.get("inner_iters", 0) for p in stats.get("passes", []))
        counters = {"krylov_iters": iters, "passes": stats.get("refinements", 0)}
        if before is not None:
            counters["k6_matvecs"] = after - before
        ok = math.isfinite(res) and res <= t["tol"]
        return Record(0.0, 1, counters, ok), {"snapshot": s, "T": T, "age": age}

    def check(self, kept: dict, ref: C.Reference) -> dict:
        t, case, wet, tri = self.ctx.traffic, ref.case, ref.wet, ref.tripolar
        phys = physics(self.ctx.config)
        rn = ReferenceNeutral(case, phys, ref.grid)
        umo0, vmo0 = RN.bolus_transports(*self.snaps[0][:2], rn.rho, rn.slopes, rn.grid, wet,
                                         tri, phys["kappa_gm"], phys["maxslope"], phys["sc"],
                                         phys["sd"])
        out = {"grid_gap": C.worst_gap(self.grid, ref.grid),
               "flux_gap": C.worst_gap(self.fluxes, REF.face_fluxes(umo0, vmo0, wet, tri)),
               "density_gap": C.gap(torch.where(wet, self.rho, math.nan), rn.rho),
               "slope_gap": C.worst_gap({k: getattr(self.R, k) for k in FACE_SLOPES},
                                        rn.redi.face_slopes()),
               "redi_gap": C.gap(self.r_probe, rn.redi(self.probe))}
        del umo0, vmo0
        extra = surface(wet, t["surface_rate"], torch.float64)
        b = wet.to(torch.float64)
        op_gap = resid = 0.0
        finite = True
        for s in sorted({a["snapshot"] for a in kept.values()}):
            umo, vmo, mlotst = self.snaps[s]
            aug = RN.bolus_transports(umo, vmo, rn.rho, rn.slopes, rn.grid, wet, tri,
                                      phys["kappa_gm"], phys["maxslope"], phys["sc"], phys["sd"])
            r_legs = REF.operator(rn.grid, REF.face_fluxes(*aug, wet, tri), mlotst, case.lev, tri)
            del aug
            for ans in (a for a in kept.values() if a["snapshot"] == s):
                op_gap = max(op_gap, C.worst_gap(legs(ans["T"]), r_legs))
                finite &= C.finite_on_wet(ans["age"], wet)
                x = C.zero_land(ans["age"], wet)
                resid = max(resid, largest_residual(r_legs, rn.redi, x, b, extra, tri))
            del r_legs
        out["operator_gap"] = op_gap
        out["redi_age_residual"] = resid if finite else math.inf
        return out
