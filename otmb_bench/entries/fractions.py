"""Request: `assemble_T` on one snapshot's transports, then the water-mass
fractions of `bands` latitude bands of the surface, `water_mass_fractions`
(one batched solve: K5, batched K2 and K13 on the batch).

Traffic parameters: `snapshots` (cycled in an order drawn from the seed),
`bands`, `tol`, `algorithm`, `surface_rate`, `dtype` (the operator's).

Checked: every request's residuals against `tol` (else failed); for the
sampled requests, the operator against the reference's, and each band's
residual against the reference operator ((T + M) f = M 1_band), divided
by each cell's diagonal: the largest error in a fraction that a cell's
residual implies (the interior's rates are orders of magnitude below the
surface's, so a residual relative to the surface rate would not see it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import case as cases
from .. import check as C
from .. import reference as R
from ..program import Setup, legs, port, surface
from ..window import Record


class Program:
    def __init__(self, ctx):
        self.ctx, t = ctx, ctx.traffic
        self.setup = Setup(ctx)
        self.snaps = cases.seasons(ctx.case, t["snapshots"])
        self.order = [int(s) for s in np.random.default_rng([ctx.seed, 3]).permutation(
            t["snapshots"])]
        nz, ny, nx = ctx.case.shape
        self.masks = torch.as_tensor(cases.latitude_bands(ny, nx, t["bands"]), device=ctx.device)
        vec = 4 if ctx.dtype != torch.float64 else 8
        self.work = {"krylov": {"shape": ctx.case.shape, "vec_bytes": vec,
                                "coef_bytes": ctx.dtype.itemsize, "batch": t["bands"]}}

    def request(self, i: int):
        t, s = self.ctx.traffic, self.order[i % len(self.order)]
        T = self.setup.assemble(*self.snaps[s])
        stats = {}
        fr, res = port().water_mass_fractions(T, self.setup.wet, self.setup.topo, self.masks,
                                              surface_rate=t["surface_rate"], tol=t["tol"],
                                              algorithm=t["algorithm"], stats=stats)
        res = [float(v) for v in res]
        ok = all(math.isfinite(v) and v <= t["tol"] for v in res)
        return (Record(0.0, 1, {"krylov_iters": stats.get("iters", 0)}, ok),
                {"snapshot": s, "T": T, "fractions": fr})

    def check(self, kept: dict, ref: C.Reference) -> dict:
        t, wet = self.ctx.traffic, ref.wet
        out = C.setup_gaps(self.setup, ref)
        extra = surface(wet, t["surface_rate"], torch.float64)
        op_gap = resid = 0.0
        finite = True
        for ans in kept.values():
            s = ans["snapshot"]
            r_legs = ref.operator(s, *self.snaps[s])
            op_gap = max(op_gap, C.worst_gap(legs(ans["T"]), r_legs))
            for band, f in zip(self.masks, ans["fractions"]):
                b = torch.where(band[None], extra, 0.0)
                finite &= C.finite_on_wet(f, wet)
                x = C.zero_land(f, wet)
                resid = max(resid, R.local_residual(r_legs, x, b, extra, ref.tripolar))
        out["operator_gap"] = op_gap
        out["fractions_residual"] = resid if finite else math.inf
        return out
