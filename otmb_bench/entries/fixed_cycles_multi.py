"""Request: a fixed amount of batched Krylov work on the water-mass
fractions' dye systems (T + M) f_i = b_i of the case's own transports, one
right-hand side a latitude band: b_i is `surface_rate` on band i's wet
surface cells (`case.latitude_bands`). `solve_shifted_chunked_multi` from
x = 0 with `maxiter` matvec pairs, `early_stop=False` and a tolerance it
cannot reach in that budget, so every request runs the same cycles: for
BiCGStab(2) the batched engine's K5, batched K2, K11 and K12 at B =
`bands`. The operator is assembled once, in set-up.

Traffic parameters: `algorithm`, `maxiter`, `tol`, `surface_rate`, `bands`.

Checked as `fixed_cycles.py` checks, per member: every request stops at
"maxiter" after exactly `maxiter` pairs with no restart and finite
residuals (else failed); for the sampled requests, each member's relative
residual against the reference operator, and its gap to the residual the
program reported, the worst member's of each.
"""

from __future__ import annotations

import math

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
        case = ctx.case
        nz, ny, nx = case.shape
        self.T = self.setup.assemble(case.umo, case.vmo, case.mlotst)
        vec = torch.float32 if ctx.dtype == torch.bfloat16 else ctx.dtype
        wet = self.setup.wet
        self.masks = torch.as_tensor(cases.latitude_bands(ny, nx, t["bands"]), device=ctx.device)
        self.extra = surface(wet, t["surface_rate"], vec)
        self.bs = torch.where(wet[None] & self.masks[:, None], self.extra[None], 0.0)
        self.pairs_per_unit = 2 if t["algorithm"] == "bicgstab2" else 1
        self.work = {"krylov_cycles": {"shape": case.shape, "vec_bytes": vec.itemsize,
                                       "coef_bytes": ctx.dtype.itemsize, "batch": t["bands"]}}

    def request(self, i: int):
        t = self.ctx.traffic
        stats = {}
        xs, res = port().solve_shifted_chunked_multi(
            self.T, self.bs, self.setup.topo, extra_diag=self.extra, tol=t["tol"],
            maxiter=t["maxiter"], algorithm=t["algorithm"], early_stop=False, stats=stats)
        res = [float(v) for v in res]
        ok = (stats.get("stop") == "maxiter" and stats.get("iters") == t["maxiter"]
              and stats.get("restarts") == 0 and stats.get("diverge_restarts") == 0
              and all(math.isfinite(v) for v in res))
        units = stats.get("iters", 0) // self.pairs_per_unit
        return (Record(0.0, units, {"krylov_iters": stats.get("iters", 0)}, ok),
                {"xs": xs, "res": res})

    def check(self, kept: dict, ref: C.Reference) -> dict:
        t, wet, case = self.ctx.traffic, ref.wet, ref.case
        out = C.setup_gaps(self.setup, ref)
        r_legs = ref.operator(0, case.umo, case.vmo, case.mlotst)
        out["operator_gap"] = C.worst_gap(legs(self.T), r_legs)
        extra = surface(wet, t["surface_rate"], torch.float64)
        resid = claim = 0.0
        for ans in kept.values():
            for band, x, claimed in zip(self.masks, ans["xs"], ans["res"]):
                if not C.finite_on_wet(x, wet):
                    resid = claim = math.inf
                    continue
                b = torch.where(band[None] & wet, extra, 0.0)
                r = R.relative_residual(r_legs, C.zero_land(x, wet), b, extra, ref.tripolar)
                resid = max(resid, r)
                claim = max(claim, abs(claimed - r) / r if r > 0 else math.inf)
        out["cycle_residual"] = resid
        out["residual_claim_gap"] = claim
        return out
