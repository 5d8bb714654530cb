"""Request: a fixed amount of Krylov work on the steady ideal-age system
(T + M) x = 1 of the case's own transports: `solve_shifted_chunked` from
x = 0 with `maxiter` matvec pairs, `early_stop=False` and a tolerance it
cannot reach in that budget, so every request runs the same cycles (fused
K3, K11, K12 for BiCGStab(2)). The operator is assembled once, in set-up.

Traffic parameters: `algorithm`, `maxiter`, `tol`, `surface_rate`.

Checked: every request stops at "maxiter" after exactly `maxiter` pairs
with no restart and a finite residual (else failed); for the sampled
requests, the relative residual of x against the reference operator, and
its gap to the residual the program reported.
"""

from __future__ import annotations

import math

import torch

from .. import check as C
from .. import reference as R
from ..program import Setup, legs, port, surface
from ..window import Record


class Program:
    def __init__(self, ctx):
        self.ctx, t = ctx, ctx.traffic
        self.setup = Setup(ctx)
        case = ctx.case
        self.T = self.setup.assemble(case.umo, case.vmo, case.mlotst)
        vec = torch.float32 if ctx.dtype == torch.bfloat16 else ctx.dtype
        self.b = self.setup.wet.to(vec)
        self.extra = surface(self.setup.wet, t["surface_rate"], vec)
        self.pairs_per_unit = 2 if t["algorithm"] == "bicgstab2" else 1
        self.work = {"krylov_cycles": {"shape": case.shape, "vec_bytes": vec.itemsize,
                                       "coef_bytes": ctx.dtype.itemsize, "batch": 1}}

    def request(self, i: int):
        t = self.ctx.traffic
        stats = {}
        x, res = port().solve_shifted_chunked(
            self.T, self.b, self.setup.topo, extra_diag=self.extra, tol=t["tol"],
            maxiter=t["maxiter"], algorithm=t["algorithm"], early_stop=False, stats=stats)
        res = float(res)
        ok = (stats.get("stop") == "maxiter" and stats.get("iters") == t["maxiter"]
              and stats.get("restarts") == 0 and stats.get("diverge_restarts") == 0
              and math.isfinite(res))
        units = stats.get("iters", 0) // self.pairs_per_unit
        return (Record(0.0, units, {"krylov_iters": stats.get("iters", 0)}, ok),
                {"x": x, "res": res})

    def check(self, kept: dict, ref: C.Reference) -> dict:
        t, wet, case = self.ctx.traffic, ref.wet, ref.case
        out = C.setup_gaps(self.setup, ref)
        r_legs = ref.operator(0, case.umo, case.vmo, case.mlotst)
        out["operator_gap"] = C.worst_gap(legs(self.T), r_legs)
        extra = surface(wet, t["surface_rate"], torch.float64)
        b = wet.to(torch.float64)
        resid = claim = 0.0
        for ans in kept.values():
            if not C.finite_on_wet(ans["x"], wet):
                resid = claim = math.inf
                continue
            r = R.relative_residual(r_legs, C.zero_land(ans["x"], wet), b, extra, ref.tripolar)
            resid = max(resid, r)
            claim = max(claim, abs(ans["res"] - r) / r if r > 0 else math.inf)
        out["cycle_residual"] = resid
        out["residual_claim_gap"] = claim
        return out
