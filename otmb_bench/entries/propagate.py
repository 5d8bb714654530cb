"""Request: `steps` explicit Euler steps of an ensemble of `members`
tracers through the public batched propagation `euler_propagate_multi`
(one K5 launch a step), from the ensemble drawn from the seed in set-up.
The operator is assembled once, in set-up.

Traffic parameters: `members`, `steps`, `dt_s`.

Checked: for the sampled requests, every member finite on wet cells (else
failed) and its gap to the reference's `steps` float64 Euler steps from
the same ensemble on the reference operator.
"""

from __future__ import annotations

import math

import torch

from .. import case as cases
from .. import check as C
from .. import reference as R
from ..program import Setup, legs, port
from ..window import Record


class Program:
    def __init__(self, ctx):
        self.ctx, t = ctx, ctx.traffic
        self.setup = Setup(ctx)
        case = ctx.case
        self.T = self.setup.assemble(case.umo, case.vmo, case.mlotst)
        self.chis = cases.ensemble(case, t["members"], ctx.seed)
        self.work = {"stencil": {"shape": case.shape, "vec_bytes": 4,
                                 "coef_bytes": ctx.dtype.itemsize, "batch": t["members"]}}

    def request(self, i: int):
        t = self.ctx.traffic
        out = port().euler_propagate_multi(self.T, self.chis, t["dt_s"], t["steps"],
                                           self.setup.topo)
        return Record(0.0, t["steps"], {}, True), {"chis": out}

    def failed(self, kept: dict) -> int:
        wet = self.setup.wet
        return sum(not C.finite_on_wet(a["chis"], wet[None]) for a in kept.values())

    def check(self, kept: dict, ref: C.Reference) -> dict:
        t, wet, case = self.ctx.traffic, ref.wet, ref.case
        out = C.setup_gaps(self.setup, ref)
        r_legs = ref.operator(0, case.umo, case.vmo, case.mlotst)
        out["operator_gap"] = C.worst_gap(legs(self.T), r_legs)
        worst = 0.0
        for m in range(t["members"]):
            want = R.euler(r_legs, self.chis[m].to(torch.float64), t["dt_s"], t["steps"],
                           ref.tripolar)
            for ans in kept.values():
                got = ans["chis"][m]
                worst = max(worst, C.gap(torch.where(wet, got, 0.0), want)
                            if C.finite_on_wet(got, wet) else math.inf)
        out["propagate_gap"] = worst
        return out
