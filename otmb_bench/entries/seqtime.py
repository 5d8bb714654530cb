"""Request: `assemble_T` on one snapshot's transports, then the refined
mean sequestration time `sequestration_time(refine=True)`: the adjoint of
the ideal age, (T' + M) Gamma = 1, through T's transposed stencil (K1 +
K2 + K13 by default, as the age).

Traffic parameters: `snapshots` (the seasons cycled through, in an order
drawn from the seed), `tol`, `algorithm`, `surface_rate`.

Checked: every request's residual against `tol` (else failed); for the
sampled requests, the operator against the reference's for the same
snapshot, and the answer's residual against the reference's transposed
operator ((T' + M) Gamma = 1 on wet cells, `reference_adjoint.py`) in its
largest cell, relative to 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import case as cases
from .. import check as C
from ..program import Setup, legs, port, surface
from ..reference_adjoint import relative_residual_transpose
from ..window import Record


class Program:
    def __init__(self, ctx):
        self.ctx, t = ctx, ctx.traffic
        self.setup = Setup(ctx)
        self.snaps = cases.seasons(ctx.case, t["snapshots"])
        self.order = [int(s) for s in np.random.default_rng([ctx.seed, 3]).permutation(
            t["snapshots"])]
        # the inner solves' vectors are float32 under bfloat16 coefficients
        vec = 8 if ctx.dtype == torch.float64 else 4
        self.work = {"krylov": {"shape": ctx.case.shape, "vec_bytes": vec,
                                "coef_bytes": ctx.dtype.itemsize, "batch": 1}}

    def request(self, i: int):
        t, s = self.ctx.traffic, self.order[i % len(self.order)]
        T = self.setup.assemble(*self.snaps[s])
        stats = {}
        gamma, res = port().sequestration_time(T, self.setup.wet, self.setup.topo, tol=t["tol"],
                                               surface_rate=t["surface_rate"], refine=True,
                                               algorithm=t["algorithm"], stats=stats)
        iters = sum(p.get("inner_iters", 0) for p in stats.get("passes", []))
        ok = math.isfinite(res) and res <= t["tol"]
        return (Record(0.0, 1, {"krylov_iters": iters, "passes": stats.get("refinements", 0)}, ok),
                {"snapshot": s, "T": T, "gamma": gamma})

    def check(self, kept: dict, ref: C.Reference) -> dict:
        t, wet = self.ctx.traffic, ref.wet
        out = C.setup_gaps(self.setup, ref)
        extra = surface(wet, t["surface_rate"], torch.float64)
        b = wet.to(torch.float64)
        op_gap = resid = 0.0
        finite = True
        for ans in kept.values():
            s = ans["snapshot"]
            r_legs = ref.operator(s, *self.snaps[s])
            op_gap = max(op_gap, C.worst_gap(legs(ans["T"]), r_legs))
            finite &= C.finite_on_wet(ans["gamma"], wet)
            x = C.zero_land(ans["gamma"], wet)
            resid = max(resid, relative_residual_transpose(r_legs, x, b, extra, ref.tripolar))
        out["operator_gap"] = op_gap
        out["seqtime_residual"] = resid if finite else math.inf
        return out
