"""The comparison that decides `correct`: the program's products against
the plain reference's, recomputed from the same raw inputs.

Every number is a worst case: a relative gap is the largest |program -
reference| over the cells, over the largest |reference|, per field, and
the worst field; a cell that is NaN (land) on one side only makes the gap
infinite. The limits are the cell's (`workloads/<cell>.json`).
"""

from __future__ import annotations

import math

import torch

from . import reference


def gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| / max |ref| over the cells finite on both sides;
    inf where one side is finite and the other not."""
    prog = prog.to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    fp, fr = torch.isfinite(prog), torch.isfinite(ref)
    if not torch.equal(fp, fr):
        return math.inf
    scale = float(torch.where(fr, ref.abs(), 0.0).max()) if ref.numel() else 0.0
    diff = float(torch.where(fr, (prog - ref).abs(), 0.0).max()) if ref.numel() else 0.0
    if scale == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return diff / scale


def worst_gap(prog: dict, ref: dict) -> float:
    """The largest `gap` over the fields both dicts name (a field the
    program lacks is a failure)."""
    worst = 0.0
    for name, r in ref.items():
        if name not in prog:
            return math.inf
        worst = max(worst, gap(prog[name], r))
    return worst


class Reference:
    """The reference's grid (float64, made once) and its operator per set
    of transports, for one raw case."""

    def __init__(self, case):
        self.case = case
        self.tripolar = case.topology == "tripolar"
        self.wet = torch.isfinite(case.volcello)
        self.grid = reference.grid_metrics(case)
        self._ops = {}

    def fluxes(self, umo, vmo) -> dict:
        return reference.face_fluxes(umo, vmo, self.wet, self.tripolar)

    def operator(self, key, umo, vmo, mlotst) -> dict:
        if key not in self._ops:
            self._ops.clear()  # one operator at a time: they are large
            self._ops[key] = reference.operator(self.grid, self.fluxes(umo, vmo), mlotst,
                                                self.case.lev, self.tripolar)
        return self._ops[key]


def setup_gaps(setup, ref: Reference) -> dict:
    """The grid metrics and the face fluxes that set-up derived, against
    the reference's from the case's own transports."""
    case = ref.case
    return {"grid_gap": worst_gap(setup.grid, ref.grid),
            "flux_gap": worst_gap(setup.fluxes, ref.fluxes(case.umo, case.vmo))}


def zero_land(x: torch.Tensor, wet: torch.Tensor) -> torch.Tensor:
    return torch.where(wet, torch.nan_to_num(x.to(torch.float64), nan=0.0), 0.0)


def finite_on_wet(x: torch.Tensor, wet: torch.Tensor) -> bool:
    return bool(torch.isfinite(torch.where(wet, x, 0.0)).all())
