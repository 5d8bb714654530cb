"""The system under test, `otmb_tpu_torch`, driven through its public path.

`Setup` builds a case the way a modeller does from CMIP fields: grid
metrics (`makegridmetrics`), indices (`makeindices`), face fluxes
(`facefluxesfrommasstransport`), and the operator from the transports
(`assemble_T`, the K4 kernel), in the precision the cell states. It keeps
what set-up derived for the check.

The control puts the plain reference in the program's place for these
products, stored in the next precision below (float64 -> float32,
float32 -> bfloat16): computed in float64 and rounded once, since grid
geometry computed in bfloat16 arithmetic is no number at all (its
longitudes step by 2 degrees, neighbour distances come out 0 and the legs
infinite). It hands them to the program's own lower-precision path for
the timed work (the bf16-narrow solves and K5's bf16 legs).
"""

from __future__ import annotations

import dataclasses

import torch

from . import reference

DTYPES = {"float64": torch.float64, "float32": torch.float32}
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}
GRID_FIELDS = ("area2d", "v3d", "thkcello", "z3d")
SIDES = ("east", "west", "north", "south")


def port():
    import otmb_tpu_torch

    return otmb_tpu_torch


@dataclasses.dataclass
class Context:
    """What a cell's set-up gets: the raw case, the cell's files, its seed,
    its device, and whether it runs as the control."""

    case: object
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    control: bool = False

    @property
    def dtype(self) -> torch.dtype:
        stated = DTYPES[self.traffic.get("dtype", self.config["dtype"])]
        return LOWER[stated] if self.control else stated

    @property
    def tripolar(self) -> bool:
        return self.case.topology == "tripolar"


class Setup:
    """The case through the port's set-up path (or the control's): `topo`,
    `wet`, `assemble(umo, vmo, mlotst)`, and `grid` and `fluxes`, the
    derived fields the check compares."""

    def __init__(self, ctx: Context):
        P = port()
        case, dtype = ctx.case, ctx.dtype
        self.topo = P.detect_topology(case.lon_vertices, case.lat_vertices, case.shape[0])
        if ctx.control:
            self.wet = torch.isfinite(case.volcello)
            grid = reference.grid_metrics(case)
            lower = lambda d: {k: v.to(dtype) for k, v in d.items()}
            self.grid = lower(grid)
            self.fluxes = lower(reference.face_fluxes(case.umo, case.vmo, self.wet,
                                                      ctx.tripolar))

            def assemble(umo, vmo, mlotst):
                phi = reference.face_fluxes(umo, vmo, self.wet, ctx.tripolar)
                legs = reference.operator(grid, phi, mlotst, case.lev, ctx.tripolar)
                return P.StencilCoeffs(**lower(legs))

            self.assemble = assemble
            return
        gm = P.makegridmetrics(areacello=case.areacello, volcello=case.volcello.cpu().numpy(),
                               lon=case.lon, lat=case.lat, lev=case.lev,
                               lon_vertices=case.lon_vertices, lat_vertices=case.lat_vertices,
                               dtype=dtype, device=ctx.device)
        idx = P.makeindices(gm.v3d)
        phi = P.facefluxesfrommasstransport(umo=case.umo, vmo=case.vmo, gridmetrics=gm,
                                            indices=idx)
        self.topo, self.wet = gm.topology, idx.wet3d
        self.grid = {name: getattr(gm, name) for name in GRID_FIELDS}
        for group in ("edge_length", "distance_to_edge", "distance_to_neighbour"):
            for d in SIDES:
                self.grid[f"{group}.{d}"] = getattr(gm, group)[d]
        self.fluxes = phi._asdict()
        self.assemble = lambda umo, vmo, mlotst: P.assemble_T(umo, vmo, mlotst, gm)


def legs(coeffs) -> dict:
    """The seven legs of a `StencilCoeffs`, by name."""
    return coeffs._asdict()


def surface(wet: torch.Tensor, rate: float, dtype) -> torch.Tensor:
    """The surface restoring diagonal: `rate` on the wet surface layer."""
    d = torch.zeros(wet.shape, dtype=dtype, device=wet.device)
    d[0] = rate
    return torch.where(wet, d, 0.0)
