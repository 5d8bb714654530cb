"""The plain reference: what the program computes, recomputed from the raw
inputs in plain PyTorch, in float64.

It follows the published semantics of OceanTransportMatrixBuilder.jl
(gridcellgeometry.jl, velocities.jl, matrixbuilding.jl) on dense
(nz, ny, nx) fields: grid metrics by haversine from the cell vertices,
six-face mass fluxes closed vertically by mass conservation, the operator
T = Tadv (upwind) + TkH + TkVML + TkVdeep as seven stencil legs, its
7-point application with the tripolar fold, and the explicit Euler step.
It imports nothing of the program and takes nothing the program made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EARTH_RADIUS = 6_371_000.0
RHO = 1035.0
KAPPA_H = 500.0
KAPPA_VML = 0.1
KAPPA_VDEEP = 1.0e-5

HORIZONTAL = ("east", "west", "north", "south")
DIRECTIONS = HORIZONTAL + ("top", "bottom")
LEGS = ("diag",) + DIRECTIONS
OPPOSITE = {"east": "west", "west": "east", "north": "south", "south": "north"}
# the vertices bounding each cell edge, in SW, SE, NE, NW order
EDGE = {"south": (0, 1), "east": (1, 2), "north": (2, 3), "west": (0, 3)}


def neighbour(x: torch.Tensor, d: str, tripolar: bool, fill=0.0) -> torch.Tensor:
    """The value at each cell's `d`-neighbour (i periodic; past the top row
    the tripolar fold i -> nx - 1 - i, else none; none past j = 0 or either
    k end), `fill` where there is none. x is (..., ny, nx) for horizontal
    directions, (..., nz, ny, nx) for vertical ones."""
    out = torch.full_like(x, fill)
    if d == "east":
        out[..., :-1] = x[..., 1:]
        out[..., -1] = x[..., 0]
    elif d == "west":
        out[..., 1:] = x[..., :-1]
        out[..., 0] = x[..., -1]
    elif d == "north":
        out[..., :-1, :] = x[..., 1:, :]
        if tripolar:
            out[..., -1, :] = x[..., -1, :].flip(-1)
    elif d == "south":
        out[..., 1:, :] = x[..., :-1, :]
    elif d == "top":
        out[..., 1:, :, :] = x[..., :-1, :, :]
    elif d == "bottom":
        out[..., :-1, :, :] = x[..., 1:, :, :]
    else:
        raise ValueError(d)
    return out


def has_neighbour(d: str, shape, tripolar: bool, device) -> torch.Tensor:
    """True where the cell has a `d`-neighbour."""
    ok = torch.ones(shape, dtype=torch.bool, device=device)
    if d == "north" and not tripolar:
        ok[..., -1, :] = False
    elif d == "south":
        ok[..., 0, :] = False
    elif d == "top":
        ok[..., 0, :, :] = False
    elif d == "bottom":
        ok[..., -1, :, :] = False
    return ok


def haversine(lon1, lat1, lon2, lat2):
    p1, p2 = torch.deg2rad(lat1), torch.deg2rad(lat2)
    a = (torch.sin((p2 - p1) / 2) ** 2
         + torch.cos(p1) * torch.cos(p2) * torch.sin(torch.deg2rad(lon2 - lon1) / 2) ** 2)
    return 2 * EARTH_RADIUS * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def grid_metrics(case) -> dict:
    """Grid metrics of a raw case: area2d, v3d, thkcello, z3d (NaN on
    land), and per direction the edge length, the distance from the centre
    to the edge's midpoint and to the neighbour's centre (NaN where none),
    keyed "edge_length.east", ..."""
    dev = case.volcello.device
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)
    tripolar = case.topology == "tripolar"
    area = t(case.areacello)
    v3d = case.volcello.to(torch.float64)
    thk = v3d / area
    out = {"area2d": area, "v3d": v3d, "thkcello": thk, "z3d": torch.cumsum(thk, 0) - thk / 2}
    lon, lat = t(case.lon), t(case.lat)
    vlon, vlat = t(case.lon_vertices), t(case.lat_vertices)
    for d, (a, b) in EDGE.items():
        out[f"edge_length.{d}"] = haversine(vlon[a], vlat[a], vlon[b], vlat[b])
        mid_lon = (vlon[a] + vlon[b]) / 2 + 180.0 * (torch.abs(vlon[a] - vlon[b]) >= 180.0)
        out[f"distance_to_edge.{d}"] = haversine(lon, lat, mid_lon, (vlat[a] + vlat[b]) / 2)
        dist = haversine(lon, lat, neighbour(lon, d, tripolar), neighbour(lat, d, tripolar))
        out[f"distance_to_neighbour.{d}"] = torch.where(
            has_neighbour(d, lon.shape, tripolar, dev), dist, math.nan)
    return out


def face_fluxes(umo, vmo, wet, tripolar: bool) -> dict:
    """Mass flux (kg/s) through each face: east and north from umo and vmo
    (0 where either side is land or the face has no far side), west and
    south the neighbours' east and north, top and bottom from the
    divergence summed up from the floor."""
    umo, vmo = (torch.nan_to_num(x.to(torch.float64), nan=0.0) for x in (umo, vmo))
    east = torch.where(wet & neighbour(wet, "east", tripolar, False), umo, 0.0)
    north_ok = neighbour(wet, "north", tripolar, False) & has_neighbour(
        "north", wet.shape, tripolar, wet.device)
    north = torch.where(wet & north_ok, vmo, 0.0)
    west = neighbour(east, "west", tripolar)
    south = neighbour(north, "south", tripolar)
    top = (west + south - east - north).flip(0).cumsum(0).flip(0)
    bottom = neighbour(top, "bottom", tripolar)
    return {"east": east, "west": west, "north": north, "south": south, "top": top,
            "bottom": bottom}


def _ratio(num, den):
    """num / den where num != 0, else exactly 0 (den may be NaN there)."""
    return torch.where(num != 0, num / torch.where(num != 0, den, 1.0), 0.0)


def operator(grid: dict, phi: dict, mlotst, lev, tripolar: bool) -> dict:
    """The seven legs of T = Tadv + TkH + TkVML + TkVdeep (1/s):
    (T x)[c] = diag[c] x[c] + sum_d leg_d[c] x[nb_d(c)]."""
    v3d, thk = grid["v3d"], grid["thkcello"]
    dtype, dev = v3d.dtype, v3d.device
    wet = torch.isfinite(v3d)
    nz = v3d.shape[0]
    legs = {name: torch.zeros_like(v3d) for name in LEGS}

    # upwind advection: the receiver's leg -influx/m, the donor's diagonal
    # +outflux/m, m = rho * v; no surface top face (evaporation)
    surface = (torch.arange(nz, device=dev) == 0).reshape(nz, 1, 1)
    pos = lambda f: torch.clamp(f, min=0.0)
    neg = lambda f: torch.clamp(-f, min=0.0)
    mass = RHO * v3d
    influx = {"west": pos(phi["west"]), "east": neg(phi["east"]), "south": pos(phi["south"]),
              "north": neg(phi["north"]), "bottom": pos(phi["bottom"]),
              "top": torch.where(surface, 0.0, neg(phi["top"]))}
    north_out = pos(phi["north"])
    if tripolar:
        # across the seam the folded cell receives through its own north face
        north_out[:, -1, :] = neg(phi["north"][:, -1, :].flip(-1))
    outflux = {"east": pos(phi["east"]), "west": neg(phi["west"]), "south": neg(phi["south"]),
               "north": north_out, "bottom": neg(phi["bottom"]),
               "top": torch.where(surface, 0.0, pos(phi["top"]))}
    for d in DIRECTIONS:
        legs[d] = legs[d] - _ratio(influx[d], mass)
        legs["diag"] = legs["diag"] + _ratio(outflux[d], mass)

    # horizontal diffusion: kappa_h * min(face areas) / (distance * v)
    for d in HORIZONTAL:
        own = thk * grid[f"edge_length.{d}"]
        far = neighbour(thk * grid[f"edge_length.{OPPOSITE[d]}"], d, tripolar)
        if d == "north" and tripolar:
            far[:, -1, :] = (thk * grid["edge_length.north"])[:, -1, :].flip(-1)
        on = wet & neighbour(wet, d, tripolar, False) & has_neighbour(d, wet.shape, tripolar, dev)
        rate = torch.where(on, KAPPA_H * torch.minimum(own, far)
                           / torch.where(on, grid[f"distance_to_neighbour.{d}"] * v3d, 1.0), 0.0)
        legs[d] = legs[d] - rate
        legs["diag"] = legs["diag"] + rate

    # vertical diffusion: kappa * area / (|dz| * v) between two cells both
    # in the mask (mixed layer: both above mlotst; deep: all wet cells)
    zt = torch.as_tensor(np.asarray(lev, dtype=np.float64), device=dev).to(dtype).reshape(nz, 1, 1)
    ml = mlotst.to(dtype)
    area = grid["area2d"]
    for kappa, mask in ((KAPPA_VML, wet & torch.isfinite(ml) & (zt < ml)), (KAPPA_VDEEP, wet)):
        for d in ("top", "bottom"):
            on = mask & neighbour(mask, d, tripolar, False)
            dz = torch.abs(zt - neighbour(zt, d, tripolar, math.nan))
            rate = torch.where(on, kappa * area / torch.where(on, dz * v3d, 1.0), 0.0)
            legs[d] = legs[d] - rate
            legs["diag"] = legs["diag"] + rate
    return {name: torch.where(wet, leg, 0.0) for name, leg in legs.items()}


def apply(legs: dict, x: torch.Tensor, tripolar: bool) -> torch.Tensor:
    """T x for one field (nz, ny, nx), in x's dtype."""
    y = legs["diag"].to(x.dtype) * x
    for d in DIRECTIONS:
        y = y + legs[d].to(x.dtype) * neighbour(x, d, tripolar)
    return y


def euler(legs: dict, x: torch.Tensor, dt: float, nsteps: int, tripolar: bool) -> torch.Tensor:
    """`nsteps` explicit Euler steps x <- x - dt T x."""
    for _ in range(nsteps):
        x = x - dt * apply(legs, x, tripolar)
    return x


def local_residual(legs: dict, x: torch.Tensor, b: torch.Tensor, extra: torch.Tensor,
                   tripolar: bool) -> float:
    """The largest |(T + diag(extra)) x - b| / (diag + extra) over the wet
    cells (x, b zero on land): the error in x that each cell's residual
    implies there, in x's units, in float64."""
    x, b, extra = x.to(torch.float64), b.to(torch.float64), extra.to(torch.float64)
    d = legs["diag"].to(torch.float64) + extra
    r = apply(legs, x, tripolar) + extra * x - b
    return float(torch.where(d != 0, r.abs() / torch.where(d != 0, d, 1.0), 0.0).max())


def relative_residual(legs: dict, x: torch.Tensor, b: torch.Tensor, extra: torch.Tensor,
                      tripolar: bool, ord: float = 2) -> float:
    """||(T + diag(extra)) x - b|| / ||b|| over the wet cells (x, b zero on
    land), in float64, in the 2-norm or (ord=inf) the largest cell's."""
    x, b = x.to(torch.float64), b.to(torch.float64)
    r = apply(legs, x, tripolar) + extra.to(torch.float64) * x - b
    return float(torch.linalg.vector_norm(r, ord) / torch.linalg.vector_norm(b, ord))
