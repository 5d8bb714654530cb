"""Velocity <-> flux conversion and Arakawa grid handling.

Counterpart of `otmb_tpu.ops.velocities` (reference velocities.jl:1-108
and gridcellgeometry.jl:1-140). The staggering is classified on the host
from one cell's points; the conversions run on the device of the grid
metrics.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..grid.geometry import GridMetrics, haversine, midpoint_on_sphere
from ..grid.indices import Indices
from ..grid.topology import GridTopology, neighbor_values
from .fluxes import FaceFluxes, facefluxes


@dataclasses.dataclass(frozen=True)
class ArakawaGrid:
    """Grid staggering (reference AGridCell/BGridCell/CGridCell,
    gridcellgeometry.jl:1-16)."""

    kind: str  # "A", "B", or "C"
    u_pos: str  # one of C, N, S, E, W, NE, NW, SE, SW
    v_pos: str


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def getarakawagrid(u_lon, u_lat, v_lon, v_lat, gridmetrics: GridMetrics) -> ArakawaGrid:
    """Classify the staggering of (u, v) points as Arakawa A, B or C
    (`getarakawagrid`, gridcellgeometry.jl:50-95): locate the u and v
    points of cell (0, 0) among its centre, edge midpoints and corners by
    haversine distance. Host work on cell (0, 0) only."""
    lon, lat = _host(gridmetrics.lon), _host(gridmetrics.lat)
    vlon, vlat = _host(gridmetrics.lon_vertices), _host(gridmetrics.lat_vertices)
    scalar = lambda x: torch.tensor(float(x), dtype=torch.float64)

    j = i = 0
    u_point = (float(_host(u_lon)[j, i]), float(_host(u_lat)[j, i]))
    v_point = (float(_host(v_lon)[j, i]), float(_host(v_lat)[j, i]))
    corners = {
        "SW": (vlon[0, j, i], vlat[0, j, i]),
        "SE": (vlon[1, j, i], vlat[1, j, i]),
        "NE": (vlon[2, j, i], vlat[2, j, i]),
        "NW": (vlon[3, j, i], vlat[3, j, i]),
    }

    def mid(a, b):
        ml, mt = midpoint_on_sphere(scalar(a[0]), scalar(a[1]), scalar(b[0]), scalar(b[1]))
        return (float(ml), float(mt))

    cell = {
        "C": (lon[j, i], lat[j, i]),
        **corners,
        "S": mid(corners["SW"], corners["SE"]),
        "N": mid(corners["NE"], corners["NW"]),
        "W": mid(corners["SW"], corners["NW"]),
        "E": mid(corners["SE"], corners["NE"]),
    }

    def dist(p, q):
        return float(haversine(scalar(p[0]), scalar(p[1]), scalar(q[0]), scalar(q[1])))

    u_pos, u_dist = min(((k, dist(p, u_point)) for k, p in cell.items()), key=lambda kv: kv[1])
    v_pos, v_dist = min(((k, dist(p, v_point)) for k, p in cell.items()), key=lambda kv: kv[1])

    if u_pos == v_pos == "C":
        kind = "A"
    elif u_pos == v_pos and u_pos in ("NE", "NW", "SE", "SW"):
        kind = "B"
    elif u_pos in ("E", "W") and v_pos in ("N", "S"):
        kind = "C"
    else:
        raise ValueError(f"Unknown Arakawa grid type (u at {u_pos}, v at {v_pos})")

    perimeter = (dist(corners["SW"], corners["SE"]) + dist(corners["SE"], corners["NE"])
                 + dist(corners["NE"], corners["NW"]) + dist(corners["NW"], corners["SW"]))
    relerr = (u_dist + v_dist) / perimeter
    if relerr > 0.01:
        warnings.warn(f"Relative error in grid positions of {kind}-grid is {relerr:.3g}")
    return ArakawaGrid(kind=kind, u_pos=u_pos, v_pos=v_pos)


def interpolateontodefaultCgrid(u, u_lon, u_lat, v, v_lon, v_lat, gridmetrics: GridMetrics,
                                arakawa: ArakawaGrid | None = None,
                                fill_value: float | None = None):
    """(u, v) on the default C-grid (east/north faces)
    (`interpolateontodefaultCgrid`, gridcellgeometry.jl:103-140): the
    C-grid is the identity; B-grid (NE) averages the two corner velocities
    along each face, zero-padded at the open boundary, after NaN and
    `fill_value` become 0; an A-grid is not supported, as in the reference.

    Returns (u, u_lon, u_lat, v, v_lon, v_lat) on the C-grid."""
    if arakawa is None:
        arakawa = getarakawagrid(u_lon, u_lat, v_lon, v_lat, gridmetrics)
    if arakawa.kind == "C":
        return u, u_lon, u_lat, v, v_lon, v_lat
    if arakawa.kind == "A":
        raise NotImplementedError("Interpolation not implemented for A-grid type")
    if not (arakawa.u_pos == arakawa.v_pos == "NE"):
        raise NotImplementedError(
            f"Interpolation not implemented for this B-grid({arakawa.u_pos},{arakawa.v_pos}) type")

    def clean(x):
        x = torch.where(torch.isfinite(x), x, 0.0)
        if fill_value is not None:
            x = torch.where(x == fill_value, 0.0, x)
        return x

    u2, v2 = clean(u), clean(v)
    # B(NE) -> C: the NE-corner velocity averaged with the one at j-1 for u
    # (east-face midpoint) and at i-1 for v (north-face midpoint), zero at
    # the open boundary (gridcellgeometry.jl:127-128).
    u2 = 0.5 * (u2 + torch.cat([torch.zeros_like(u2[..., :1, :]), u2[..., :-1, :]], dim=-2))
    v2 = 0.5 * (v2 + torch.cat([torch.zeros_like(v2[..., :, :1]), v2[..., :, :-1]], dim=-1))
    vlon, vlat = gridmetrics.lon_vertices, gridmetrics.lat_vertices
    u2_lon, u2_lat = midpoint_on_sphere(vlon[1], vlat[1], vlon[2], vlat[2])  # SE-NE
    v2_lon, v2_lat = midpoint_on_sphere(vlon[2], vlat[2], vlon[3], vlat[3])  # NE-NW
    return u2, u2_lon, u2_lat, v2, v2_lon, v2_lat


def _two_cell_nanmean(x, direction, topology: GridTopology):
    """NaN-aware mean of a cell and its `direction` neighbour (reference
    twocellnanmean, velocities.jl:77-93); a scalar passes through; NaN
    where both are missing."""
    if not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    nb = neighbor_values(x, direction, topology)
    wa, wb = torch.isfinite(x), torch.isfinite(nb)
    num = torch.where(wa, x, 0.0) + torch.where(wb, nb, 0.0)
    return num / (wa.to(x.dtype) + wb.to(x.dtype))


def _two_cell_nanmin(x, direction, topology: GridTopology):
    """NaN-aware min of a cell and its `direction` neighbour (reference
    twocellnanmin, velocities.jl:96-108)."""
    nb = neighbor_values(x, direction, topology)
    return torch.where(torch.isnan(x), nb,
                       torch.where(torch.isnan(nb), x, torch.minimum(x, nb)))


def velocity2fluxes(u, u_lon, u_lat, v, v_lon, v_lat, gridmetrics: GridMetrics, rho,
                    fill_value: float | None = None, arakawa_kind: str | None = None):
    """Mass fluxes (kg/s) through east/north faces from C- or B-grid
    velocities (m/s) (`velocity2fluxes`, velocities.jl:10-39): B -> C if
    needed, then u * the pair's mean rho * the pair's min thickness * the
    edge length, the pair taken along the face. `arakawa_kind="C"` skips
    the classification (the points may then be None); `rho` is a scalar or
    a (nz, ny, nx) tensor."""
    topo = gridmetrics.topology
    if arakawa_kind != "C":
        u, _, _, v, _, _ = interpolateontodefaultCgrid(
            u, u_lon, u_lat, v, v_lon, v_lat, gridmetrics, fill_value=fill_value)
    thk = gridmetrics.thkcello
    phi_i = (u * _two_cell_nanmean(rho, "east", topo) * _two_cell_nanmin(thk, "east", topo)
             * gridmetrics.edge_length.east)
    phi_j = (v * _two_cell_nanmean(rho, "north", topo) * _two_cell_nanmin(thk, "north", topo)
             * gridmetrics.edge_length.north)
    return phi_i, phi_j


def fluxes2velocity(phi_i, phi_j, gridmetrics: GridMetrics, rho):
    """Inverse of `velocity2fluxes` (velocities.jl:50-74)."""
    topo = gridmetrics.topology
    thk = gridmetrics.thkcello
    u = phi_i / (_two_cell_nanmean(rho, "east", topo) * _two_cell_nanmin(thk, "east", topo)
                 * gridmetrics.edge_length.east)
    v = phi_j / (_two_cell_nanmean(rho, "north", topo) * _two_cell_nanmin(thk, "north", topo)
                 * gridmetrics.edge_length.north)
    return u, v


def facefluxesfromvelocities(*, uo, uo_lon, uo_lat, vo, vo_lon, vo_lat,
                             gridmetrics: GridMetrics, indices: Indices, rho,
                             fill_value: float | None = None) -> FaceFluxes:
    """Six-face fluxes from velocities (`facefluxesfromvelocities`,
    velocities.jl:140-151); numpy or tensor velocities move to the grid's
    dtype and device."""
    v3d = gridmetrics.v3d
    as_grid = lambda x: torch.as_tensor(x, dtype=v3d.dtype, device=v3d.device)
    umo, vmo = velocity2fluxes(as_grid(uo), uo_lon, uo_lat, as_grid(vo), vo_lon, vo_lat,
                               gridmetrics, rho, fill_value=fill_value)
    return facefluxes(umo, vmo, indices.wet3d, gridmetrics.topology, fill_value=fill_value)
