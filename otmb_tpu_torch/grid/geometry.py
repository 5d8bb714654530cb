"""Grid-cell geometry: haversine metrics and `makegridmetrics`.

Counterpart of `otmb_tpu.grid.geometry` (reference gridcellgeometry.jl).
Canonicalisation (NaN fill values, vertex order, thickness and depth) is
host numpy work; the haversine metrics are evaluated in torch, in the
requested dtype on the requested device, like the JAX package evaluates
them in its array dtype.

Layout: 2D fields (ny, nx), 3D fields (nz, ny, nx), vertex fields
(4, ny, nx) ordered SW, SE, NE, NW (gridcellgeometry.jl:149-156).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EARTH_RADIUS
from ..utils.device import default_device
from ..utils.tracing import traced
from .topology import GridTopology, detect_topology, neighbor_values

# Vertex indices delimiting each directed cell edge, 0-based
# (reference `vertexindices`, gridcellgeometry.jl:209-215).
EDGE_VERTICES = {
    "south": (0, 1),
    "east": (1, 2),
    "north": (2, 3),
    "west": (0, 3),
}


def cell_thickness_from_lev_bnds(lev_bnds, ny: int, nx: int, device=None) -> torch.Tensor:
    """Cell thickness from level bounds (2, nz) or (nz, 2), broadcast to
    (nz, ny, nx): the reference's `cellthickness(lev_bnds::Matrix, ...)`
    (gridcellgeometry.jl:236), for datasets without a volcello-derived
    thickness. A tensor stays on its device and dtype; host data becomes an
    f64 tensor on `device` (None: the current CUDA device, raising without
    one)."""
    if not isinstance(lev_bnds, torch.Tensor):
        lev_bnds = torch.as_tensor(np.asarray(lev_bnds, dtype=np.float64),
                                   device=default_device(device))
    if lev_bnds.ndim != 2 or 2 not in lev_bnds.shape:
        raise ValueError(f"lev_bnds must be (2, nz) or (nz, 2), got {tuple(lev_bnds.shape)}")
    if lev_bnds.shape[0] != 2:
        lev_bnds = lev_bnds.T
    thick = torch.abs(lev_bnds[1] - lev_bnds[0])  # (nz,)
    return thick[:, None, None].expand(thick.shape[0], ny, nx)


def haversine(lon1, lat1, lon2, lat2, radius: float = EARTH_RADIUS):
    """Great-circle distance (m) between (lon, lat) points in degrees, as
    Distances.jl's `haversine`. NaN inputs give NaN."""
    phi1 = torch.deg2rad(lat1)
    phi2 = torch.deg2rad(lat2)
    dphi = phi2 - phi1
    dlam = torch.deg2rad(lon2 - lon1)
    a = torch.sin(dphi / 2) ** 2 + torch.cos(phi1) * torch.cos(phi2) * torch.sin(dlam / 2) ** 2
    # clip guards tiny negative/overshoot from rounding
    return 2 * radius * torch.arcsin(torch.sqrt(torch.clip(a, 0.0, 1.0)))


def midpoint_on_sphere(lon_a, lat_a, lon_b, lat_b):
    """Edge midpoint, shifted by 180 degrees of longitude when the edge
    crosses the map's edge (`midpointonsphere`, gridcellgeometry.jl:249-255)."""
    crosses = torch.abs(lon_a - lon_b) >= 180.0
    mid_lon = (lon_a + lon_b) / 2 + torch.where(crosses, 180.0, 0.0).to(lon_a.dtype)
    mid_lat = (lat_a + lat_b) / 2
    return mid_lon, mid_lat


def vertex_permutation(lon_vertices: np.ndarray, lat_vertices: np.ndarray) -> list[int]:
    """Permutation putting the 4 cell vertices into SW, SE, NE, NW order
    (`vertexpermutation`, gridcellgeometry.jl:158-178): intersect the
    vertex sets of cell (0,0) with its east and north neighbours."""
    lon_vertices = np.asarray(lon_vertices)
    lat_vertices = np.asarray(lat_vertices)
    if not lon_vertices.shape[0] == lat_vertices.shape[0] == 4:
        raise ValueError("vertex arrays must be (4, ny, nx)")

    def cell_points(j, i):
        return [(float(lon_vertices[v, j, i]), float(lat_vertices[v, j, i]))
                for v in range(4)]

    points = cell_points(0, 0)
    points_east = set(cell_points(0, 1))
    points_north = set(cell_points(1, 0))

    idx_east = {v for v, p in enumerate(points) if p in points_east}
    idx_north = {v for v, p in enumerate(points) if p in points_north}
    (idx3,) = idx_east & idx_north  # shared with both east and north cells => NE
    (idx2,) = idx_east - {idx3}  # shared with east only => SE
    (idx4,) = idx_north - {idx3}  # shared with north only => NW
    (idx1,) = set(range(4)) - {idx2, idx3, idx4}  # unique to this cell => SW
    return [idx1, idx2, idx3, idx4]


@dataclasses.dataclass(frozen=True)
class PerDirection:
    """A (ny, nx) tensor per horizontal direction."""

    east: torch.Tensor
    west: torch.Tensor
    north: torch.Tensor
    south: torch.Tensor

    def __getitem__(self, direction: str) -> torch.Tensor:
        return getattr(self, direction)


@dataclasses.dataclass(frozen=True)
class GridMetrics:
    """All grid geometry (reference `gridmetrics`, gridcellgeometry.jl:310)."""

    area2d: torch.Tensor  # (ny, nx) horizontal cell area, m^2
    v3d: torch.Tensor  # (nz, ny, nx) cell volume, m^3, NaN on land
    thkcello: torch.Tensor  # (nz, ny, nx) cell thickness, m
    lon: torch.Tensor  # (ny, nx) cell-centre longitude, deg
    lat: torch.Tensor  # (ny, nx) cell-centre latitude, deg
    lon_vertices: torch.Tensor  # (4, ny, nx) SW,SE,NE,NW
    lat_vertices: torch.Tensor  # (4, ny, nx)
    z3d: torch.Tensor  # (nz, ny, nx) cell-centre depth, m
    zt: torch.Tensor  # (nz,) nominal level depth, m
    edge_length: PerDirection  # m
    distance_to_edge: PerDirection  # m
    distance_to_neighbour: PerDirection  # m, NaN where no neighbour
    topology: GridTopology

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.topology.shape3d


def _nanify(x, fill_value) -> np.ndarray:
    """Replace fill values, non-finite and zero entries with NaN
    (gridcellgeometry.jl:269-280)."""
    x = np.ma.filled(np.ma.masked_invalid(np.asarray(x, dtype=np.float64)), np.nan)
    x = np.where(x == 0.0, np.nan, x)
    if fill_value is not None:
        x = np.where(x == fill_value, np.nan, x)
    return x


def edge_lengths(lon_vertices, lat_vertices) -> PerDirection:
    """Haversine length of each cell edge (`verticalfacewidth`,
    gridcellgeometry.jl:217-222)."""
    return PerDirection(**{
        d: haversine(lon_vertices[a], lat_vertices[a], lon_vertices[b], lat_vertices[b])
        for d, (a, b) in EDGE_VERTICES.items()
    })


def distances_to_edge(lon, lat, lon_vertices, lat_vertices) -> PerDirection:
    """Haversine distance from cell centre to each edge midpoint
    (`centroid2edgedistance`, gridcellgeometry.jl:240-247)."""
    out = {}
    for d, (a, b) in EDGE_VERTICES.items():
        mid_lon, mid_lat = midpoint_on_sphere(
            lon_vertices[a], lat_vertices[a], lon_vertices[b], lat_vertices[b]
        )
        out[d] = haversine(lon, lat, mid_lon, mid_lat)
    return PerDirection(**out)


def distances_to_neighbour(lon, lat, topology: GridTopology) -> PerDirection:
    """Haversine distance between neighbouring cell centres, NaN where the
    neighbour does not exist (`horizontaldistance`, gridcellgeometry.jl:182-189)."""
    out = {}
    for d in ("east", "west", "north", "south"):
        out[d] = haversine(lon, lat, neighbor_values(lon, d, topology),
                           neighbor_values(lat, d, topology))
    return PerDirection(**out)


@traced
def makegridmetrics(
    *,
    areacello,
    volcello,
    lon,
    lat,
    lev,
    lon_vertices,
    lat_vertices,
    fill_value: float | None = None,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> GridMetrics:
    """Build all grid metrics from raw CMIP-style numpy fields
    (reference `makegridmetrics`, gridcellgeometry.jl:265-311).

    Inputs are in canonical order: `areacello` (ny, nx), `volcello`
    (nz, ny, nx), `lon`/`lat` (ny, nx), `lev` (nz,), vertices (4, ny, nx)
    in any vertex order. Zeros, non-finite and masked entries (and
    `fill_value`) become NaN. The tensors are made in `dtype` on `device`:
    None is the current CUDA device, and raises without one (pass
    `device="cpu"` for the CPU).
    """
    if not dtype.is_floating_point:
        raise ValueError("dtype must be a floating dtype")
    device = default_device(device)

    v3d = _nanify(volcello, fill_value)
    area2d = _nanify(areacello, fill_value)
    if v3d.ndim != 3:
        raise ValueError(f"volcello must be (nz, ny, nx), got shape {v3d.shape}")
    nz, ny, nx = v3d.shape
    if area2d.shape != (ny, nx):
        raise ValueError(
            f"areacello shape {area2d.shape} does not match volcello {(ny, nx)}"
        )

    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    zt = np.asarray(lev, dtype=np.float64).reshape(-1)
    lon_vertices = np.asarray(lon_vertices, dtype=np.float64)
    lat_vertices = np.asarray(lat_vertices, dtype=np.float64)
    if lon_vertices.shape != (4, ny, nx):
        raise ValueError(
            f"lon_vertices must be (4, ny, nx)={(4, ny, nx)}, got {lon_vertices.shape}"
        )

    # Canonicalise vertex order (reference gridcellgeometry.jl:296-298).
    perm = vertex_permutation(lon_vertices, lat_vertices)
    lon_vertices = lon_vertices[perm]
    lat_vertices = lat_vertices[perm]

    # Thickness and depth (reference gridcellgeometry.jl:283-285).
    thkcello = v3d / area2d
    z3d = np.cumsum(thkcello, axis=0) - 0.5 * thkcello

    topology = detect_topology(lon_vertices, lat_vertices, nz)

    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    lon_t, lat_t = t(lon), t(lat)
    vlon_t, vlat_t = t(lon_vertices), t(lat_vertices)
    return GridMetrics(
        area2d=t(area2d),
        v3d=t(v3d),
        thkcello=t(thkcello),
        lon=lon_t,
        lat=lat_t,
        lon_vertices=vlon_t,
        lat_vertices=vlat_t,
        z3d=t(z3d),
        zt=t(zt),
        edge_length=edge_lengths(vlon_t, vlat_t),
        distance_to_edge=distances_to_edge(lon_t, lat_t, vlon_t, vlat_t),
        distance_to_neighbour=distances_to_neighbour(lon_t, lat_t, topology),
        topology=topology,
    )
