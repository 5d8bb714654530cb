"""Synthetic CMIP-like test grids (numpy).

The same construction and the same random-number calls as
`otmb_tpu.utils.synthetic.synthetic_dataset`, so one seed gives
bit-identical fields in both packages:

  * bipolar: regular lat-lon grid whose top edge lies on lat=90
    (reference detection rule, gridtopology.jl:41-42);
  * tripolar: the top edge is a constant-latitude seam whose vertex
    longitudes are palindromic in i, so the north edge maps onto itself
    under rot180 (gridtopology.jl:44).
"""

from __future__ import annotations

import dataclasses

import math

import numpy as np
import torch

from ..config import EARTH_RADIUS
from .device import default_device


@dataclasses.dataclass
class SyntheticDataset:
    """Raw fields in canonical layout, as a CMIP dataset would provide."""

    areacello: np.ndarray  # (ny, nx)
    volcello: np.ndarray  # (nz, ny, nx), NaN on land
    lon: np.ndarray  # (ny, nx)
    lat: np.ndarray  # (ny, nx)
    lev: np.ndarray  # (nz,)
    lon_vertices: np.ndarray  # (4, ny, nx)
    lat_vertices: np.ndarray  # (4, ny, nx)
    umo: np.ndarray  # (nz, ny, nx) eastward mass transport, kg/s
    vmo: np.ndarray  # (nz, ny, nx) northward mass transport, kg/s
    mlotst: np.ndarray  # (ny, nx) mixed-layer depth, m
    wet3d: np.ndarray  # (nz, ny, nx) bool (ground truth)


def _level_thicknesses(nz: int) -> np.ndarray:
    """Ocean-like stretched levels: ~10 m at the top, growing with depth."""
    return 10.0 * (1.0 + 0.35 * np.arange(nz))


def _cell_areas(lat_edges: np.ndarray, nx: int) -> np.ndarray:
    """Exact spherical quad areas for a regular lat-lon grid, (ny, nx)."""
    dlam = 2 * np.pi / nx
    band = EARTH_RADIUS**2 * dlam * np.diff(np.sin(np.deg2rad(lat_edges)))
    return np.repeat(band[:, None], nx, axis=1)


def _seafloor_levels(nx: int, ny: int, nz: int, rng: np.random.Generator,
                     land_fraction: float) -> np.ndarray:
    """Number of wet levels per column (0 => land column)."""
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    depth = (
        0.55
        + 0.35 * np.sin(2 * np.pi * ii / nx + 1.0) * np.cos(np.pi * jj / ny)
        + 0.25 * np.cos(4 * np.pi * ii / nx) * np.sin(2 * np.pi * jj / ny + 0.5)
    )
    kbot = np.clip(np.round(depth * nz), 1, nz).astype(int)
    if land_fraction > 0:
        # A continent: a lon-lat rectangle, plus random islands.
        i0, i1 = int(0.15 * nx), int(0.15 * nx + max(1, land_fraction * nx))
        j0, j1 = int(0.3 * ny), int(0.75 * ny)
        kbot[j0:j1, i0:i1] = 0
        n_islands = max(1, (nx * ny) // 50)
        isl_i = rng.integers(0, nx, n_islands)
        isl_j = rng.integers(0, ny, n_islands)
        kbot[isl_j, isl_i] = 0
    return kbot


def _smooth_field(shape, rng: np.random.Generator, scale: float) -> np.ndarray:
    """Random smooth 3D field via a few low-wavenumber harmonics."""
    nz, ny, nx = shape
    k = np.arange(nz)[:, None, None]
    j = np.arange(ny)[None, :, None]
    i = np.arange(nx)[None, None, :]
    out = np.zeros(shape)
    for _ in range(4):
        ak, aj, ai = rng.integers(1, 4, 3)
        pk, pj, pi = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(0.3, 1.0)
        out += amp * (
            np.cos(2 * np.pi * ai * i / nx + pi)
            * np.cos(np.pi * aj * j / ny + pj)
            * np.cos(np.pi * ak * k / nz + pk)
        )
    return scale * out


def _vertices(nx: int, ny: int, lat_edges: np.ndarray, lon_edges: np.ndarray):
    """Vertex arrays (4, ny, nx) of a regular lat-lon grid: SW, SE, NE, NW."""
    vlon = np.zeros((4, ny, nx))
    vlat = np.zeros((4, ny, nx))
    vlon[0] = lon_edges[None, :-1]
    vlon[1] = lon_edges[None, 1:]
    vlon[2] = lon_edges[None, 1:]
    vlon[3] = lon_edges[None, :-1]
    vlat[0] = lat_edges[:-1, None]
    vlat[1] = lat_edges[:-1, None]
    vlat[2] = lat_edges[1:, None]
    vlat[3] = lat_edges[1:, None]
    return vlon, vlat


def _north_edge(topology: str) -> float:
    if topology == "bipolar":
        return 90.0
    if topology == "tripolar":
        return 66.0
    raise ValueError(f"unknown topology {topology!r}")


def synthetic_device_case(nx: int, ny: int, nz: int, topology: str = "tripolar",
                          dtype: torch.dtype = torch.float32, seed: int = 0, device=None):
    """The large-scale benchmark case, its 3D fields made by torch ops on
    `device` (None: the current CUDA device, raising without one): only
    O(ny * nx) host arrays cross to the device. The JAX package's
    `synthetic_device_case`, step by step: the same numpy draws in the same
    order (the seafloor, then mlotst), the same vertices (the tripolar
    pole row included), the same flow harmonics with the tripolar vmo fold
    row, NaN on land.

    Returns (gridmetrics, wet3d, umo, vmo, mlotst). The grid is
    `synthetic_dataset`'s with `land_fraction=0.15` (the same wet mask for
    a seed); the flow is fixed harmonics, not `synthetic_dataset`'s random
    ones."""
    from ..grid import geometry as geo
    from ..grid.topology import detect_topology

    if nx % 2 != 0:
        raise ValueError("nx must be even for the tripolar fold")
    device = default_device(device)
    rng = np.random.default_rng(seed)

    lat_north_edge = _north_edge(topology)
    lat_edges = np.linspace(-78.0, lat_north_edge, ny + 1)
    lon_edges = np.linspace(0.0, 360.0, nx + 1)
    vlon, vlat = _vertices(nx, ny, lat_edges, lon_edges)
    if topology == "tripolar":
        p = np.empty(nx + 1)
        half = nx // 2
        p[: half + 1] = 80.0 + np.arange(half + 1) * (180.0 / half)
        for i in range(half + 1, nx + 1):
            p[i] = p[nx - i]
        vlon[3, ny - 1, :] = p[:-1]
        vlon[2, ny - 1, :] = p[1:]
        vlat[2:, ny - 1, :] = lat_north_edge

    lon2d = 0.5 * (lon_edges[:-1] + lon_edges[1:])[None, :].repeat(ny, axis=0)
    lat2d = 0.5 * (lat_edges[:-1] + lat_edges[1:])[:, None].repeat(nx, axis=1)

    thick = _level_thicknesses(nz)
    lev = np.cumsum(thick) - 0.5 * thick
    area = _cell_areas(lat_edges, nx)
    kbot = _seafloor_levels(nx, ny, nz, rng, land_fraction=0.15)
    topo = detect_topology(vlon, vlat, nz)

    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    area_d = t(np.where(kbot > 0, area, np.nan))
    thick_d = t(thick).reshape(nz, 1, 1)
    wet = torch.arange(nz, device=device).reshape(nz, 1, 1) < torch.as_tensor(
        kbot, device=device)[None]
    nan = torch.tensor(float("nan"), dtype=dtype, device=device)
    v3d = torch.where(wet, area_d[None] * thick_d, nan)
    thk = v3d / area_d[None]
    z3d = torch.cumsum(thk, dim=0) - 0.5 * thk
    # smooth flow harmonics, NaN junk on land like CMIP output
    k = torch.arange(nz, dtype=dtype, device=device).reshape(nz, 1, 1)
    j = torch.arange(ny, dtype=dtype, device=device).reshape(1, ny, 1)
    i = torch.arange(nx, dtype=dtype, device=device).reshape(1, 1, nx)
    pi = math.pi
    umo = 1e8 * (
        torch.cos(2 * pi * 2 * i / nx + 0.3)
        * torch.cos(pi * 1 * j / ny + 1.1)
        * torch.cos(pi * 2 * k / nz + 0.7)
        + 0.5 * torch.cos(2 * pi * 3 * i / nx + 2.0)
        * torch.cos(pi * 2 * j / ny)
    )
    vmo = 1e8 * (
        torch.cos(2 * pi * 1 * i / nx + 1.7)
        * torch.cos(pi * 2 * j / ny + 0.2)
        * torch.cos(pi * 1 * k / nz + 1.9)
    )
    if topo.is_tripolar:
        top = vmo[:, ny - 1, :]
        vmo[:, ny - 1, :] = 0.5 * (top - torch.flip(top, dims=(-1,)))
    umo = torch.where(wet, umo, nan)
    vmo = torch.where(wet, vmo, nan)

    lon_t, lat_t, vlon_t, vlat_t = t(lon2d), t(lat2d), t(vlon), t(vlat)
    gm = geo.GridMetrics(
        area2d=area_d,
        v3d=v3d,
        thkcello=thk,
        lon=lon_t,
        lat=lat_t,
        lon_vertices=vlon_t,
        lat_vertices=vlat_t,
        z3d=z3d,
        zt=t(lev),
        edge_length=geo.edge_lengths(vlon_t, vlat_t),
        distance_to_edge=geo.distances_to_edge(lon_t, lat_t, vlon_t, vlat_t),
        distance_to_neighbour=geo.distances_to_neighbour(lon_t, lat_t, topo),
        topology=topo,
    )
    mlotst = t(np.where(kbot > 0, rng.uniform(15.0, 0.8 * float(lev[-1]), (ny, nx)), np.nan))
    return gm, wet, umo, vmo, mlotst


def synthetic_dataset(
    nx: int = 18,
    ny: int = 14,
    nz: int = 6,
    topology: str = "tripolar",
    land_fraction: float = 0.15,
    seed: int = 0,
    antisymmetric_seam: bool = True,
    lat_south: float = -78.0,
) -> SyntheticDataset:
    """Generate a synthetic dataset.

    For `topology="tripolar"` cell (ny-1, i) shares its north edge with
    cell (ny-1, nx-1-i); with `antisymmetric_seam`, vmo on the top row
    satisfies vmo[i] = -vmo[nx-1-i]. For `topology="bipolar"` the top
    edge lies on lat=90.
    """
    if nx % 2 != 0:
        raise ValueError("nx must be even for the tripolar fold")
    rng = np.random.default_rng(seed)

    lat_north_edge = _north_edge(topology)
    lat_edges = np.linspace(lat_south, lat_north_edge, ny + 1)
    lon_edges = np.linspace(0.0, 360.0, nx + 1)
    vlon, vlat = _vertices(nx, ny, lat_edges, lon_edges)

    if topology == "tripolar":
        # Palindromic vertex longitudes along the seam (p[i] == p[nx - i]).
        p = np.empty(nx + 1)
        half = nx // 2
        p[: half + 1] = 80.0 + (np.arange(half + 1)) * (360.0 / half) / 2.0
        for i in range(half + 1, nx + 1):
            p[i] = p[nx - i]
        vlon[3, ny - 1, :] = p[:-1]  # NW
        vlon[2, ny - 1, :] = p[1:]  # NE
        vlat[3, ny - 1, :] = lat_north_edge
        vlat[2, ny - 1, :] = lat_north_edge

    lon = 0.5 * (lon_edges[:-1] + lon_edges[1:])[None, :].repeat(ny, axis=0)
    lat = 0.5 * (lat_edges[:-1] + lat_edges[1:])[:, None].repeat(nx, axis=1)

    thick = _level_thicknesses(nz)
    lev = np.cumsum(thick) - 0.5 * thick

    area = _cell_areas(lat_edges, nx)
    kbot = _seafloor_levels(nx, ny, nz, rng, land_fraction)
    wet3d = np.arange(nz)[:, None, None] < kbot[None, :, :]

    volcello = np.where(wet3d, area[None] * thick[:, None, None], np.nan)

    # Mass transports: smooth harmonics, NaN junk on land like CMIP output.
    umo = _smooth_field((nz, ny, nx), rng, 1e8)
    vmo = _smooth_field((nz, ny, nx), rng, 1e8)
    if topology == "tripolar" and antisymmetric_seam:
        top = vmo[:, ny - 1, :]
        vmo[:, ny - 1, :] = 0.5 * (top - top[:, ::-1])
    umo[~wet3d] = np.nan
    vmo[~wet3d] = np.nan

    mlotst = rng.uniform(15.0, 0.8 * float(lev[-1]), size=(ny, nx))
    mlotst[kbot == 0] = np.nan

    return SyntheticDataset(
        areacello=np.where(kbot > 0, area, np.nan),
        volcello=volcello,
        lon=lon,
        lat=lat,
        lev=lev,
        lon_vertices=vlon,
        lat_vertices=vlat,
        umo=umo,
        vmo=vmo,
        mlotst=mlotst,
        wet3d=wet3d,
    )
