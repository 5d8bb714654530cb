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

import numpy as np

from ..config import EARTH_RADIUS


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

    if topology == "bipolar":
        lat_north_edge = 90.0
    elif topology == "tripolar":
        lat_north_edge = 66.0
    else:
        raise ValueError(f"unknown topology {topology!r}")

    lat_edges = np.linspace(lat_south, lat_north_edge, ny + 1)
    lon_edges = np.linspace(0.0, 360.0, nx + 1)

    # Vertex arrays (4, ny, nx): SW, SE, NE, NW.
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
