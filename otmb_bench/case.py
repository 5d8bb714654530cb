"""The benchmark's inputs: raw CMIP-style ocean fields made from a seed.

A frozen copy of the draws of `otmb_tpu_torch.synthetic_device_case`: the
same numpy draws in the same order (the seafloor with its islands, then
mlotst), the same vertices (the tripolar pole row included) and the same
flow harmonics with the tripolar vmo fold row, NaN on land. It returns the
raw fields a modeller reads from CMIP output (cell vertices, `lev`, cell
areas and volumes, umo, vmo, mlotst), not grid metrics: the program under
test derives those itself, and the plain reference derives them again.

Coordinates and areas are float64 host arrays (O(ny * nx)); the 3D fields
are made by torch operations on the device in float64 and stored as
float32, as CMIP stores them.

`seasons` perturbs the flow and the mixed layer as the months of one model
year do: amplitudes and phases drawn from the same generator, a factor
that depends on latitude only (so the tripolar fold row stays
antisymmetric), opposite in the two hemispheres.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

EARTH_RADIUS = 6_371_000.0
LAT_SOUTH = -78.0
LAND_FRACTION = 0.15


@dataclasses.dataclass
class RawCase:
    """Raw fields in (nz, ny, nx) / (ny, nx) / (4, ny, nx) layout, NaN on land."""

    topology: str
    lon: np.ndarray  # (ny, nx) cell-centre longitude, deg
    lat: np.ndarray  # (ny, nx)
    lon_vertices: np.ndarray  # (4, ny, nx) SW, SE, NE, NW
    lat_vertices: np.ndarray
    lev: np.ndarray  # (nz,) nominal level depth, m
    areacello: np.ndarray  # (ny, nx), NaN on land columns
    volcello: torch.Tensor  # (nz, ny, nx) float32 on the device
    umo: torch.Tensor  # (nz, ny, nx) float32, kg/s
    vmo: torch.Tensor
    mlotst: torch.Tensor  # (ny, nx) float32, m
    wet: torch.Tensor  # (nz, ny, nx) bool, ground truth
    rng: np.random.Generator  # the generator after the case's draws

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.volcello.shape)


def _seafloor_levels(nx: int, ny: int, nz: int, rng: np.random.Generator) -> np.ndarray:
    """Wet levels per column (0: land), with a continent and random islands."""
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    depth = (
        0.55
        + 0.35 * np.sin(2 * np.pi * ii / nx + 1.0) * np.cos(np.pi * jj / ny)
        + 0.25 * np.cos(4 * np.pi * ii / nx) * np.sin(2 * np.pi * jj / ny + 0.5)
    )
    kbot = np.clip(np.round(depth * nz), 1, nz).astype(int)
    i0, i1 = int(0.15 * nx), int(0.15 * nx + max(1, LAND_FRACTION * nx))
    j0, j1 = int(0.3 * ny), int(0.75 * ny)
    kbot[j0:j1, i0:i1] = 0
    n_islands = max(1, (nx * ny) // 50)
    isl_i = rng.integers(0, nx, n_islands)
    isl_j = rng.integers(0, ny, n_islands)
    kbot[isl_j, isl_i] = 0
    return kbot


def _vertices(nx: int, ny: int, lat_edges: np.ndarray, lon_edges: np.ndarray,
              tripolar: bool):
    vlon = np.zeros((4, ny, nx))
    vlat = np.zeros((4, ny, nx))
    vlon[0] = vlon[3] = lon_edges[None, :-1]
    vlon[1] = vlon[2] = lon_edges[None, 1:]
    vlat[0] = vlat[1] = lat_edges[:-1, None]
    vlat[2] = vlat[3] = lat_edges[1:, None]
    if tripolar:
        # palindromic longitudes along the seam: the north edge maps onto
        # itself under the fold i -> nx - 1 - i
        p = np.empty(nx + 1)
        half = nx // 2
        p[: half + 1] = 80.0 + np.arange(half + 1) * (180.0 / half)
        for i in range(half + 1, nx + 1):
            p[i] = p[nx - i]
        vlon[3, ny - 1, :] = p[:-1]
        vlon[2, ny - 1, :] = p[1:]
        vlat[2:, ny - 1, :] = lat_edges[-1]
    return vlon, vlat


def raw_case(nx: int, ny: int, nz: int, topology: str, seed: int, device) -> RawCase:
    """The case of `seed` on `device` (see the module docstring)."""
    if topology not in ("tripolar", "bipolar"):
        raise ValueError(f"unknown topology {topology!r}")
    if nx % 2:
        raise ValueError("nx must be even for the tripolar fold")
    tripolar = topology == "tripolar"
    rng = np.random.default_rng(seed)
    lat_edges = np.linspace(LAT_SOUTH, 66.0 if tripolar else 90.0, ny + 1)
    lon_edges = np.linspace(0.0, 360.0, nx + 1)
    vlon, vlat = _vertices(nx, ny, lat_edges, lon_edges, tripolar)
    lon = 0.5 * (lon_edges[:-1] + lon_edges[1:])[None, :].repeat(ny, axis=0)
    lat = 0.5 * (lat_edges[:-1] + lat_edges[1:])[:, None].repeat(nx, axis=1)
    thick = 10.0 * (1.0 + 0.35 * np.arange(nz))
    lev = np.cumsum(thick) - 0.5 * thick
    band = EARTH_RADIUS ** 2 * (2 * np.pi / nx) * np.diff(np.sin(np.deg2rad(lat_edges)))
    area = np.repeat(band[:, None], nx, axis=1)
    kbot = _seafloor_levels(nx, ny, nz, rng)
    areacello = np.where(kbot > 0, area, np.nan)

    f64 = dict(dtype=torch.float64, device=device)
    wet = torch.arange(nz, device=device).reshape(nz, 1, 1) < torch.as_tensor(
        kbot, device=device)[None]
    volcello = torch.where(wet, torch.as_tensor(area, **f64)[None]
                           * torch.as_tensor(thick, **f64).reshape(nz, 1, 1), math.nan)
    k = torch.arange(nz, **f64).reshape(nz, 1, 1)
    j = torch.arange(ny, **f64).reshape(1, ny, 1)
    i = torch.arange(nx, **f64).reshape(1, 1, nx)
    pi = math.pi
    umo = 1e8 * (torch.cos(2 * pi * 2 * i / nx + 0.3) * torch.cos(pi * 1 * j / ny + 1.1)
                 * torch.cos(pi * 2 * k / nz + 0.7)
                 + 0.5 * torch.cos(2 * pi * 3 * i / nx + 2.0) * torch.cos(pi * 2 * j / ny))
    vmo = 1e8 * (torch.cos(2 * pi * 1 * i / nx + 1.7) * torch.cos(pi * 2 * j / ny + 0.2)
                 * torch.cos(pi * 1 * k / nz + 1.9))
    if tripolar:
        top = vmo[:, ny - 1, :]
        vmo[:, ny - 1, :] = 0.5 * (top - torch.flip(top, dims=(-1,)))
    umo = torch.where(wet, umo, math.nan)
    vmo = torch.where(wet, vmo, math.nan)
    mlotst = np.where(kbot > 0, rng.uniform(15.0, 0.8 * float(lev[-1]), (ny, nx)), np.nan)
    f32 = lambda x: torch.as_tensor(x, device=device).to(torch.float32)
    return RawCase(topology, lon, lat, vlon, vlat, lev, areacello, f32(volcello), f32(umo),
                   f32(vmo), f32(mlotst), wet, rng)


def seasons(case: RawCase, n: int) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """`n` snapshots (umo, vmo, mlotst) of one model year, float32 on the
    case's device; n = 1 is the case's own fields. The draws follow the
    case's, so a seed gives the same year."""
    amp_u, amp_v = case.rng.uniform(0.1, 0.3, 2)
    amp_ml = case.rng.uniform(0.3, 0.6)
    phases = case.rng.uniform(0.0, 2 * np.pi, 3)
    if n == 1:
        return [(case.umo, case.vmo, case.mlotst)]
    dev = case.umo.device
    hemi = torch.as_tensor(np.sin(np.deg2rad(case.lat[:, 0])), dtype=torch.float64, device=dev)
    lo, hi = 15.0, 0.8 * float(case.lev[-1])
    out = []
    for m in range(n):
        c = 2 * np.pi * m / n
        fu = (1 + amp_u * math.cos(c + phases[0]) * hemi).reshape(1, -1, 1)
        fv = (1 + amp_v * math.cos(c + phases[1]) * hemi).reshape(1, -1, 1)
        fml = (1 + amp_ml * math.cos(c + phases[2]) * hemi).reshape(-1, 1)
        out.append(((case.umo.double() * fu).float(), (case.vmo.double() * fv).float(),
                    torch.clamp(case.mlotst.double() * fml, lo, hi).float()))
    return out


def latitude_bands(ny: int, nx: int, nbands: int) -> np.ndarray:
    """(nbands, ny, nx) masks of equal bands of rows, south to north: the
    surface regions of the water-mass fractions."""
    masks = np.zeros((nbands, ny, nx), bool)
    for r in range(nbands):
        masks[r, r * ny // nbands:(r + 1) * ny // nbands] = True
    return masks


def ensemble(case: RawCase, members: int, seed: int) -> torch.Tensor:
    """(members, nz, ny, nx) float32 tracers 1 + 0.1 N(0, 1) on wet cells,
    0 on land, drawn in one call by a generator on the case's device."""
    dev = case.wet.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2 ** 63)
    noise = torch.randn((members,) + case.shape, generator=gen, device=dev)
    return torch.where(case.wet[None], 1.0 + 0.1 * noise, 0.0)
