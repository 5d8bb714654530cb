"""Grid topology: seam detection and tensor-level neighbour semantics.

Counterpart of `otmb_tpu.grid.topology`, on torch tensors:

  * i (longitude) is periodic: `torch.roll`.
  * j (latitude): no connection at j=0; at j=ny-1 either no connection
    (bipolar) or the tripolar fold (i, ny-1) -> (nx-1-i, ny-1)
    (reference gridtopology.jl:94-95).
  * k (depth): no connection at either end.

Layout is [..., k, j, i] == (nz, ny, nx) for 3D fields and (ny, nx) for
2D fields, i innermost.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Literal

import numpy as np
import torch

Direction = Literal["east", "west", "north", "south", "top", "bottom"]

#: The six face/neighbour directions, in the order used for stencil legs.
DIRECTIONS: tuple[Direction, ...] = ("east", "west", "north", "south", "top", "bottom")
HORIZONTAL_DIRECTIONS: tuple[Direction, ...] = ("east", "west", "north", "south")
OPPOSITE = {"east": "west", "west": "east", "north": "south", "south": "north",
            "top": "bottom", "bottom": "top"}
BIPOLAR = "bipolar"
TRIPOLAR = "tripolar"
UNKNOWN = "unknown"


@dataclasses.dataclass(frozen=True)
class GridTopology:
    """Static grid topology descriptor (reference gridtopology.jl:2-16)."""

    kind: str
    nx: int
    ny: int
    nz: int

    @property
    def is_tripolar(self) -> bool:
        return self.kind == TRIPOLAR

    @property
    def shape2d(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def shape3d(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.nx)


def _wrap_lon_delta(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Longitude difference wrapped to (-180, 180]."""
    return np.mod(a - b + 180.0, 360.0) - 180.0


def isapprox_lon(a, b, atol: float | None = None) -> bool:
    """Periodic-aware approximate longitude equality (gridtopology.jl:23-26)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if atol is None:
        atol = np.spacing(180.0)  # eps(180.0), as in the reference
    return bool(np.all(np.abs(_wrap_lon_delta(a, b)) <= atol))


def detect_topology(lon_vertices, lat_vertices, nz: int) -> GridTopology:
    """Classify the grid as bipolar / tripolar / unknown from the top row's
    NE/NW vertices (reference `getgridtopology`, gridtopology.jl:33-53).

    Vertices are (4, ny, nx) in SW, SE, NE, NW order, numpy or tensors.
    """
    lon_vertices = np.asarray(lon_vertices, dtype=np.float64)
    lat_vertices = np.asarray(lat_vertices, dtype=np.float64)
    _, ny, nx = lon_vertices.shape
    np_lon = lon_vertices[2:4, ny - 1, :]
    np_lat = lat_vertices[2:4, ny - 1, :]
    rot = lambda x: x[::-1, ::-1]
    if np.all(np_lat == 90.0):
        kind = BIPOLAR
    elif isapprox_lon(np_lon, rot(np_lon)) and np.allclose(
        np_lat, rot(np_lat), rtol=np.sqrt(np.finfo(np.float64).eps), atol=0.0
    ):
        kind = TRIPOLAR
    else:
        warnings.warn(
            "Unknown grid topology detected. Things might not work as "
            "expected. See `detect_topology` to see what failed the checks.",
            stacklevel=2,
        )
        kind = UNKNOWN
    return GridTopology(kind=kind, nx=nx, ny=ny, nz=nz)


def _require_known(topo: GridTopology) -> None:
    """Neighbour access is undefined on unclassified grids, as in the
    reference (gridtopology.jl:111-116)."""
    if topo.kind == UNKNOWN:
        raise ValueError(
            "Unknown grid type: neighbor access is undefined for grids whose "
            "topology could not be classified (see detect_topology)."
        )


def fold_i(x: torch.Tensor) -> torch.Tensor:
    """Reverse the i axis — the tripolar seam pairing i -> nx-1-i."""
    return torch.flip(x, dims=(-1,))


def neighbor_values(x: torch.Tensor, direction: Direction, topo: GridTopology,
                    fill=float("nan")) -> torch.Tensor:
    """Value of the `direction`-neighbour of every cell, `fill` where none.

    "top" is k-1 (towards the surface), "bottom" k+1.
    """
    _require_known(topo)
    if direction == "east":
        return torch.roll(x, -1, dims=-1)
    if direction == "west":
        return torch.roll(x, 1, dims=-1)
    if direction == "north":
        if topo.is_tripolar:
            last = fold_i(x[..., -1:, :])
        else:
            last = torch.full_like(x[..., -1:, :], fill)
        return torch.cat([x[..., 1:, :], last], dim=-2)
    if direction == "south":
        return torch.cat([torch.full_like(x[..., :1, :], fill), x[..., :-1, :]], dim=-2)
    if direction == "bottom":
        return torch.cat([x[..., 1:, :, :], torch.full_like(x[..., -1:, :, :], fill)], dim=-3)
    if direction == "top":
        return torch.cat([torch.full_like(x[..., :1, :, :], fill), x[..., :-1, :, :]], dim=-3)
    raise ValueError(f"unknown direction {direction!r}")


def neighbor_valid(direction: Direction, topo: GridTopology, ndim: int = 3,
                   device=None) -> torch.Tensor:
    """Boolean connectivity mask: True where a `direction`-neighbour exists
    (gridtopology.jl:57-68,94-95)."""
    _require_known(topo)
    shape = topo.shape3d if ndim == 3 else topo.shape2d
    valid = torch.ones(shape, dtype=torch.bool, device=device)
    if direction in ("east", "west"):
        pass  # periodic
    elif direction == "north":
        if not topo.is_tripolar:
            valid[..., -1, :] = False
    elif direction == "south":
        valid[..., 0, :] = False
    elif direction in ("top", "bottom"):
        if ndim != 3:
            raise ValueError("vertical direction on 2D grid")
        valid[0 if direction == "top" else -1] = False
    else:
        raise ValueError(f"unknown direction {direction!r}")
    return valid


def shift_values(x: torch.Tensor, axis: str, n: int, topo: GridTopology,
                 fill=float("nan")) -> torch.Tensor:
    """Value at the cell `n` steps along `axis` in {"i", "j", "k"}, `fill`
    where that cell does not exist (gridtopology.jl:72-108): periodic in i;
    one step past the tripolar top row lands on the folded top row."""
    _require_known(topo)
    if n == 0:
        return x
    if axis == "i":
        return torch.roll(x, -n, dims=-1)
    if axis not in ("j", "k"):
        raise ValueError(f"axis must be 'i', 'j', or 'k', got {axis!r}")
    ax = -2 if axis == "j" else -3
    size = x.shape[ax]
    if abs(n) >= size:
        return torch.full_like(x, fill)
    if n > 0:
        shifted = x.narrow(ax, n, size - n)
        if axis == "j" and topo.is_tripolar and n == 1:
            tail = fold_i(x[..., -1:, :])
        else:
            tail = torch.full_like(x.narrow(ax, 0, n), fill)
        return torch.cat([shifted, tail], dim=ax)
    head = torch.full_like(x.narrow(ax, 0, -n), fill)
    return torch.cat([head, x.narrow(ax, 0, size + n)], dim=ax)


def scatter_to_neighbor(x: torch.Tensor, direction: Direction,
                        topo: GridTopology) -> torch.Tensor:
    """Adjoint of `neighbor_values` with fill=0: moves each cell's value to
    its `direction`-neighbour (summing where two cells share one target,
    which only the tripolar fold does)."""
    _require_known(topo)
    if direction == "east":
        return torch.roll(x, 1, dims=-1)
    if direction == "west":
        return torch.roll(x, -1, dims=-1)
    if direction == "north":
        zero_row = torch.zeros_like(x[..., :1, :])
        lower = torch.cat([zero_row, x[..., :-1, :]], dim=-2)
        if topo.is_tripolar:
            seam = torch.cat([torch.zeros_like(x[..., :-1, :]),
                              fold_i(x[..., -1:, :])], dim=-2)
            return lower + seam
        return lower
    if direction == "south":
        return torch.cat([x[..., 1:, :], torch.zeros_like(x[..., -1:, :])], dim=-2)
    if direction == "bottom":
        return torch.cat([torch.zeros_like(x[..., :1, :, :]), x[..., :-1, :, :]], dim=-3)
    if direction == "top":
        return torch.cat([x[..., 1:, :, :], torch.zeros_like(x[..., -1:, :, :])], dim=-3)
    raise ValueError(f"unknown direction {direction!r}")
