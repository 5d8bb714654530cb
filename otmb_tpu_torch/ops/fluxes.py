"""Six-face cell mass fluxes from Arakawa C-grid transports
(reference velocities.jl:118-255).

West/south faces are topology-aware shifted copies of east/north, and the
top/bottom closure by mass conservation is a reversed cumulative sum:
    phi_top[k]    = sum_{k' >= k} (W + S - E - N)[k']
    phi_bottom[k] = phi_top[k+1]   (0 at the seafloor).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..grid.geometry import GridMetrics
from ..grid.indices import Indices
from ..grid.topology import GridTopology, neighbor_valid, neighbor_values
from ..utils.tracing import traced


class FaceFluxes(NamedTuple):
    """Mass flux (kg/s) through each face, positive along +i (east), +j
    (north) and upward for top/bottom, as in the reference."""

    east: torch.Tensor
    west: torch.Tensor
    north: torch.Tensor
    south: torch.Tensor
    top: torch.Tensor
    bottom: torch.Tensor


def _sanitize(x: torch.Tensor, fill_value) -> torch.Tensor:
    x = torch.where(torch.isfinite(x), x, 0.0)
    if fill_value is not None:
        x = torch.where(x == fill_value, 0.0, x)
    return x


def facefluxes(umo: torch.Tensor, vmo: torch.Tensor, wet3d: torch.Tensor,
               topology: GridTopology, fill_value: float | None = None) -> FaceFluxes:
    """Six-face fluxes from the east (`umo`) and north (`vmo`) face
    transports (`facefluxes`, velocities.jl:190-255)."""
    wet = wet3d.to(torch.bool)
    phi_east = _sanitize(umo, fill_value)
    phi_north = _sanitize(vmo, fill_value)

    # No-flux boundaries (velocities.jl:154-179): zero the east/north flux
    # of land cells and of faces whose neighbour is land or missing.
    east_nb_wet = neighbor_values(wet, "east", topology, fill=False)
    north_nb_wet = neighbor_values(wet, "north", topology, fill=False) & neighbor_valid(
        "north", topology, device=wet.device
    )
    phi_east = torch.where(wet & east_nb_wet, phi_east, 0.0)
    phi_north = torch.where(wet & north_nb_wet, phi_north, 0.0)

    # West/south faces are the neighbour's east/north face (velocities.jl:206-224).
    phi_west = neighbor_values(phi_east, "west", topology, fill=0.0)
    phi_south = neighbor_values(phi_north, "south", topology, fill=0.0)

    # Vertical closure by mass conservation (velocities.jl:227-243).
    convergence = phi_west + phi_south - phi_east - phi_north
    phi_top = torch.flip(torch.cumsum(torch.flip(convergence, dims=(0,)), dim=0), dims=(0,))
    phi_bottom = torch.cat([phi_top[1:], torch.zeros_like(phi_top[:1])], dim=0)

    return FaceFluxes(east=phi_east, west=phi_west, north=phi_north,
                      south=phi_south, top=phi_top, bottom=phi_bottom)


@traced
def facefluxesfrommasstransport(*, umo, vmo, gridmetrics: GridMetrics,
                                indices: Indices,
                                fill_value: float | None = None) -> FaceFluxes:
    """Front door of the reference `facefluxesfrommasstransport`
    (velocities.jl:118-130): takes numpy or tensors, moves them to the
    grid's dtype and device."""
    v3d = gridmetrics.v3d
    as_grid = lambda x: torch.as_tensor(x, dtype=v3d.dtype, device=v3d.device)
    return facefluxes(as_grid(umo), as_grid(vmo), indices.wet3d,
                      gridmetrics.topology, fill_value=fill_value)
