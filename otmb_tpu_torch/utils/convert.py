"""State carried over from the JAX package, handed over as numpy arrays.

`coeffs_from_numpy`, `gridmetrics_from_numpy` and `redi_operator_from_numpy`
build the port's StencilCoeffs, GridMetrics and RediOperator from the
fields of `otmb_tpu`'s (after `np.asarray` on each), on a given device and
dtype, so both packages can compute on identical operators and grids.
`device=None` is the current CUDA device, and raises without one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid.geometry import GridMetrics, PerDirection
from ..grid.topology import GridTopology
from ..models.redi import _COEF_FIELDS, RediOperator
from ..ops.coeffs import StencilCoeffs
from .device import default_device


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def coeffs_from_numpy(legs: dict, device=None, dtype: torch.dtype = torch.float64) -> StencilCoeffs:
    """StencilCoeffs from {leg name: (nz, ny, nx) array}."""
    device = default_device(device)
    return StencilCoeffs(**{name: _tensor(legs[name], device, dtype)
                            for name in StencilCoeffs._fields})


def gridmetrics_from_numpy(*, area2d, v3d, thkcello, lon, lat, lon_vertices, lat_vertices,
                           z3d, zt, edge_length: dict, distance_to_edge: dict,
                           distance_to_neighbour: dict, topology: str, device=None,
                           dtype: torch.dtype = torch.float64) -> GridMetrics:
    """GridMetrics from the JAX GridMetrics fields: the per-direction fields
    as {direction: array} dicts and the topology as its kind; the shape
    comes from v3d."""
    device = default_device(device)
    t = lambda x: _tensor(x, device, dtype)
    per_dir = lambda d: PerDirection(**{k: t(d[k]) for k in ("east", "west", "north", "south")})
    nz, ny, nx = np.shape(v3d)
    return GridMetrics(
        area2d=t(area2d), v3d=t(v3d), thkcello=t(thkcello), lon=t(lon), lat=t(lat),
        lon_vertices=t(lon_vertices), lat_vertices=t(lat_vertices), z3d=t(z3d), zt=t(zt),
        edge_length=per_dir(edge_length),
        distance_to_edge=per_dir(distance_to_edge),
        distance_to_neighbour=per_dir(distance_to_neighbour),
        topology=GridTopology(kind=topology, nx=nx, ny=ny, nz=nz),
    )


def redi_operator_from_numpy(fields: dict, wet, topology_kind: str, device=None,
                             dtype: torch.dtype = torch.float64) -> RediOperator:
    """RediOperator from {field name: array} for the 17 coefficient fields
    of `_COEF_FIELDS` (15 of shape (nz, ny, nx), `inv_de` and `inv_dn` of
    (ny, nx)), the (nz, ny, nx) wet mask and the topology's kind."""
    device = default_device(device)
    wet = torch.tensor(np.asarray(wet, bool), device=device)
    nz, ny, nx = wet.shape
    return RediOperator(
        **{name: _tensor(fields[name], device, dtype) for name in _COEF_FIELDS},
        wet=wet, topology=GridTopology(kind=topology_kind, nx=nx, ny=ny, nz=nz),
    )
