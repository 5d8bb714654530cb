"""Wet-cell index machinery (reference `makeindices`,
matrixbuilding.jl:10-24).

The compute path keeps dense (nz, ny, nx) fields with a boolean wet mask
on the device; the linear wet maps are host numpy arrays, used only for
sparse export and validation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.tracing import traced


@dataclasses.dataclass(frozen=True)
class Indices:
    """Wet-cell mask and counts. `wet3d` lives on the device of the volume
    field it was built from; `lwet`/`lwet3d` are C-order host maps over
    (nz, ny, nx)."""

    wet3d: torch.Tensor  # (nz, ny, nx) bool
    nwet: int
    lwet: np.ndarray
    lwet3d: np.ndarray

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.wet3d.shape)


@traced
def makeindices(v3d: torch.Tensor) -> Indices:
    """Wet cells are those with finite volume."""
    wet3d = torch.isfinite(v3d)
    wet_np = wet3d.cpu().numpy()
    flat = wet_np.reshape(-1)
    lwet = np.flatnonzero(flat)
    lwet3d = np.full(flat.shape, -1, dtype=np.int64)
    lwet3d[lwet] = np.arange(lwet.size)
    return Indices(wet3d=wet3d, nwet=int(lwet.size), lwet=lwet,
                   lwet3d=lwet3d.reshape(wet_np.shape))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def wet_vector(field3d, indices: Indices) -> np.ndarray:
    """Gather a 3D field to the length-N wet vector (host-side)."""
    return _host(field3d).reshape(-1)[indices.lwet]


def as3d(x, wet3d) -> np.ndarray:
    """Scatter a wet vector back to a NaN-filled 3D field (extratools.jl:127-135)."""
    wet3d = _host(wet3d)
    x = _host(x)
    if x.size != int(wet3d.sum()):
        raise ValueError(f"wet vector length {x.size} != {int(wet3d.sum())} wet cells")
    out = np.full(wet3d.shape, np.nan, dtype=np.result_type(x.dtype, np.float32))
    out[wet3d] = x
    return out


def as2d(x, wet3d) -> np.ndarray:
    """Scatter a surface wet vector to a NaN-filled 2D field
    (extratools.jl:115-124); the surface layer is k = 0."""
    surf = _host(wet3d)[0]
    x = _host(x)
    if x.size != int(surf.sum()):
        raise ValueError(f"vector length {x.size} != {int(surf.sum())} surface wet cells")
    out = np.full(surf.shape, np.nan, dtype=np.result_type(x.dtype, np.float32))
    out[surf] = x
    return out
