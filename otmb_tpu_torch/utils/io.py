"""Data ingestion: CMIP conventions and reference-order conversion.

Counterpart of `otmb_tpu.utils.io`:

  * `from_reference_order` / `to_reference_order`: the reference (Julia,
    column-major) uses (nx, ny, nz) arrays; the canonical layout here is
    (nz, ny, nx), the same memory order with the indices transposed;
  * `gridmetrics_from_xarray` / `transports_from_xarray`: the standard CMIP
    variable names out of xarray datasets. Both are duck-typed: any object
    with the xarray Dataset interface (`ds[name]`, `ds.variables`, per
    variable `.attrs`/`.encoding`/`.squeeze()`/`.dims`/`.isel`) works, so
    they need no xarray; only `open_dataset` does.

The tensors are made on `device=`: None is the current CUDA device, and
raises without one (`utils/device.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid.geometry import GridMetrics, makegridmetrics
from ..grid.indices import _host
from .device import default_device


def from_reference_order(arr) -> np.ndarray:
    """(nx, ny, nz) / (nx, ny) / (4, nx, ny) reference-order array ->
    canonical (nz, ny, nx) / (ny, nx) / (4, ny, nx)."""
    arr = _host(arr)
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3 and arr.shape[0] == 4:
        return arr.transpose(0, 2, 1)
    if arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    raise ValueError(f"unsupported rank {arr.ndim}")


def to_reference_order(arr) -> np.ndarray:
    """Inverse of `from_reference_order` (the transposes are involutions)."""
    return from_reference_order(arr)


def _require_xarray():
    try:
        import xarray

        return xarray
    except ImportError as e:
        raise ImportError(
            "xarray is required for dataset ingestion; install xarray plus "
            "netCDF4 (for NetCDF) or zarr (for Zarr stores), or pass plain "
            "numpy arrays to makegridmetrics/facefluxesfrommasstransport "
            "directly."
        ) from e


def open_dataset(path_or_store, **kwargs):
    """Open a NetCDF/Zarr dataset via xarray: the only entry point here that
    needs xarray (the reference's `open_dataset` usage,
    test/online.jl:36-47)."""
    xr = _require_xarray()
    return xr.open_dataset(path_or_store, **kwargs)


# CMIP-standard variable/coordinate names with common fallbacks: the raw
# CMIP `vertices_longitude`/`vertices_latitude` (reference
# test/online.jl:64-65) and the xmip-renamed `lon_verticies`/
# `lat_verticies` of the reference's local tests
# (test/LocalBuiltMatrix.jl:48-49).
_NAME_CANDIDATES = {
    "lon": ("longitude", "lon", "nav_lon"),
    "lat": ("latitude", "lat", "nav_lat"),
    "lev": ("lev", "olevel", "depth", "deptht"),
    "lon_vertices": ("vertices_longitude", "lon_verticies", "lon_bnds_2d", "bounds_lon"),
    "lat_vertices": ("vertices_latitude", "lat_verticies", "lat_bnds_2d", "bounds_lat"),
}


def _find(ds, key: str):
    for name in _NAME_CANDIDATES[key]:
        if name in ds.variables:
            return ds[name]
    raise KeyError(
        f"none of {_NAME_CANDIDATES[key]} found in dataset (variables: "
        f"{list(ds.variables)[:20]}...)"
    )


def _vertices_canonical(v) -> np.ndarray:
    """Vertex arrays come as (ny, nx, 4) or (4, ny, nx); canonicalise to
    (4, ny, nx)."""
    v = np.asarray(v, dtype=np.float64)
    if v.ndim != 3:
        raise ValueError(f"vertex array must be rank 3, got {v.shape}")
    if v.shape[-1] == 4 and v.shape[0] != 4:
        return np.moveaxis(v, -1, 0)
    if v.shape[0] == 4:
        return v
    raise ValueError(f"cannot locate the vertex axis in shape {v.shape}")


def gridmetrics_from_xarray(volcello_ds, areacello_ds=None, dtype: torch.dtype = torch.float64,
                            device=None) -> GridMetrics:
    """GridMetrics from CMIP xarray dataset(s), as the reference's online
    test reads them (test/online.jl:49-74), on `device` in `dtype`.
    `volcello_ds` carries volcello, lon/lat/lev and the vertex coordinates;
    `areacello_ds` defaults to the same dataset."""
    device = default_device(device)
    area_ds = volcello_ds if areacello_ds is None else areacello_ds
    volcello = volcello_ds["volcello"]
    areacello = area_ds["areacello"]
    fill = volcello.encoding.get("_FillValue", volcello.attrs.get("_FillValue"))
    vol = np.asarray(volcello.squeeze())  # (nz, ny, nx) CMIP order
    if vol.ndim != 3:
        raise ValueError(f"volcello must be 3D after squeeze, got {vol.shape}")
    return makegridmetrics(
        areacello=np.asarray(areacello.squeeze()),
        volcello=vol,
        lon=np.asarray(_find(volcello_ds, "lon")),
        lat=np.asarray(_find(volcello_ds, "lat")),
        lev=np.asarray(_find(volcello_ds, "lev")),
        lon_vertices=_vertices_canonical(_find(volcello_ds, "lon_vertices")),
        lat_vertices=_vertices_canonical(_find(volcello_ds, "lat_vertices")),
        fill_value=fill,
        dtype=dtype,
        device=device,
    )


def transports_from_xarray(umo_ds, vmo_ds, time_index: int = 0, device=None):
    """(umo, vmo, fill_value) from CMIP xarray datasets at one time step
    (the reference takes the first, test/online.jl:43-47): umo and vmo as
    f64 tensors on `device`, fill values kept as they are (pass
    `fill_value` on to `facefluxesfrommasstransport`). Duck-typed like
    `gridmetrics_from_xarray`."""
    device = default_device(device)
    umo = umo_ds["umo"]
    vmo = vmo_ds["vmo"]
    fill = umo.encoding.get("_FillValue", umo.attrs.get("_FillValue"))
    if "time" in umo.dims:
        umo = umo.isel(time=time_index)
    if "time" in vmo.dims:
        vmo = vmo.isel(time=time_index)
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float64, device=device)
    return t(umo), t(vmo), fill
