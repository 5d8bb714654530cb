"""Checkpoint / resume: save and load operators and tracer state.

Counterpart of `otmb_tpu.utils.checkpoint`, with its npz keys
(`coef_<leg>`, `topology_kind`, `topology_dims` = (nx, ny, nz),
`extra_<name>`), so a file written by either package loads in the other,
bit for bit: arrays keep their dtype on the way through.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid.indices import _host
from ..grid.topology import GridTopology
from ..ops.coeffs import StencilCoeffs
from .device import default_device

_COEF_FIELDS = StencilCoeffs._fields


def save_operator(path, coeffs: StencilCoeffs, topology: GridTopology, **extra_arrays) -> None:
    """Save a stencil operator (and optional named arrays, e.g. a tracer
    state) to `path` (.npz), from any device."""
    payload = {f"coef_{name}": _host(getattr(coeffs, name)) for name in _COEF_FIELDS}
    payload["topology_kind"] = np.asarray(topology.kind)
    payload["topology_dims"] = np.asarray([topology.nx, topology.ny, topology.nz])
    for key, arr in extra_arrays.items():
        payload[f"extra_{key}"] = _host(arr)
    np.savez_compressed(path, **payload)


def load_operator(path, device=None):
    """Load (coeffs, topology, extras) saved by `save_operator` of either
    package: the legs as tensors on `device` (None: the current CUDA
    device, raising without one), the extras as numpy arrays."""
    device = default_device(device)
    with np.load(path, allow_pickle=False) as data:
        coeffs = StencilCoeffs(**{name: torch.as_tensor(data[f"coef_{name}"], device=device)
                                  for name in _COEF_FIELDS})
        nx, ny, nz = (int(v) for v in data["topology_dims"])
        topology = GridTopology(kind=str(data["topology_kind"]), nx=nx, ny=ny, nz=nz)
        extras = {key[len("extra_"):]: data[key] for key in data.files
                  if key.startswith("extra_")}
    return coeffs, topology, extras


def save_state(path, **arrays) -> None:
    """Save named arrays (tracer fields, step counters as 0-d arrays)."""
    np.savez_compressed(path, **{k: _host(v) for k, v in arrays.items()})


def load_state(path) -> dict:
    """The arrays saved by `save_state`, as numpy arrays."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
