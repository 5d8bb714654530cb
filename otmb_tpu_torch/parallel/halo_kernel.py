"""K7: the 7-point stencil on one shard of a process grid — apply and
propagation — for one tracer and for a batch.

Replaces `otmb_tpu/parallel/halo_pallas.py` (`apply_stencil_halo_pallas`,
`euler_propagate_halo_pallas` and their `_multi` forms). Each call
exchanges the one-cell halo of its tracer (`parallel/halo.py`), then runs
the shard-local kernel: the kHalo instantiations of K1 and K5 in
`csrc/stencil.cu`, which read the shard's edge neighbours from the halo
lines. Every function here is collective: all ranks of the grid call it
together, each with its own shard.

`overlap=True` takes the halo's latency off the critical path: the
messages are posted, the kernel runs on zero halos, and the edge cells are
patched when the lines land (`_step`, the overlapped variant of the
plain and the kernel path alike); the result differs from
`overlap=False` only at edge cells, by the order of their sums. The
defaults are the JAX package's: off for an apply, on for propagation.

A CUDA tensor always goes to K7, and a failure raises; a CPU tensor takes
the plain version, `parallel.halo._local_stencil`. With overlap off, K7 on
each shard equals K1 (K5 per member) on the whole field bit for bit.
Coefficient and value types are K1's.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..grid.topology import UNKNOWN, GridTopology
from ..ops.coeffs import StencilCoeffs
from ..ops.stencil import _ENTRY as _K1_ENTRY
from .halo import (_boundary_patch, _exchange, _halo_exchange, _halo_lines, _local_stencil,
                   _zero_halos, ready_event)
from .mesh import ProcessGrid

#: Kernel launches made by this module's wrappers: K7 on one tracer, on a batch.
LAUNCHES = 0
MULTI_LAUNCHES = 0

_ENTRY = {key: name.replace("otmb_stencil_", "otmb_stencil_halo_")
          for key, name in _K1_ENTRY.items()}
_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
             + [ctypes.c_double, ctypes.c_void_p])


def _validate(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology,
              grid: ProcessGrid, batched: bool) -> None:
    if topology.kind == UNKNOWN:
        raise ValueError("stencil_apply_halo: unknown grid topology")
    key = (coeffs.diag.dtype, chi.dtype)
    if key not in _ENTRY:
        raise TypeError(f"stencil_apply_halo: no kernel for (coefficients, values) = {key}")
    shape = (topology.nz, *grid.local_shape(topology.ny, topology.nx))
    want = (chi.shape[0], *shape) if batched else shape
    if chi.ndim != (4 if batched else 3) or tuple(chi.shape) != want:
        raise ValueError(f"stencil_apply_halo: chi has shape {tuple(chi.shape)}, expected "
                         f"{'(B, ' if batched else '('}{', '.join(map(str, shape))}) on this shard")
    for name, t in zip(coeffs._fields, coeffs):
        if tuple(t.shape) != shape or t.dtype != coeffs.diag.dtype or t.device != chi.device:
            raise ValueError(f"stencil_apply_halo: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {coeffs.diag.dtype} {shape} on {chi.device}")
        if not t.is_contiguous():
            raise ValueError(f"stencil_apply_halo: {name} is not contiguous")
    if chi.device != grid.device:
        raise ValueError(f"stencil_apply_halo: chi is on {chi.device}, the grid's rank on "
                         f"{grid.device}")


def local_apply(coeffs: StencilCoeffs, chi: torch.Tensor, halos, dt: float | None = None):
    """T chi (or chi - dt T chi) on one shard from its halo lines: one K7
    launch on a CUDA tensor, `_local_stencil` on a CPU one. No messages."""
    global LAUNCHES, MULTI_LAUNCHES
    if not chi.is_cuda:
        y = _local_stencil(coeffs, chi, halos)
        return y if dt is None else chi - dt * y
    chi = chi.contiguous()
    nz, ny, nx = chi.shape[-3:]
    batched = chi.ndim == 4
    for h, line in zip(halos, (ny, ny, nx, nx)):
        if tuple(h.shape) != (*chi.shape[:-2], line) or h.dtype != chi.dtype or not h.is_contiguous():
            raise ValueError(f"K7: halo line {tuple(h.shape)} {h.dtype}, expected "
                             f"{(*chi.shape[:-2], line)} {chi.dtype}, contiguous")
    out = torch.empty_like(chi)
    _build.launch(_ENTRY[(coeffs.diag.dtype, chi.dtype)], _ARGTYPES, chi.device,
                  *(leg.data_ptr() for leg in coeffs), chi.data_ptr(), out.data_ptr(),
                  *(h.data_ptr() for h in halos), chi.shape[0] if batched else 0, nz, ny, nx,
                  int(dt is not None), 0.0 if dt is None else float(dt))
    if batched:
        MULTI_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def _step(coeffs, chi, topology, grid, dt, overlap):
    if not overlap:
        return local_apply(coeffs, chi, _halo_exchange(chi, topology, grid).wait(), dt)
    # The bulk launch goes before the lines are staged, and their staging
    # waits only for the lines (`ready`, after the fold's flip), so the
    # copies and the messages overlap the bulk kernel.
    lines = _halo_lines(chi, topology)
    ready = ready_event(chi)
    bulk = local_apply(coeffs, chi, _zero_halos(chi), dt)
    pending = _exchange(grid, *lines, ready)
    return _boundary_patch(coeffs, bulk, pending.wait(), 1.0 if dt is None else -dt)


def _run(coeffs, chi, topology, grid, dt, nsteps, overlap, batched):
    _validate(coeffs, chi, topology, grid, batched)
    for _ in range(int(nsteps)):
        chi = _step(coeffs, chi, topology, grid, dt, overlap)
    return chi


def stencil_apply_halo(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology,
                       grid: ProcessGrid, overlap: bool = False) -> torch.Tensor:
    """y = T chi on this rank's shard (`apply_stencil_halo_pallas`):
    `coeffs` and `chi` are the rank's shards, `topology` the global one."""
    return _run(coeffs, chi, topology, grid, None, 1, overlap, False)


def euler_propagate_halo(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float, nsteps: int,
                         topology: GridTopology, grid: ProcessGrid,
                         overlap: bool = True) -> torch.Tensor:
    """nsteps of chi - dt T chi on this rank's shard, one exchange and one
    K7 launch per step (`euler_propagate_halo_pallas`)."""
    return _run(coeffs, chi, topology, grid, float(dt), nsteps, overlap, False)


def stencil_apply_halo_multi(coeffs: StencilCoeffs, chis: torch.Tensor,
                             topology: GridTopology, grid: ProcessGrid,
                             overlap: bool = False) -> torch.Tensor:
    """y[b] = T chis[b] for a batch (B, nz, ny_l, nx_l) on this rank's shard:
    one exchange of the batch's lines and one K7 launch that reads the
    coefficients once (`apply_stencil_halo_pallas_multi`)."""
    return _run(coeffs, chis, topology, grid, None, 1, overlap, True)


def euler_propagate_halo_multi(coeffs: StencilCoeffs, chis: torch.Tensor, dt: float,
                               nsteps: int, topology: GridTopology, grid: ProcessGrid,
                               overlap: bool = True) -> torch.Tensor:
    """nsteps of the batched Euler step on this rank's shard
    (`euler_propagate_halo_pallas_multi`)."""
    return _run(coeffs, chis, topology, grid, float(dt), nsteps, overlap, True)
