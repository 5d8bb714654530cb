"""K7: the 7-point stencil on one shard of a process grid — apply and
propagation — for one tracer and for a batch.

Replaces `otmb_tpu/parallel/halo_pallas.py` (`apply_stencil_halo_pallas`,
`euler_propagate_halo_pallas` and their `_multi` forms). Each step
exchanges the one-cell halo of its tracer through a `HaloExchange`
(`parallel/halo.py`), made once per call and reused by every step, and
runs the shard-local kernel: the kHalo instantiations of K1 and K5 in
`csrc/stencil.cu`, which read the shard's edge neighbours from the halo
lines. Every function here is collective: all ranks of the grid call it
together, each with its own shard.

One step is three launches on the card: the pack (every line the shard
sends, into one send buffer), the bulk K7 and, with overlap, the edge
entry; under gloo the lines cross to the host and back in one copy each
way. `overlap=True` takes the halo's latency off the critical path: the
bulk runs on null halos while the lines are staged and exchanged, and the
edge entry adds the halo terms at the edge cells when they land (`_step`);
the result differs from `overlap=False` only at edge cells, by the order
of their sums. Without overlap the bulk reads its halos from the receive
buffer. The defaults are the JAX package's: off for an apply, on for
propagation.

A CUDA tensor always goes to the kernels, and a failure raises; a CPU
tensor takes their plain versions (`halo._pack_plain`,
`halo._local_stencil`, `halo._boundary_patch`). With overlap off, K7 on
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
from .halo import HaloExchange, _boundary_patch, _local_stencil, _pack_plain, ready_event
from .mesh import ProcessGrid

_ENTRY = {key: name.replace("otmb_stencil_", "otmb_stencil_halo_")
          for key, name in _K1_ENTRY.items()}
_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
             + [ctypes.c_double, ctypes.c_void_p])
_PACK_ENTRY = {torch.float32: "otmb_halo_pack_f32", torch.float64: "otmb_halo_pack_f64"}
_PACK_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_EDGE_ENTRY = {key: name.replace("otmb_stencil_", "otmb_halo_edge_")
               for key, name in _K1_ENTRY.items()}
_EDGE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_void_p]
_NO_HALOS = (None, None, None, None)


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


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _bulk(coeffs: StencilCoeffs, chi: torch.Tensor, halos, dt: float | None) -> torch.Tensor:
    """T chi (or chi - dt T chi) on one shard from its halo lines (None:
    zeros), unchecked: one K7 launch on a CUDA tensor, `_local_stencil` on
    a CPU one."""
    if not chi.is_cuda:
        y = _local_stencil(coeffs, chi, halos)
        return y if dt is None else chi - dt * y
    nz, ny, nx = chi.shape[-3:]
    batched = chi.ndim == 4
    out = torch.empty_like(chi)
    _build.launch(_ENTRY[(coeffs.diag.dtype, chi.dtype)], _ARGTYPES, chi.device,
                  *(leg.data_ptr() for leg in coeffs), chi.data_ptr(), out.data_ptr(),
                  *map(_ptr, halos), chi.shape[0] if batched else 0, nz, ny, nx,
                  int(dt is not None), 0.0 if dt is None else float(dt), batch=batched)
    return out


def _pack(plan: HaloExchange, chi: torch.Tensor, topology: GridTopology) -> None:
    """Write what the shard sends into `plan.send`: one launch on a CUDA
    tensor, `_pack_plain` on a CPU one."""
    if not chi.is_cuda:
        _pack_plain(chi, topology, plan.lines)
        return
    nz, ny, nx = plan.shape
    _build.launch(_PACK_ENTRY[chi.dtype], _PACK_ARGTYPES, chi.device, chi.data_ptr(),
                  plan.send.data_ptr(), plan.members, nz, ny, nx, int(plan.fold))


def _edge(coeffs: StencilCoeffs, bulk: torch.Tensor, halos, scale: float) -> torch.Tensor:
    """Add the halo terms at the shard's edge cells to `bulk`, in place:
    one launch on a CUDA tensor, `_boundary_patch` on a CPU one."""
    if not bulk.is_cuda:
        return _boundary_patch(coeffs, bulk, halos, scale)
    nz, ny, nx = bulk.shape[-3:]
    members = bulk.shape[0] if bulk.ndim == 4 else 1
    _build.launch(_EDGE_ENTRY[(coeffs.diag.dtype, bulk.dtype)], _EDGE_ARGTYPES, bulk.device,
                  coeffs.east.data_ptr(), coeffs.west.data_ptr(), coeffs.north.data_ptr(),
                  coeffs.south.data_ptr(), bulk.data_ptr(), *map(_ptr, halos), members, nz,
                  ny, nx, float(scale))
    return bulk


def local_apply(coeffs: StencilCoeffs, chi: torch.Tensor, halos, dt: float | None = None):
    """T chi (or chi - dt T chi) on one shard from its halo lines (east,
    west, north, south; None reads as zeros): one K7 launch on a CUDA
    tensor, `_local_stencil` on a CPU one. No messages."""
    if chi.is_cuda:
        chi = chi.contiguous()
        ny, nx = chi.shape[-2:]
        for h, line in zip(halos, (ny, ny, nx, nx)):
            if h is None:
                continue
            if (tuple(h.shape) != (*chi.shape[:-2], line) or h.dtype != chi.dtype
                    or not h.is_contiguous()):
                raise ValueError(f"K7: halo line {tuple(h.shape)} {h.dtype}, expected "
                                 f"{(*chi.shape[:-2], line)} {chi.dtype}, contiguous")
    return _bulk(coeffs, chi, halos, dt)


def _step(coeffs, chi, topology, plan: HaloExchange, dt, overlap):
    _pack(plan, chi, topology)
    ready = ready_event(chi)
    if not overlap:
        plan.exchange(ready)
        return _bulk(coeffs, chi, plan.halos, dt)
    # The bulk launch goes before the lines are staged, and their staging
    # waits only for the pack (`ready`), so the copies and the messages
    # overlap the bulk kernel.
    bulk = _bulk(coeffs, chi, _NO_HALOS, dt)
    plan.exchange(ready)
    return _edge(coeffs, bulk, plan.halos, 1.0 if dt is None else -dt)


def _run(coeffs, chi, topology, grid, dt, nsteps, overlap, batched,
         plan: HaloExchange | None = None):
    """`nsteps` steps on this rank's shard, checked once, through `plan`
    (made here when None; `halo_field` passes its own)."""
    _validate(coeffs, chi, topology, grid, batched)
    if plan is None:
        plan = HaloExchange(chi, topology, grid)
    chi = chi.contiguous()
    for _ in range(int(nsteps)):
        chi = _step(coeffs, chi, topology, plan, dt, overlap)
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
