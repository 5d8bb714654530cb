"""The one-cell halo exchange between shards, and the plain shard-local
stencil that K7 (`parallel/halo_kernel.py`) is held against.

Counterpart of `otmb_tpu.parallel.halo`, with point-to-point messages of
`torch.distributed` in place of `ppermute`:

  * x (longitude) is periodic: the east halo of the last grid column is
    the first column's line; with nx_dev == 1 a shard wraps onto itself
    and sends nothing;
  * y (latitude) is open: past the global south edge, and past a bipolar
    north edge, the halo is zeros;
  * the tripolar seam: the north neighbour of global top-row cell (ny-1, i)
    is (ny-1, nx-1-i), so the top shard row receives the i-reversed top
    row of its mirror shard (y, nx_dev-1-x); with an odd nx_dev the middle
    shard mirrors itself and sends nothing (reference semantics:
    gridtopology.jl:94-95).

A halo is a line without its singleton axis: columns (..., nz, ny_l), rows
(..., nz, nx_l), for any leading axes (a batch of tracers). `_exchange`
moves any lines; the assembly and Redi exchange several fields at once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..grid.topology import GridTopology
from ..ops.coeffs import StencilCoeffs
from .mesh import ProcessGrid

# One tag per direction of travel: gloo matches messages by tag, so two
# lines between the same pair of ranks (nx_dev == 2, or a mirror that is
# also an x neighbour) cannot cross. NCCL matches by issue order, which is
# the same on every rank (sends W, E, S, N, fold; then receives).
_TAG_WEST, _TAG_EAST, _TAG_SOUTH, _TAG_NORTH, _TAG_FOLD = 1, 2, 3, 4, 5


class _Pending:
    """Messages in flight; `wait()` returns the halos (east, west, north,
    south) on the payloads' device (host-staged lines are copied up on the
    current stream without blocking the host)."""

    def __init__(self, works, halos, device):
        self._works, self._halos, self._device = works, halos, device

    def wait(self) -> tuple[torch.Tensor, ...]:
        for w in self._works:
            w.wait()
        return tuple(h.to(self._device, non_blocking=True).contiguous() for h in self._halos)


_SIDE_STREAMS: dict = {}


def ready_event(t: torch.Tensor):
    """An event on the current stream marking that `t` is written, for
    `_exchange(ready=)`: None for a host tensor."""
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _stage_to_host(lines: list[torch.Tensor], ready) -> list[torch.Tensor]:
    """Device-to-host copies of `lines` into pinned buffers, on a side
    stream that waits only on `ready` (when the lines were written), so the
    copies overlap whatever the current stream runs after that; returns
    once the copies have landed."""
    device = lines[0].device
    side = _SIDE_STREAMS.get(device)
    if side is None:
        side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    if ready is None:
        ready = ready_event(lines[0])
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in lines]
    with torch.cuda.stream(side):
        side.wait_event(ready)
        for h, t in zip(hosts, lines):
            h.copy_(t.contiguous(), non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    return hosts


def _exchange(grid: ProcessGrid, send_west: torch.Tensor, send_east: torch.Tensor,
              send_south: torch.Tensor, send_north: torch.Tensor,
              fold: torch.Tensor | None, ready=None) -> _Pending:
    """Start one exchange round. Each rank sends `send_west` to its west
    neighbour, `send_east` east, `send_south` south, `send_north` north and,
    on the top shard row of a tripolar grid, `fold` (shaped as
    `send_south`) to its mirror. The halos, after `wait()`: east = the east
    neighbour's `send_west`, west = the west neighbour's `send_east`, north =
    the north neighbour's `send_south` (the mirror's `fold` on the top row,
    zeros there without one), south = the south neighbour's `send_north`
    (zeros on the bottom row). Under gloo with CUDA tensors the lines are
    staged through pinned host memory (`_stage_to_host`; `ready`, from
    `ready_event`, says when they were written: default, now)."""
    device = send_west.device
    pinned = grid.host_staged
    staged = torch.device("cpu") if pinned else device
    buf = lambda like: torch.empty(like.shape, dtype=like.dtype, device=staged, pin_memory=pinned)
    sends, recvs = [], []
    if grid.nx_dev > 1:
        east, west = buf(send_west), buf(send_east)
        sends += [(send_west, grid.west, _TAG_WEST), (send_east, grid.east, _TAG_EAST)]
        recvs += [(east, grid.east, _TAG_WEST), (west, grid.west, _TAG_EAST)]
    else:  # periodic x on one grid column: the shard is its own neighbour
        east, west = send_west, send_east
    north = south = None
    if grid.south is not None:
        south = buf(send_north)
        sends.append((send_south, grid.south, _TAG_SOUTH))
        recvs.append((south, grid.south, _TAG_NORTH))
    if grid.north is not None:
        north = buf(send_south)
        sends.append((send_north, grid.north, _TAG_NORTH))
        recvs.append((north, grid.north, _TAG_SOUTH))
    if grid.is_top and fold is not None:
        if grid.mirror == grid.rank:
            north = fold
        else:
            north = buf(fold)
            sends.append((fold, grid.mirror, _TAG_FOLD))
            recvs.append((north, grid.mirror, _TAG_FOLD))
    if north is None:
        north = torch.zeros_like(send_south)
    if south is None:
        south = torch.zeros_like(send_north)
    if pinned and sends:  # each line crosses to the host once
        lines = _stage_to_host([t for t, _, _ in sends], ready)
    else:
        lines = [t.contiguous() for t, _, _ in sends]
    ops = ([dist.P2POp(dist.isend, t, peer, tag=tag) for t, (_, peer, tag) in zip(lines, sends)]
           + [dist.P2POp(dist.irecv, t, peer, tag=tag) for t, peer, tag in recvs])
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(works, (east, west, north, south), device)


def _halo_lines(chi: torch.Tensor, topology: GridTopology) -> tuple:
    """What a local field (..., nz, ny_l, nx_l) sends in its halo exchange,
    in `_exchange`'s order: its west and east columns, its south and north
    rows, and (tripolar) its north row i-reversed for the fold."""
    return (chi[..., 0], chi[..., -1], chi[..., 0, :], chi[..., -1, :],
            torch.flip(chi[..., -1, :], dims=(-1,)) if topology.is_tripolar else None)


def _halo_exchange(chi: torch.Tensor, topology: GridTopology, grid: ProcessGrid) -> _Pending:
    """Start the exchange of the one-cell halo of a local field (..., nz,
    ny_l, nx_l); `wait()` gives (east, west, north, south): columns (...,
    nz, ny_l), rows (..., nz, nx_l)."""
    return _exchange(grid, *_halo_lines(chi, topology))


def _local_stencil(coeffs: StencilCoeffs, chi: torch.Tensor, halos) -> torch.Tensor:
    """The plain version of K7: T chi on a shard's open box, the edge
    neighbours from `halos`, accumulated in chi's dtype in the order of
    `ops.apply.apply_stencil` (so on each shard it equals apply_stencil on
    the whole field bit for bit). chi may carry a leading batch axis."""
    east_h, west_h, north_h, south_h = halos
    east = torch.cat([chi[..., 1:], east_h[..., None]], dim=-1)
    west = torch.cat([west_h[..., None], chi[..., :-1]], dim=-1)
    north = torch.cat([chi[..., 1:, :], north_h[..., None, :]], dim=-2)
    south = torch.cat([south_h[..., None, :], chi[..., :-1, :]], dim=-2)
    up = torch.cat([torch.zeros_like(chi[..., :1, :, :]), chi[..., :-1, :, :]], dim=-3)
    down = torch.cat([chi[..., 1:, :, :], torch.zeros_like(chi[..., :1, :, :])], dim=-3)
    c = lambda leg: leg.to(chi.dtype)
    acc = c(coeffs.diag) * chi
    for leg, nb in ((coeffs.east, east), (coeffs.west, west), (coeffs.north, north),
                    (coeffs.south, south), (coeffs.top, up), (coeffs.bottom, down)):
        acc = acc + c(leg) * nb
    return acc


def _zero_halos(chi: torch.Tensor) -> tuple[torch.Tensor, ...]:
    col = torch.zeros_like(chi[..., 0])
    row = torch.zeros_like(chi[..., 0, :])
    return col, col, row, row


def _boundary_patch(coeffs: StencilCoeffs, bulk: torch.Tensor, halos, scale: float):
    """Add the halo terms to a result computed on zero halos, in place:
    scale * coefficient * halo on the shard's edge columns and rows (scale
    = 1 for an apply, -dt for an Euler step). The zero halos contributed
    exactly 0 there, so this gives the result on the true halos up to the
    order of the sum at the edge cells. Works on a batch (the coefficients
    broadcast over its leading axis); returns `bulk`."""
    east_h, west_h, north_h, south_h = halos
    c = lambda leg: leg.to(bulk.dtype)
    bulk[..., -1] += scale * c(coeffs.east[..., -1]) * east_h
    bulk[..., 0] += scale * c(coeffs.west[..., 0]) * west_h
    bulk[..., -1, :] += scale * c(coeffs.north[..., -1, :]) * north_h
    bulk[..., 0, :] += scale * c(coeffs.south[..., 0, :]) * south_h
    return bulk
