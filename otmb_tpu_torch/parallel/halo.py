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
The sharded stencil (K7, `parallel/halo_kernel.py`) exchanges through a
`HaloExchange` instead: one flat send buffer that one launch packs, one
flat receive buffer, and under gloo one copy each way between them and
pinned host memory.
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


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that stages a device's halo lines to the host."""
    side = _SIDE_STREAMS.get(device)
    if side is None:
        side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return side


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
    side = _side_stream(lines[0].device)
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


class HaloExchange:
    """The buffers and messages of the sharded stencil's halo exchange for
    fields shaped as `chi` (one tracer (nz, ny_l, nx_l) or a batch (B, nz,
    ny_l, nx_l)), made once per run and reused by its steps.

    `send` is one flat buffer holding what the shard sends, in
    `_halo_lines`' order: its west and east columns, its south and north
    rows and, on the top shard row of a tripolar grid, its north row
    i-reversed for the fold (`lines` views them). `recv` is one flat buffer
    of the east, west, north and south halos. `halos` are the lines K7
    reads beyond the shard's edges, in that order: views of `recv`, views
    of `send` where the shard is its own neighbour (nx_dev == 1, a middle
    mirror shard), None where no neighbour exists (the south edge, a
    bipolar north edge). Under gloo with CUDA tensors, `exchange` stages
    `send` to pinned host memory in one device-to-host copy and lands the
    messages in one host-to-device copy of `recv`; under NCCL, and on the
    CPU, the messages use the buffers themselves."""

    def __init__(self, chi: torch.Tensor, topology: GridTopology, grid: ProcessGrid):
        lead, (nz, ny, nx) = tuple(chi.shape[:-3]), tuple(chi.shape[-3:])
        members = chi.numel() // (nz * ny * nx)
        dtype, device = chi.dtype, chi.device
        self.device = device
        self.members, self.shape = members, (nz, ny, nx)
        self.fold = topology.is_tripolar and grid.is_top
        col, row = members * nz * ny, members * nz * nx
        sizes = [col, col, row, row] + [row] * self.fold
        starts = [sum(sizes[:n]) for n in range(len(sizes) + 1)]
        self.send = torch.empty(starts[-1], dtype=dtype, device=device)
        self.recv = torch.empty(2 * col + 2 * row, dtype=dtype, device=device)
        self.staged = grid.host_staged
        if self.staged:
            self.send_host = torch.empty(self.send.shape, dtype=dtype, pin_memory=True)
            self.recv_host = torch.empty(self.recv.shape, dtype=dtype, pin_memory=True)
        col_shape, row_shape = lead + (nz, ny), lead + (nz, nx)
        shapes = [col_shape, col_shape, row_shape, row_shape, row_shape]
        send_seg = lambda buf, n: buf[starts[n]:starts[n + 1]]
        recv_starts = (0, col, 2 * col, 2 * col + row, 2 * col + 2 * row)
        recv_seg = lambda buf, n: buf[recv_starts[n]:recv_starts[n + 1]]
        #: the send buffer's lines: west, east, south, north (, fold)
        self.lines = tuple(send_seg(self.send, n).view(shapes[n]) for n in range(len(sizes)))
        east_r, west_r, north_r, south_r = (recv_seg(self.recv, n).view(shape) for n, shape
                                            in enumerate(shapes[:4]))
        wire_send = self.send_host if self.staged else self.send
        wire_recv = self.recv_host if self.staged else self.recv
        sends, recvs = [], []  # (wire buffer slice, peer, tag)
        if grid.nx_dev > 1:
            east, west = east_r, west_r
            sends += [(send_seg(wire_send, 0), grid.west, _TAG_WEST),
                      (send_seg(wire_send, 1), grid.east, _TAG_EAST)]
            recvs += [(recv_seg(wire_recv, 0), grid.east, _TAG_WEST),
                      (recv_seg(wire_recv, 1), grid.west, _TAG_EAST)]
        else:  # periodic x on one grid column: the shard is its own neighbour
            east, west = self.lines[0], self.lines[1]
        north = south = None
        if grid.south is not None:
            south = south_r
            sends.append((send_seg(wire_send, 2), grid.south, _TAG_SOUTH))
            recvs.append((recv_seg(wire_recv, 3), grid.south, _TAG_NORTH))
        if grid.north is not None:
            north = north_r
            sends.append((send_seg(wire_send, 3), grid.north, _TAG_NORTH))
            recvs.append((recv_seg(wire_recv, 2), grid.north, _TAG_SOUTH))
        if self.fold:
            if grid.mirror == grid.rank:
                north = self.lines[4]
            else:
                north = north_r
                sends.append((send_seg(wire_send, 4), grid.mirror, _TAG_FOLD))
                recvs.append((recv_seg(wire_recv, 2), grid.mirror, _TAG_FOLD))
        self._sends, self._recvs = sends, recvs
        self.halos = (east, west, north, south)

    def exchange(self, ready=None) -> None:
        """One exchange round of what `send` holds, into `recv`; `ready`
        (from `ready_event`, on CUDA) marks when `send` was written (default:
        now). Returns
        when the messages have arrived; under gloo with CUDA tensors their
        host-to-device copy is then queued on the current stream."""
        if not self._sends:
            return
        if self.staged:
            side = _side_stream(self.device)
            if ready is None:
                ready = ready_event(self.send)
            with torch.cuda.stream(side):
                side.wait_event(ready)
                self.send_host.copy_(self.send, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            done.synchronize()
        ops = ([dist.P2POp(dist.isend, t, peer, tag=tag) for t, peer, tag in self._sends]
               + [dist.P2POp(dist.irecv, t, peer, tag=tag) for t, peer, tag in self._recvs])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if self.staged:
            self.recv.copy_(self.recv_host, non_blocking=True)


def _pack_plain(chi: torch.Tensor, topology: GridTopology, lines) -> None:
    """The plain version of K7's pack: `_halo_lines` of `chi` copied into
    the send buffer's `lines` (`HaloExchange.lines`; the fold only where
    they have one)."""
    for dst, src in zip(lines, _halo_lines(chi, topology)):
        dst.copy_(src)


def _local_stencil(coeffs: StencilCoeffs, chi: torch.Tensor, halos) -> torch.Tensor:
    """The plain version of K7: T chi on a shard's open box, the edge
    neighbours from `halos` (None reads as zeros), accumulated in chi's
    dtype in the order of `ops.apply.apply_stencil` (so on each shard it
    equals apply_stencil on the whole field bit for bit). chi may carry a
    leading batch axis."""
    zero_col, zero_row = torch.zeros_like(chi[..., 0]), torch.zeros_like(chi[..., 0, :])
    east_h, west_h, north_h, south_h = (
        z if h is None else h for h, z in zip(halos, (zero_col, zero_col, zero_row, zero_row)))
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


def _boundary_patch(coeffs: StencilCoeffs, bulk: torch.Tensor, halos, scale: float):
    """The plain version of K7's edge entry: add the halo terms to a result
    computed on zero halos, in place: scale * coefficient * halo on the
    shard's edge columns and rows, east, west, north, south (scale = 1 for
    an apply, -dt for an Euler step; a None halo adds nothing). The zero
    halos contributed exactly 0 there, so this gives the result on the true
    halos up to the order of the sum at the edge cells. Works on a batch
    (the coefficients broadcast over its leading axis); returns `bulk`."""
    east_h, west_h, north_h, south_h = halos
    c = lambda leg: leg.to(bulk.dtype)
    if east_h is not None:
        bulk[..., -1] += scale * c(coeffs.east[..., -1]) * east_h
    if west_h is not None:
        bulk[..., 0] += scale * c(coeffs.west[..., 0]) * west_h
    if north_h is not None:
        bulk[..., -1, :] += scale * c(coeffs.north[..., -1, :]) * north_h
    if south_h is not None:
        bulk[..., 0, :] += scale * c(coeffs.south[..., 0, :]) * south_h
    return bulk


def apply_stencil_halo(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology,
                       grid: ProcessGrid) -> torch.Tensor:
    """y = T chi on this rank's shard with one halo exchange: the JAX
    package's `apply_stencil_halo` (its `mesh` is `grid` here), which is
    `halo_kernel.stencil_apply_halo` (K7) without overlap. `coeffs` and
    `chi` are the rank's shards, `topology` the global one; every rank
    calls it."""
    from .halo_kernel import stencil_apply_halo  # halo_kernel imports this module

    return stencil_apply_halo(coeffs, chi, topology, grid)
