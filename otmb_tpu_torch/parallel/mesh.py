"""The process grid: one process per rank, each holding one shard.

Counterpart of `otmb_tpu.parallel.mesh` on `torch.distributed`, in SPMD
form. The ranks form a 2D (y, x) grid with x innermost, as
`make_grid_mesh` lays out its devices: rank r sits at (r // nx_dev,
r % nx_dev) and holds the (nz, ny / ny_dev, nx / nx_dev) shard of every
(nz, ny, nx) field whose global offset is (j0, i0). The k axis is never
sharded: the flux closure and the vertical solves are sequential in k.

The neighbours of a shard follow the grid's topology: x is periodic, so
the east neighbour of the last grid column is the first; y is open; on a
tripolar grid the north neighbour of the top shard row is its mirror
shard (y, nx_dev - 1 - x), across the fold.

Backends: "nccl" when each rank has its own GPU; "gloo" on the CPU, and for
ranks that share one card, which NCCL refuses. Gloo's point-to-point
messages take host tensors only, so with gloo and CUDA tensors the halo
lines are staged through host memory (`ProcessGrid.host_staged`); the
kernels still run on the card.

`spawn_grid` starts a grid of ranks on one machine with a deadline (the
tests and `chip_smoke.py` use it); on several GPUs, start one process per
GPU with `torchrun` and call `initialize_distributed("nccl")` in each.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..utils.device import default_device

log = logging.getLogger(__name__)

#: Seconds a collective may wait for its peers before it fails.
TIMEOUT_S = 120


def _factor2d(n: int) -> tuple[int, int]:
    """Most-square factorisation a * b == n with a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """This rank's place in a (ny_dev, nx_dev) grid of ranks, x innermost."""

    shape: tuple[int, int]
    rank: int
    device: torch.device
    backend: str

    @property
    def ny_dev(self) -> int:
        return self.shape[0]

    @property
    def nx_dev(self) -> int:
        return self.shape[1]

    @property
    def y(self) -> int:
        return self.rank // self.nx_dev

    @property
    def x(self) -> int:
        return self.rank % self.nx_dev

    def rank_of(self, y: int, x: int) -> int:
        return y * self.nx_dev + x

    @property
    def east(self) -> int:
        return self.rank_of(self.y, (self.x + 1) % self.nx_dev)

    @property
    def west(self) -> int:
        return self.rank_of(self.y, (self.x - 1) % self.nx_dev)

    @property
    def north(self) -> int | None:
        """The rank above, None on the top shard row (whose north is the
        fold or nothing)."""
        return self.rank_of(self.y + 1, self.x) if self.y + 1 < self.ny_dev else None

    @property
    def south(self) -> int | None:
        return self.rank_of(self.y - 1, self.x) if self.y > 0 else None

    @property
    def mirror(self) -> int:
        """The tripolar fold partner of the top shard row: (y, nx_dev - 1 - x)."""
        return self.rank_of(self.y, self.nx_dev - 1 - self.x)

    @property
    def is_top(self) -> bool:
        return self.y == self.ny_dev - 1

    @property
    def host_staged(self) -> bool:
        """Gloo with CUDA tensors: messages go through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def local_shape(self, ny: int, nx: int) -> tuple[int, int]:
        """(ny_l, nx_l) of a shard; raises if the grid does not divide."""
        if ny % self.ny_dev or nx % self.nx_dev:
            raise ValueError(f"a ({ny}, {nx}) field does not divide over a {self.shape} "
                             f"process grid")
        return ny // self.ny_dev, nx // self.nx_dev

    def offset(self, ny: int, nx: int) -> tuple[int, int]:
        """The global (j0, i0) of this rank's shard."""
        ny_l, nx_l = self.local_shape(ny, nx)
        return self.y * ny_l, self.x * nx_l


def initialize_distributed(backend: str, init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None) -> None:
    """Join the process group: once per process, before `make_process_grid`.

    `backend` is explicit: "nccl" for one rank per GPU, "gloo" on the CPU
    and for ranks that share a card. Without `init_method` the address,
    world size and rank come from the environment (`torchrun` sets them);
    with it ("tcp://localhost:<port>", "file://<path>") pass `world_size`
    and `rank`. With NCCL the rank's GPU is LOCAL_RANK (default: rank).
    A collective that waits longer than `TIMEOUT_S` for its peers fails.
    """
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def make_process_grid(shape: tuple[int, int] | None = None, device=None) -> ProcessGrid:
    """This rank's `ProcessGrid` over the whole process group: `shape` =
    (ny_dev, nx_dev), default the most square factorisation of the world
    size (`_factor2d`). `device` is where the rank's tensors live: default
    the current CUDA device under either backend (raises without one);
    pass "cpu" to run the rank on the host."""
    n = dist.get_world_size()
    if shape is None:
        shape = _factor2d(n)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != n:
        raise ValueError(f"process grid {shape} != {n} ranks")
    backend = dist.get_backend()
    grid = ProcessGrid(shape, dist.get_rank(), default_device(device), backend)
    if grid.host_staged and grid.rank == 0:
        log.info("process grid %s on %s with gloo: halo lines are staged through host memory",
                 shape, grid.device)
    return grid


def _shard_tensor(x: torch.Tensor, grid: ProcessGrid, ny: int, nx: int) -> torch.Tensor:
    if x.ndim < 2 or tuple(x.shape[-2:]) != (ny, nx):
        return x  # 1D fields (zt) and scalars are replicated
    ny_l, nx_l = grid.local_shape(ny, nx)
    j0, i0 = grid.offset(ny, nx)
    return x[..., j0:j0 + ny_l, i0:i0 + nx_l].contiguous()


def shard_pytree(tree: Any, grid: ProcessGrid, shape2d: tuple[int, int]) -> Any:
    """This rank's shard of every tensor in `tree` whose trailing axes are
    the global (ny, nx) = `shape2d`: tensors, tuples and NamedTuples
    (StencilCoeffs), and frozen dataclasses (GridMetrics, PerDirection,
    RediOperator). Other leaves, 1D fields and the GridTopology pass
    unchanged: a shard keeps the global topology, which the fold needs."""
    ny, nx = shape2d
    if isinstance(tree, torch.Tensor):
        return _shard_tensor(tree, grid, ny, nx)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_pytree(v, grid, shape2d) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_pytree(v, grid, shape2d) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: shard_pytree(getattr(tree, f.name), grid, shape2d)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_field(x: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
    """This rank's shard of a field (..., ny, nx)."""
    return _shard_tensor(x, grid, *x.shape[-2:])


def _on_wire(t: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
    """`t` where the backend sends it from: host memory under gloo, the
    rank's device under NCCL."""
    return t.to("cpu" if grid.backend == "gloo" else grid.device)


def gather_field(x_local: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
    """The whole field (..., ny, nx) from every rank's shard, on every rank
    (for tests and checks; a solve never gathers)."""
    x = _on_wire(x_local.contiguous(), grid)
    parts = [torch.empty_like(x) for _ in range(grid.ny_dev * grid.nx_dev)]
    dist.all_gather(parts, x)
    rows = [torch.cat(parts[y * grid.nx_dev:(y + 1) * grid.nx_dev], dim=-1)
            for y in range(grid.ny_dev)]
    return torch.cat(rows, dim=-2).to(x_local.device)


def all_reduce_sum(t: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
    """The sum of `t` over all ranks, on `t`'s device; the same bits on
    every rank."""
    buf = _on_wire(t.detach().clone(), grid)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device)


def _rank_main(rank: int, fn: Callable, shape: tuple[int, int], backend: str,
               device: str | None, init_file: str, out_dir: str, args: tuple) -> None:
    world = shape[0] * shape[1]
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    elif device is not None:
        torch.cuda.set_device(torch.device(device))
    initialize_distributed(backend, init_method=f"file://{init_file}", world_size=world,
                           rank=rank)
    try:
        grid = make_process_grid(shape, device=device)
        result = fn(grid, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_grid(fn: Callable, shape: tuple[int, int], args: tuple = (), backend: str = "gloo",
               device: str | None = None, timeout_s: float = 600.0) -> list:
    """Run `fn(grid, *args)` on a (ny_dev, nx_dev) grid of ranks, one
    spawned process each, joined through a file store in a temporary
    directory; returns each rank's result (saved with `torch.save`, so
    return host data). `fn` must be importable by the children (a module-
    level function). `device` is each rank's, as in `make_process_grid`:
    default the current CUDA device (with gloo every rank shares it; with
    NCCL rank r takes GPU r), "cpu" to rehearse on the host. A rank's
    exception fails the run, and so does the deadline: the remaining ranks
    are killed."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="otmb_grid_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(shape), backend,
                              None if device is None else str(device),
                              os.path.join(tmp, "store"), tmp, tuple(args)),
            nprocs=shape[0] * shape[1], join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"process grid {shape}: ranks still running after "
                                       f"{timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(shape[0] * shape[1])]
