"""Krylov solves on a process grid, through the port's one engine.

Replaces `otmb_tpu/parallel/solve_halo.py` (BiCGStab(1) in one
`while_loop` inside `shard_map`) and `otmb_tpu/parallel/solve_halo_chunked.py`
(host-chunked BiCGStab(1)/(2) on the mesh) with the field operations of a
shard (`halo_field`), which the solvers of `models/solvers.py` take
through their `grid=` argument; the engine then runs unchanged on each
rank's shard:

  * the matvec is the halo exchange plus K7 (`halo_kernel.stencil_apply_halo`'s
    step: pack, bulk, edge), with the JAX package's `overlap=True` default;
  * the preconditioner is K2 on the shard's own columns: k is never
    sharded, so the Thomas solve needs no communication;
  * the dot is the local `torch.dot` plus one `all_reduce` (SUM), and the
    norm its square root, so every rank reads the same residuals, and
    every stop, stall, restart and divergence decision of the engine is
    taken in lockstep; BiCGStab(2)'s five polish sums (K11) are one
    all-reduce of the stacked local sums, and K12's <rhat, r0> another;
  * a jittered restart alternates its sign by the global index (the
    shard's offset), so it builds the slice of the whole field's shadow
    vector.

BiCGStab(1) and BiCGStab(2) both run unfused on K7 + K2, as
`solve_halo_chunked.py` does: K3 has no halo mode. T' for the adjoint solves
is formed once per solve by `transpose_coeffs_halo`, which needs one line
of each horizontal leg from the neighbours. A batch of right-hand sides
(`solve_shifted_chunked_multi`, `solve_shifted_multi`,
`water_mass_fractions` with `grid=`; the JAX package runs them by GSPMD
over the jnp matvec) runs the same engine in lockstep: its matvec is one
exchange of the batch's halo lines and one K7 multi launch, its M the
batched K2, and each reduction one all-reduce of the (B,) partial dots.
"""

from __future__ import annotations

import math

import torch

from ..grid.topology import GridTopology
from ..models.solvers import _dot, _Field, _read, solve_shifted_chunked
from ..ops.coeffs import StencilCoeffs
from .halo import HaloExchange, _exchange
from .halo_kernel import _run
from .mesh import ProcessGrid, all_reduce_sum


def halo_field(topology: GridTopology, grid: ProcessGrid, overlap: bool = True) -> _Field:
    """The solvers' field operations on this rank's shard: T x by the halo
    exchange and K7 (`halo_kernel.stencil_apply_halo`'s step, through one
    `HaloExchange` per field dtype and shape, made at its first matvec and
    reused by the rest of the solve; a batch (B, nz, ny_l, nx_l) is one
    exchange of its lines and one K7 multi launch), all-reduced dots and
    norms (a batch's (B,) partial dots in one all-reduce), the shard's
    offset."""
    plans: dict = {}

    def apply(c: StencilCoeffs, x: torch.Tensor) -> torch.Tensor:
        key = (x.dtype, tuple(x.shape), x.device)
        plan = plans.get(key)
        if plan is None:
            plan = plans[key] = HaloExchange(x, topology, grid)
        return _run(c, x, topology, grid, None, 1, overlap, x.ndim == 4, plan)

    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(_dot(a, b), grid)

    return _Field(
        apply=apply,
        dot=dot,
        norm=lambda v: math.sqrt(_read(dot(v, v), "norm")[0]),
        reduce=lambda sums: all_reduce_sum(sums, grid),
        offset=grid.offset(topology.ny, topology.nx),
    )


def transpose_coeffs_halo(coeffs: StencilCoeffs, topology: GridTopology,
                          grid: ProcessGrid) -> StencilCoeffs:
    """This rank's shard of `ops.apply.transpose_coeffs(T)`, from its shard
    of T: T''s leg towards a neighbour is the neighbour's opposite leg, so
    each horizontal leg needs one line from one side (the fold partner's
    reversed north leg on the tripolar top row). One exchange round; the
    result equals the slice of the whole field's T' bit for bit."""
    flip = lambda t: torch.flip(t, dims=(-1,))
    east_h, west_h, north_h, south_h = _exchange(
        grid, coeffs.west[..., 0], coeffs.east[..., -1], coeffs.south[..., 0, :],
        coeffs.north[..., -1, :], flip(coeffs.north[..., -1, :]) if topology.is_tripolar else None,
    ).wait()
    zero = torch.zeros_like(coeffs.diag[:1])
    return StencilCoeffs(
        diag=coeffs.diag,
        east=torch.cat([coeffs.west[..., 1:], east_h[..., None]], dim=-1),
        west=torch.cat([west_h[..., None], coeffs.east[..., :-1]], dim=-1),
        north=torch.cat([coeffs.south[..., 1:, :], north_h[..., None, :]], dim=-2),
        south=torch.cat([south_h[..., None, :], coeffs.north[..., :-1, :]], dim=-2),
        top=torch.cat([zero, coeffs.bottom[:-1]], dim=0),
        bottom=torch.cat([coeffs.top[1:], zero], dim=0),
    )


def solve_shifted_halo(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                       grid: ProcessGrid, **kwargs):
    """Solve (shift * I + D_extra + T) x = b (T' when `transpose`) on a
    process grid: `solve_shifted_chunked(..., grid=grid)`, whose arguments
    it takes (`algorithm`, `transpose`, `preconditioner`, `overlap`,
    `stats`, ...). `coeffs`, `b` and `extra_diag` are this rank's shards,
    `topology` the global one, and every rank calls it. Returns (the rank's
    shard of x, the relative residual ||A x - b|| / ||b|| of the whole
    field, recomputed from x; the same on every rank). `solve_shifted`'s
    rules are early_stop=False, max_restarts=0, max_diverge_restarts=0."""
    return solve_shifted_chunked(coeffs, b, topology, grid=grid, **kwargs)
