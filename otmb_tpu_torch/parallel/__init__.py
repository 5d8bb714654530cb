"""The multi-device layer on `torch.distributed`, in SPMD form: one process
per rank, each holding the (nz, ny / ny_dev, nx / nx_dev) shard of every
field on a (ny_dev, nx_dev) process grid (`mesh`), a one-cell halo
exchange with the tripolar fold (`halo`), and the shard-local kernels K7
(stencil, `halo_kernel`), K8 (assembly, `assemble_halo`) and K9 (Redi,
`redi_halo`); the Krylov solves run the port's one engine on the shards
(`solve_halo`), and `ideal_age`, `sequestration_time`,
`solve_shifted_ir` and the batched solves (`solve_shifted_multi`,
`solve_shifted_chunked_multi`, `water_mass_fractions`) take `grid=`.
Every function that takes a grid is collective: all its ranks call it
together.
"""

from .assemble_halo import assemble_T_halo
from .halo import apply_stencil_halo
from .halo_kernel import (
    euler_propagate_halo,
    euler_propagate_halo_multi,
    stencil_apply_halo,
    stencil_apply_halo_multi,
)
from .mesh import (
    ProcessGrid,
    gather_field,
    initialize_distributed,
    make_process_grid,
    shard_field,
    shard_pytree,
    spawn_grid,
)
from .redi_halo import RediShard, redi_apply_halo, redi_shard
from .solve_halo import solve_shifted_halo, transpose_coeffs_halo

__all__ = [
    "ProcessGrid",
    "RediShard",
    "apply_stencil_halo",
    "assemble_T_halo",
    "euler_propagate_halo",
    "euler_propagate_halo_multi",
    "gather_field",
    "initialize_distributed",
    "make_process_grid",
    "redi_apply_halo",
    "redi_shard",
    "shard_field",
    "shard_pytree",
    "solve_shifted_halo",
    "spawn_grid",
    "stencil_apply_halo",
    "stencil_apply_halo_multi",
    "transpose_coeffs_halo",
]
