"""Compulsory bytes of an explicit T + R step, in the style of
`roofline.euler_step_bytes`: the algorithm's traffic on dense (nz, ny, nx)
fields, not a kernel design's.

One step chi <- chi - dt T chi + dt R chi of `batch` tracers sharing T and
R reads T's seven legs, R's 15 coefficient fields of (nz, ny, nx) and its
two of (ny, nx) (`inv_de`, `inv_dn`) and the wet mask (one byte a cell)
once, and each tracer once, and writes each tracer once. A design that
reads a tracer or a coefficient twice in a step (two passes, one for T and
one for R) moves more than this, so a share over these counts is at most
100 % and rises as the passes are fused.
"""

from __future__ import annotations

from .roofline import LEGS

REDI_FIELDS = 15  # (nz, ny, nx) coefficient fields of R
REDI_PLANES = 2  # (ny, nx) fields of R
WET_BYTES = 1


def neutral_step_bytes(shape, vec_bytes: int, coef_bytes: int, batch: int,
                       redi_coef_bytes: int) -> int:
    """One T + R step of `batch` tracers: T's legs in `coef_bytes`, R's
    fields in `redi_coef_bytes`, the tracers in `vec_bytes`."""
    nz, ny, nx = shape
    cells = nz * ny * nx
    per_cell = (2 * vec_bytes * batch + LEGS * coef_bytes + REDI_FIELDS * redi_coef_bytes
                + WET_BYTES)
    return cells * per_cell + REDI_PLANES * ny * nx * redi_coef_bytes
