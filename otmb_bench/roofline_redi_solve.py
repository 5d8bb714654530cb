"""Compulsory bytes of a BiCGStab(1) iteration on T - R, in the style of
`roofline.bicgstab1_iteration_bytes`: the algorithm's traffic on dense
(nz, ny, nx) fields, not a kernel design's.

An iteration applies the operator twice (v = A p^ and t = A s^). With the
Redi operator R each application reads, besides T's legs, R's 15
coefficient fields, its two (ny, nx) planes and the wet mask (one byte a
cell), so T - R's iteration moves the T iteration's bytes and two reads of
R. M's Thomas legs (T's vertical legs less R's pure vertical ones) are
formed once a system, as T's are, and are not counted.
"""

from __future__ import annotations

from .roofline import bicgstab1_iteration_bytes
from .roofline_neutral import REDI_FIELDS, REDI_PLANES, WET_BYTES


def redi_read_bytes(shape, redi_coef_bytes: int) -> int:
    """One read of R: its fields, its planes and the wet mask."""
    nz, ny, nx = shape
    return (nz * ny * nx * (REDI_FIELDS * redi_coef_bytes + WET_BYTES)
            + REDI_PLANES * ny * nx * redi_coef_bytes)


def bicgstab1_redi_iteration_bytes(shape, vec_bytes: int, coef_bytes: int, batch: int,
                                   redi_coef_bytes: int) -> int:
    """One iteration on T - R: T's iteration (`bicgstab1_iteration_bytes`)
    and R read twice."""
    return (bicgstab1_iteration_bytes(shape, vec_bytes, coef_bytes, batch)
            + 2 * redi_read_bytes(shape, redi_coef_bytes))
