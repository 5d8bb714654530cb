"""Compulsory bytes of the algorithms the cells time, and the chip's peaks.

The counts are the algorithm's work, not a kernel design's: dense
(nz, ny, nx) fields, each field an algorithm stage needs is read once and
each field it produces written once, per stage between two global sums
(a stage cannot begin before the sum that closes the last one). A kernel
that fuses stages' passes moves no fewer bytes than this; one that reads a
field twice, or stores what it could have kept on chip, moves more. So a
share over these counts rises toward 100 % as kernels are fused and never
passes it, unless a design recomputes a stencil product instead of
storing it, or carries state across Euler steps, which these counts do
not foresee.

The operator A = T + diag(shift + extra) has seven legs (the extra
diagonal folded into the diagonal leg); the vertical-line preconditioner M
is the tridiagonal part of A, so it reads no legs of its own.
"""

from __future__ import annotations

#: Published peak of one NVIDIA H100 SXM (80 GB HBM3, 700 W): bytes/s of
#: device memory. A share is stated against it, with the card's power
#: limit beside it.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
LEGS = 7


def peak_bytes_per_s(kind: str) -> float | None:
    """The table's peak for a card name, None for a card it lacks."""
    return PEAK_BYTES_PER_S.get(kind)


def _cells(shape) -> int:
    nz, ny, nx = shape
    return nz * ny * nx


def bicgstab1_iteration_bytes(shape, vec_bytes: int, coef_bytes: int, batch: int = 1) -> int:
    """One iteration of right-preconditioned BiCGStab(1) on `batch`
    right-hand sides sharing A, in three stages:

      1. p = r + beta (p - omega v); p^ = M p; v = A p^; <r^, v>
         reads r, p, v, r^ and the legs; writes p, p^, v        (4 + 3)
      2. s = r - alpha v; s^ = M s; t = A s^; <t, s>, <t, t>
         reads r, v and the legs; writes s, s^, t               (2 + 3)
      3. x += alpha p^ + omega s^; r = s - omega t; <r^, r>
         reads x, p^, s^, s, t, r^; writes x, r                 (6 + 2)

    20 vector streams per member and the legs twice."""
    n = _cells(shape)
    return n * (20 * vec_bytes * batch + 2 * LEGS * coef_bytes)


def bicgstab2_cycle_bytes(shape, vec_bytes: int, coef_bytes: int, batch: int = 1) -> int:
    """One cycle of BiCGStab(2) (Sleijpen & Fokkema 1993) on K = A M in
    y-space, in five stages (u0_old: the step-0 direction, kept for the
    deferred y += alpha u0):

      1. u0 = r0 - beta u0; u1 = K u0; <r^, u1>
         reads r0, u0, r^, legs; writes u0, u1                  (3 + 2)
      2. r0 -= alpha u1; r1 = K r0; <r^, r1>
         reads r0, u1, r^, legs; writes r0, r1                  (3 + 2)
      3. u0 = r0 - beta u0_old; u1 = r1 - beta u1; u2 = K u1; <r^, u2>
         reads r0, u0_old, r1, u1, r^, legs; writes u0, u1, u2  (5 + 3)
      4. r1 -= alpha u2; r2 = K r1; r0 -= alpha u1; the five polish sums
         reads r1, u2, r0, u1, legs; writes r1, r2, r0          (4 + 3)
      5. the polish updates of y, r0, u0 with y += alpha u0_old; <r^, r0>
         reads y, u0_old, u0, r0, r1, r2, u1, u2, r^; writes y, r0, u0
                                                                (9 + 3)

    37 vector streams per member and the legs four times."""
    n = _cells(shape)
    return n * (37 * vec_bytes * batch + 4 * LEGS * coef_bytes)


def euler_step_bytes(shape, vec_bytes: int, coef_bytes: int, batch: int = 1) -> int:
    """One explicit Euler step x <- x - dt A x of `batch` tracers sharing A:
    the legs once, each tracer read once and written once."""
    n = _cells(shape)
    return n * (2 * vec_bytes * batch + LEGS * coef_bytes)
