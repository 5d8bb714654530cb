"""Time stepping and matrix-free steady-state solves for the transport operator.

Counterpart of the main-path subset of `otmb_tpu.models.solvers`: explicit
Euler through the K1 kernel, right-preconditioned BiCGStab with the
Jacobi or the vertical-line Thomas preconditioner (K2), mixed-precision
iterative refinement, and the ideal-age workload.

The Krylov loop runs on the host and keeps its scalars on the device; it
reads the residual back every `_CHECK_EVERY` iterations. The scalar shift
and the extra diagonal are folded into the stencil diagonal, so a matvec
is one K1 launch. Tracer fields are dense (nz, ny, nx) with zeros on
land, and every operator application keeps them so.
"""

from __future__ import annotations

import math
import time
import warnings

import torch

from ..grid.topology import GridTopology
from ..ops.apply import transpose_coeffs
from ..ops.coeffs import StencilCoeffs
from ..ops.stencil import euler_propagate, euler_step, stencil_apply
from ..ops.tridiag import tridiag_solve

#: Iterations between host reads of the BiCGStab residual.
_CHECK_EVERY = 8


def explicit_euler_step(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float,
                        topology: GridTopology):
    """chi - dt * T chi (forward Euler for d(chi)/dt = -T chi)."""
    return euler_step(coeffs, chi, dt, topology)


def explicit_euler_propagate(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float,
                             nsteps: int, topology: GridTopology):
    """nsteps of forward Euler."""
    return euler_propagate(coeffs, chi, dt, nsteps, topology)


def _jacobi_preconditioner(diag: torch.Tensor):
    """M^-1 ~ 1/diag, 0 on land where diag == 0."""
    inv = torch.where(diag != 0, torch.reciprocal(torch.where(diag != 0, diag, 1.0)), 0.0)
    return lambda x: inv * x


def _tridiag_preconditioner(coeffs: StencilCoeffs, shifted_diag: torch.Tensor):
    """Vertical-line preconditioner: a per-column Thomas solve (K2) of
    M = diag(shifted) + T_top + T_bottom, the stiff vertical-diffusion part
    of T. Land columns get a unit diagonal."""
    diag = torch.where(shifted_diag != 0, shifted_diag, 1.0)
    # lower = bottom couples to k+1, upper = top to k-1
    return lambda b: tridiag_solve(coeffs.bottom, diag, coeffs.top, b)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, 1.0, x)


def _bicgstab(a_op, b: torch.Tensor, M, tol: float, maxiter: int):
    """Right-preconditioned BiCGStab, the algorithm and breakdown guards of
    `_bicgstab_matrix_free` (otmb_tpu/models/solvers.py). Stops once
    ||r|| <= tol * ||b|| (read every `_CHECK_EVERY` iterations), at
    maxiter, or when the recurrence is no longer finite. Returns
    (x, iterations)."""
    atol2 = (tol * float(torch.linalg.vector_norm(b))) ** 2
    x = torch.zeros_like(b)
    r = p = rhat0 = b
    rho = _dot(r, r)
    it = 0
    while it < maxiter:
        if it % _CHECK_EVERY == 0:
            rr = float(_dot(r, r))
            if rr <= atol2 or not math.isfinite(rr):
                break
        phat = M(p)
        v = a_op(phat)
        alpha = rho / _nonzero(_dot(rhat0, v))
        s = r - alpha * v
        shat = M(s)
        t = a_op(shat)
        omega = _dot(t, s) / _nonzero(_dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = _dot(rhat0, r)
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        rho = rho_new
        it += 1
    return x, it


def solve_shifted(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                  shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                  tol: float = 1e-10, maxiter: int = 2000, transpose: bool = False,
                  preconditioner: str = "tridiag", stats: dict | None = None):
    """Solve (shift * I + D_extra + T) x = b matrix-free with BiCGStab
    (T' instead of T when `transpose`). Returns (x, relative residual
    ||Ax - b|| / ||b||, recomputed from x in b's dtype).

    The operator runs in b's dtype. A solve that stops at maxiter is not
    an error; the residual says so.
    `stats`, if a dict, receives ``iters``."""
    if transpose:
        coeffs = transpose_coeffs(coeffs, topology)
    coeffs = coeffs.to(b.dtype)
    extra = 0.0 if extra_diag is None else extra_diag.to(b.dtype)
    a_coeffs = coeffs._replace(diag=shift + extra + coeffs.diag)

    def a_op(x):
        return stencil_apply(a_coeffs, x, topology)

    if preconditioner == "tridiag":
        precond = _tridiag_preconditioner(coeffs, a_coeffs.diag)
    elif preconditioner == "jacobi":
        precond = _jacobi_preconditioner(a_coeffs.diag)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    x, iters = _bicgstab(a_op, b, precond, tol, maxiter)
    if stats is not None:
        stats["iters"] = iters
    bnorm = float(torch.linalg.vector_norm(b))
    res = float(torch.linalg.vector_norm(a_op(x) - b)) / (bnorm if bnorm else 1.0)
    return x, res


def _ir_defect(c_narrow: StencilCoeffs, x: torch.Tensor, b_narrow: torch.Tensor,
               extra_narrow: torch.Tensor, shift: float, bnorm_safe: float,
               topology: GridTopology):
    """One wide defect r = b - A x from the NARROW coefficients (widened
    inside the K1 kernel, exactly), and its normalised form: returns
    (r / s, s, s / ||b||) with s = ||r|| (1 where r == 0)."""
    wide = x.dtype
    r = b_narrow.to(wide) - (shift * x + extra_narrow.to(wide) * x
                             + stencil_apply(c_narrow, x, topology))
    s = float(torch.linalg.vector_norm(r))
    s_safe = s if s != 0 else 1.0
    return r / s_safe, s_safe, s / bnorm_safe


def solve_shifted_ir(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                     shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                     tol: float = 1e-9, inner_tol: float = 1e-4,
                     max_refinements: int = 10, maxiter: int = 2000,
                     inner_maxiter: int | None = None, transpose: bool = False,
                     preconditioner: str = "tridiag", stats: dict | None = None):
    """`solve_shifted` with mixed-precision iterative refinement: inner
    BiCGStab solves in the coefficients' precision (f32 or f64) and the
    defect b - A x in f64, through the K1 kernel on the narrow
    coefficients. Returns (x in f64, relative residual).

    As in the JAX package: the best iterate is kept (narrow) and restored
    after a pass that made the defect 4x worse (or not finite); two
    consecutive passes without a 0.9x contraction stop the loop with a
    warning; each pass asks its inner solve only for the contraction still
    needed, max(inner_tol, 0.5 * tol / rel), at most 0.9.

    `stats`, if a dict, receives ``passes`` (one dict per pass: rel_start,
    reverted, inner_tol, inner_iters, wall_s), ``refinements`` and
    ``rel_final``."""
    if transpose:
        coeffs = transpose_coeffs(coeffs, topology)
    wide = torch.float64
    narrow = coeffs.diag.dtype
    inner_maxiter = maxiter if inner_maxiter is None else min(maxiter, inner_maxiter)

    extra_n = torch.zeros((), dtype=b.dtype, device=b.device) if extra_diag is None else extra_diag
    b_nv = b.to(narrow)
    bn_n = float(torch.linalg.vector_norm(b_nv))
    bnorm_safe = bn_n if bn_n != 0 else 1.0

    x = torch.zeros(b.shape, dtype=wide, device=b.device)
    rel = math.inf
    rel_prev = math.inf
    stagnant = 0
    best_x = None
    best_rel = math.inf
    pass_log = [] if stats is None else stats.setdefault("passes", [])

    for pass_i in range(max_refinements):
        t_pass = time.perf_counter()
        if pass_i == 0:
            # x == 0, so the defect is b: no wide apply needed.
            r_hat, s_safe, rel = b_nv / bnorm_safe, bnorm_safe, bn_n / bnorm_safe
        else:
            r_hat, s_safe, rel = _ir_defect(coeffs, x, b, extra_n, shift,
                                            bnorm_safe, topology)
        if rel < best_rel:
            best_rel = rel
            best_x = x.to(narrow)
        if rel <= tol:
            break
        reverted = False
        if best_x is not None and not rel <= 4.0 * best_rel:
            # the last pass diverged: refine from the best iterate instead
            x = best_x.to(wide)
            r_hat, s_safe, rel = _ir_defect(coeffs, x, b, extra_n, shift,
                                            bnorm_safe, topology)
            reverted = True
        entry = {"rel_start": rel, "reverted": reverted}
        pass_log.append(entry)
        stagnant = stagnant + 1 if rel >= 0.9 * rel_prev else 0
        if stagnant >= 2:
            warnings.warn(
                f"solve_shifted_ir: refinement stagnated at relative residual "
                f"{rel:.3e} (previous {rel_prev:.3e}); the inner BiCGStab solve is "
                f"likely exiting at its inner_maxiter={inner_maxiter} budget without "
                f"reaching inner_tol={inner_tol}.",
                stacklevel=2,
            )
            entry["stagnated"] = True
            break
        rel_prev = rel
        pass_tol = min(0.9, max(inner_tol, 0.5 * tol / rel))
        inner = {}
        d, _ = solve_shifted(coeffs, r_hat.to(narrow), topology, shift=shift,
                             extra_diag=extra_diag, tol=pass_tol, maxiter=inner_maxiter,
                             preconditioner=preconditioner, stats=inner)
        x = x + s_safe * d.to(wide)
        entry.update(inner_tol=pass_tol, inner_iters=inner["iters"],
                     wall_s=time.perf_counter() - t_pass)
    else:
        _, _, rel = _ir_defect(coeffs, x, b, extra_n, shift, bnorm_safe, topology)
        if rel < best_rel:
            best_rel, best_x = rel, x
    if best_x is not None and best_rel < rel:
        # the f32-rounded recovery point: keep it only if it really is better
        x_cand = best_x.to(wide)
        _, _, rel_cand = _ir_defect(coeffs, x_cand, b, extra_n, shift,
                                    bnorm_safe, topology)
        if rel_cand < rel:
            x, rel = x_cand, rel_cand
    if stats is not None:
        stats.update(refinements=len(pass_log), rel_final=rel)
    return x, rel


def ideal_age(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
              surface_rate: float = 1.0, tol: float = 1e-8, refine: bool = False,
              stats: dict | None = None):
    """Steady-state ideal mean age Gamma (seconds) from
    (T + M) Gamma = 1 on wet cells, M = surface_rate on the surface layer
    (reference test/local_full.jl:155-168). Returns (gamma with NaN on
    land, relative residual). `refine=True` runs `solve_shifted_ir`
    (f32 inner solves, f64 defects) and returns gamma in f64."""
    wet = wet3d.to(torch.bool)
    ones = wet.to(coeffs.diag.dtype)
    surf = torch.zeros_like(ones)
    surf[0] = surface_rate
    surf = torch.where(wet, surf, 0.0)
    if refine:
        gamma, res = solve_shifted_ir(coeffs, ones, topology, extra_diag=surf, tol=tol,
                                      stats=stats)
    else:
        gamma, res = solve_shifted(coeffs, ones, topology, extra_diag=surf, tol=tol,
                                   stats=stats)
    return torch.where(wet, gamma, float("nan")), res
