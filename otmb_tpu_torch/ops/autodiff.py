"""Differentiable operator layer: autograd rules for the kernels and the
implicit-function adjoint of the steady-state solves.

Counterpart of `otmb_tpu.ops.autodiff`. Torch differentiates the plain
paths (`ops.apply.apply_stencil`, `assemble_transport`) by itself; what it
cannot differentiate are the CUDA kernels and the host-driven Krylov loop.
Their exact rules, as `torch.autograd.Function`s:

  * apply:  y = T(c) x
        x_bar = T(c)' y_bar;   c_bar_d = y_bar * gather_d(x)
  * Euler step:  y = x - dt T(c) x
        x_bar = y_bar - dt T' y_bar;   c_bar_d = -dt y_bar * gather_d(x)
  * implicit solve:  A(c) x = b,  A = sigma I + diag(D) + T(c)
        z = A'^{-1} x_bar
        b_bar = z;  sigma_bar = -<z, x>;  D_bar = -z * x;
        c_bar_d = -z * gather_d(x)

The forward and the x cotangent go through K1 (`ops/stencil.py`) on a CUDA
tensor: the cotangent is K1 on `transpose_coeffs` (the stencil form of
T'), one launch per backward. The leg cotangents are eager torch, as the
JAX package's are jnp. The adjoint of a solve is one transpose solve with
the forward's options (`grid=` and `algorithm=` included), so gradients
run at the forward solve's speed.

kappa gradients flow through the plain `models.transport.assemble_transport`,
which is torch end to end (as in the reference's
`examples/calibrate_kappa.py:43`); K4 (`assemble_T`) has no backward, and
neither has the JAX package's Pallas assembly.
"""

from __future__ import annotations

import torch

from ..grid.topology import DIRECTIONS, GridTopology, neighbor_values
from .apply import transpose_coeffs
from .coeffs import StencilCoeffs
from .stencil import euler_step, stencil_apply


def _neighbors(x: torch.Tensor, topology: GridTopology, grid=None) -> dict:
    """x's value at each cell's neighbour in every direction, 0 where none:
    on the whole field by `neighbor_values`; on a process grid's shard
    (`grid`) from x and its exchanged halo lines (the fold partner's
    reversed row on the tripolar top row), as K7 reads them."""
    if grid is None:
        return {d: neighbor_values(x, d, topology, fill=0.0) for d in DIRECTIONS}
    from ..parallel.halo import _halo_exchange

    halos = _halo_exchange(x, topology, grid).wait()
    east_h, west_h, north_h, south_h = halos
    zero = torch.zeros_like(x[:1])
    return {
        "east": torch.cat([x[..., 1:], east_h[..., None]], dim=-1),
        "west": torch.cat([west_h[..., None], x[..., :-1]], dim=-1),
        "north": torch.cat([x[..., 1:, :], north_h[..., None, :]], dim=-2),
        "south": torch.cat([south_h[..., None, :], x[..., :-1, :]], dim=-2),
        "top": torch.cat([zero, x[:-1]], dim=0),
        "bottom": torch.cat([x[1:], zero], dim=0),
    }


def _coeff_cotangents(ybar: torch.Tensor, x: torch.Tensor, topology: GridTopology,
                      scale: float, dtype: torch.dtype, grid=None) -> tuple:
    """d<ybar, scale T(c) x>/dc, leg by leg in StencilCoeffs order: the
    diagonal's is scale * ybar * x, each neighbour leg's scale * ybar times
    the neighbour value it multiplies in the forward apply; in the
    coefficients' dtype."""
    nb = _neighbors(x, topology, grid)
    sy = scale * ybar
    return tuple((sy * (x if leg == "diag" else nb[leg])).to(dtype)
                 for leg in StencilCoeffs._fields)


class _ApplyAD(torch.autograd.Function):
    """y = T chi (K1); backward: K1 on T' and the leg cotangents."""

    @staticmethod
    def forward(ctx, topology, dt, chi, *legs):
        coeffs = StencilCoeffs(*legs)
        ctx.topology, ctx.dt = topology, dt
        ctx.save_for_backward(chi, *legs)
        if dt is None:
            return stencil_apply(coeffs, chi, topology)
        return euler_step(coeffs, chi, dt, topology)

    @staticmethod
    def backward(ctx, ybar):
        chi, *legs = ctx.saved_tensors
        topology, dt = ctx.topology, ctx.dt
        coeffs = StencilCoeffs(*legs)
        ybar = ybar.contiguous()
        chi_bar = None
        if ctx.needs_input_grad[2]:
            tc = transpose_coeffs(coeffs, topology)
            chi_bar = (stencil_apply(tc, ybar, topology) if dt is None
                       else euler_step(tc, ybar, dt, topology))
        legs_bar = (None,) * len(legs)
        if any(ctx.needs_input_grad[3:]):
            legs_bar = _coeff_cotangents(ybar, chi, topology, 1.0 if dt is None else -dt,
                                         legs[0].dtype)
        return (None, None, chi_bar, *legs_bar)


def apply_stencil_ad(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology):
    """y = T @ chi, differentiable in the coefficients and the tracer
    (the JAX package's `apply_stencil_ad`): forward and x cotangent through
    K1 on a CUDA tensor, the plain version on the CPU."""
    return _ApplyAD.apply(topology, None, chi, *coeffs)


def euler_step_ad(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float,
                  topology: GridTopology):
    """chi - dt * T @ chi (K1's fused Euler step), differentiable in the
    coefficients and the tracer, for propagation loops under autograd;
    the x cotangent is y_bar - dt T' y_bar, one K1 Euler step on T'."""
    return _ApplyAD.apply(topology, float(dt), chi, *coeffs)


class _SolveAD(torch.autograd.Function):
    """x = A^-1 b by `solve_shifted`; backward: one transpose solve."""

    @staticmethod
    def forward(ctx, topology, opts, b, shift, extra_diag, *legs):
        from ..models.solvers import solve_shifted

        coeffs = StencilCoeffs(*legs)
        shift_f = float(shift)
        x, _ = solve_shifted(coeffs, b, topology, shift=shift_f, extra_diag=extra_diag, **opts)
        ctx.topology, ctx.opts, ctx.shift = topology, opts, shift_f
        ctx.shift_dtype = shift.dtype if isinstance(shift, torch.Tensor) else None
        ctx.save_for_backward(x, extra_diag, *legs)
        return x

    @staticmethod
    def backward(ctx, xbar):
        from ..models.solvers import solve_shifted

        x, extra_diag, *legs = ctx.saved_tensors
        coeffs = StencilCoeffs(*legs)
        grid = ctx.opts.get("grid")
        z, _ = solve_shifted(coeffs, xbar.contiguous(), ctx.topology, shift=ctx.shift,
                             extra_diag=extra_diag, transpose=True, **ctx.opts)
        zx = z * x

        def total(t):  # a sum over the whole field, all-reduced on a process grid
            s = t.sum()
            if grid is not None:
                from ..parallel.mesh import all_reduce_sum

                s = all_reduce_sum(s, grid)
            return s

        shift_bar = None
        if ctx.shift_dtype is not None and ctx.needs_input_grad[3]:
            shift_bar = (-total(zx)).to(ctx.shift_dtype)
        extra_bar = None
        if extra_diag is not None and ctx.needs_input_grad[4]:
            extra_bar = (-zx if extra_diag.ndim else -total(zx)).to(extra_diag.dtype)
        legs_bar = (None,) * len(legs)
        if any(ctx.needs_input_grad[5:]):
            legs_bar = _coeff_cotangents(z, x, ctx.topology, -1.0, legs[0].dtype, grid)
        return (None, None, z if ctx.needs_input_grad[2] else None, shift_bar, extra_bar,
                *legs_bar)


def differentiable_solve(topology: GridTopology, **opts):
    """A differentiable steady-state solver `solve(coeffs, b, shift,
    extra_diag) -> x` of (shift I + diag(extra_diag) + T) x = b, by the
    implicit-function adjoint: the backward is ONE transpose solve through
    `models.solvers.solve_shifted` with the same `opts` (`tol`, `maxiter`,
    `preconditioner`, `algorithm`, `grid`, ...), so on a process grid the
    forward and the adjoint both run the sharded engine, and the shift's
    and a scalar extra diagonal's gradients are all-reduced. `shift` is a
    float or a 0-d tensor; `extra_diag` None, a 0-d tensor or a field.
    Returns x only (a residual has no useful cotangent), as the JAX
    package's does."""

    def solve(coeffs: StencilCoeffs, b: torch.Tensor, shift=0.0, extra_diag=None):
        return _SolveAD.apply(topology, opts, b, shift, extra_diag, *coeffs)

    return solve
