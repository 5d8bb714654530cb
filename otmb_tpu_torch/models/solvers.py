"""Time stepping and matrix-free steady-state solves for the transport operator.

Counterpart of the main-path subset of `otmb_tpu.models.solvers`: explicit
Euler through the K1 kernel; one host-driven Krylov engine that runs
right-preconditioned BiCGStab(1), BiCGStab(2) or restarted GMRES(30)
with the Jacobi or the vertical-line Thomas preconditioner (K2), and
BiCGStab(2) on the fused Krylov-step kernel K3, each of its cycles ending
in the algebra kernels K11 and K12; the implicit Euler step;
mixed-precision iterative refinement; and the ideal age and sequestration
time workloads.

The engine keeps its scalars on the device and reads the residual back to
the host once per chunk of `chunk` matvec pairs (`CHUNK` by default, for
every solve; GMRES once per restart cycle). Between reads it decides
nothing; at each read it keeps the
best iterate, and stops on convergence, on a stall (three chunks without
a 2 % gain), on divergence or on a non-finite recurrence. The first chunk
is also read after 1, 2, 4, ... iterations, for convergence only, so a
solve that converges in a few iterations stops there rather than
iterating on past convergence, where an f32 recurrence can break down. The scalar shift
and the extra diagonal are folded into the stencil diagonal, so a matvec
is one K1 launch. Tracer fields are dense (nz, ny, nx) with zeros on
land, and every operator application keeps them so.

A batch of right-hand sides (B, nz, ny, nx) that share the operator runs
through the same engine (`solve_shifted_chunked_multi`): the same algebra
in lockstep, with per-member scalars as (B,) device tensors, the matvec
through K5 (one launch for all members) and M through one batched K2
launch. The host loop keeps its rules per member; a field is one member.
`water_mass_fractions` is built on it. On a process grid (`grid=`) a
field or a batch runs the same engine on the rank's shard
(`parallel.solve_halo`).

Where the JAX package picks its solver by grid size (a workaround for the
TPU runtime), this module routes by argument: `algorithm` picks the
Krylov method, and the same engine runs at every size.
"""

from __future__ import annotations

import math
import sys
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..grid.topology import GridTopology
from ..ops.apply import transpose_coeffs
from ..ops.coeffs import StencilCoeffs
from ..ops.krylov import fused_krylov_step, krylov_scratch
from ..ops.krylov_algebra import polish_sums, polish_update
from ..ops.stencil import euler_propagate, euler_step, stencil_apply, stencil_apply_multi
from ..ops.tridiag import tridiag_factor, tridiag_solve_factored
from ..utils import debugging

#: Matvec pairs (BiCGStab(1) iterations, half BiCGStab(2) cycles) between
#: host reads of the residual: the one cadence of every Krylov solve.
CHUNK = 50

ALGORITHMS = ("bicgstab", "bicgstab2", "gmres")
#: The batched engine's algorithms: the JAX package has no batched GMRES.
MULTI_ALGORITHMS = ("bicgstab", "bicgstab2")
#: Arnoldi steps per GMRES cycle (the JAX package's `restart=30`).
GMRES_RESTART = 30


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


def _guarded(shifted_diag: torch.Tensor) -> torch.Tensor:
    """The Thomas diagonal: the shifted diagonal with land's 0 -> 1."""
    return torch.where(shifted_diag != 0, shifted_diag, 1.0)


def _thomas(coeffs: StencilCoeffs, shifted_diag: torch.Tensor):
    """The Thomas legs (lower, guarded diagonal, upper) of M = diag(shifted)
    + T_top + T_bottom, in the shifted diagonal's dtype (bf16 legs widen
    exactly to f32), and their factor (cp, rden): one K2 factor launch."""
    diag = _guarded(shifted_diag)
    # lower = bottom couples to k+1, upper = top to k-1
    legs = (coeffs.bottom.to(diag.dtype), diag, coeffs.top.to(diag.dtype))
    return legs, tridiag_factor(*legs)


def _tridiag_preconditioner(coeffs: StencilCoeffs, shifted_diag: torch.Tensor):
    """Vertical-line preconditioner: a per-column Thomas solve (K2) of
    M = diag(shifted) + T_top + T_bottom, the stiff vertical-diffusion part
    of T, factored once here and solved per right-hand side. Land columns
    get a unit diagonal."""
    legs, (cp, rden) = _thomas(coeffs, shifted_diag)
    return lambda b: tridiag_solve_factored(cp, rden, legs[2], b)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b>: a 0-d tensor for fields (nz, ny, nx); for batches (B, nz, ny,
    nx) the (B,) members' dots, one `torch.dot` each, so each equals the
    unbatched dot. On an H100 this beats the one-launch forms: `bmm` is
    ~60x slower and `linalg.vecdot` materialises a B-field product and
    takes twice as long. A stack (j, nz, ny, nx) against one field b gives
    the (j,) projections <a[i], b> in one matrix-vector product (GMRES's
    Arnoldi step)."""
    if a.ndim == 4 and b.ndim == 3:
        return torch.mv(a.reshape(a.shape[0], -1), b.reshape(-1))
    if a.ndim == 4:
        return torch.stack([torch.dot(u.reshape(-1), v.reshape(-1)) for u, v in zip(a, b)])
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, 1.0, x)


def _axpy(y: torch.Tensor, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y + a x for a 0-d tensor a, or for batches a (B,) tensor a of one
    scalar per member, in one pass over the fields."""
    if a.ndim == 1:
        a = a.view(-1, 1, 1, 1)
    return torch.addcmul(y, a, x)


class _Field(NamedTuple):
    """What the solvers do on a field: apply a stencil (`apply(c, x)` = T x
    through the kernel, coefficients possibly narrower than x), reduce (the
    dot, the 2-norm, and `reduce`, which turns sums over the field's own
    cells, such as K11's and K12's, into the whole field's), and where it
    starts (`offset`, the global (j0, i0) of its first cell). On one device
    the field is whole; on a process grid it is the rank's shard
    (`parallel.solve_halo.halo_field`), and every reduction is all-reduced,
    so the ranks take the same decisions."""

    apply: Callable[[StencilCoeffs, torch.Tensor], torch.Tensor]
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    norm: Callable[[torch.Tensor], float]
    reduce: Callable[[torch.Tensor], torch.Tensor]
    offset: tuple[int, int] = (0, 0)


def _whole_field(topology: GridTopology) -> _Field:
    """The whole field on one device: K1 on a field, K5 on a batch (B, nz,
    ny, nx); plain dots and norms."""

    def apply(c: StencilCoeffs, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            return stencil_apply_multi(c, x, topology)
        return stencil_apply(c, x, topology)

    return _Field(apply, _dot, lambda v: float(torch.linalg.vector_norm(v)), lambda s: s)


class _System(NamedTuple):
    """One shifted system (shift * I + D_extra + A) x = b in the engine's
    form: `a` is A with shift + extra folded into its diagonal, `M` the
    preconditioner, `m_legs` the Thomas legs (lower, guarded diagonal,
    upper) and `factor` their (cp, rden) when M is the tridiagonal one,
    `field` the whole field or a shard. With bf16 coefficients and f32
    vectors (`solve_shifted_ir`'s bf16-narrow mode) `a` keeps the bf16
    coefficients and `outside` holds (shift, extra), applied beside the
    kernel as the JAX package's matvec applies them."""

    a: StencilCoeffs
    topology: GridTopology
    M: Callable[[torch.Tensor], torch.Tensor]
    m_legs: tuple | None
    field: _Field
    factor: tuple | None = None
    outside: tuple | None = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """(shift * I + D_extra + A) x."""
        if self.outside is None:
            return self.field.apply(self.a, x)
        shift, extra = self.outside
        return shift * x + extra * x + self.field.apply(self.a, x)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.field.dot(a, b)


def _field_for(coeffs: StencilCoeffs, topology: GridTopology, transpose: bool, grid=None,
               overlap: bool = True) -> tuple[_Field, StencilCoeffs]:
    """The field operations, and A's coefficients with T' formed once when
    `transpose`: the whole field on one device, or this rank's shard on a
    process grid (`parallel.solve_halo`)."""
    if grid is None:
        return _whole_field(topology), (transpose_coeffs(coeffs, topology) if transpose
                                        else coeffs)
    from ..parallel.solve_halo import halo_field, transpose_coeffs_halo

    return halo_field(topology, grid, overlap), (
        transpose_coeffs_halo(coeffs, topology, grid) if transpose else coeffs)


def _system(coeffs: StencilCoeffs, dtype: torch.dtype, topology: GridTopology, shift=0.0,
            extra_diag: torch.Tensor | None = None, transpose: bool = False,
            preconditioner: str = "tridiag", grid=None, overlap: bool = True) -> _System:
    """The engine's system in `dtype`, on the whole field or (`grid`) on
    this rank's shard. For T' the stencil form of T' is built once; its
    vertical legs are the transposed operator's, so the Thomas M is built
    from them too, and factored once. On a shard the Thomas solve needs no
    neighbours, since k is never sharded. bf16 coefficients with f32
    vectors stay bf16 in A (K1's (bf16, f32) kernel) and are widened to f32
    in M."""
    field, coeffs = _field_for(coeffs, topology, transpose, grid, overlap)
    narrow = _narrow(coeffs, dtype)
    if not narrow:
        coeffs = coeffs.to(dtype)
    extra = 0.0 if extra_diag is None else extra_diag.to(dtype)
    shifted = shift + extra + coeffs.diag.to(dtype)
    a = coeffs if narrow else coeffs._replace(diag=shifted)
    outside = (shift, extra) if narrow else None
    if preconditioner == "tridiag":
        m_legs, (cp, rden) = _thomas(coeffs, shifted)
        return _System(a, topology, lambda v: tridiag_solve_factored(cp, rden, m_legs[2], v),
                       m_legs, field, (cp, rden), outside)
    if preconditioner == "jacobi":
        return _System(a, topology, _jacobi_preconditioner(shifted), None, field, None, outside)
    raise ValueError(f"unknown preconditioner {preconditioner!r}")


def _narrow(coeffs: StencilCoeffs, dtype: torch.dtype) -> bool:
    """bf16 coefficients under f32 vectors: the bf16-narrow mode."""
    return coeffs.diag.dtype == torch.bfloat16 and dtype == torch.float32


class _State1(NamedTuple):
    """BiCGStab(1) state, in x-space."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rhat: torch.Tensor
    rho: torch.Tensor


class _State2(NamedTuple):
    """BiCGStab(2) state, in the right-preconditioned y-space (x = M y);
    `x` is y."""

    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor
    rhat: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor


def _jitter_rhat(r: torch.Tensor, jitter: int, offset: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """A perturbed shadow vector for divergence restarts
    (`otmb_tpu/models/solvers.py:_jitter_rhat`): a +-10 % * jitter
    modulation alternating along k, j or i (cycling with the restart's
    ordinal), which keeps land's zeros and the overlap with r but changes
    every <rhat, .> projection, so a restart does not replay the blow-up.
    The sign alternates with the global index: `offset` is the (j0, i0) of
    a shard's first cell (k is never sharded), so a shard's shadow vector is
    the slice of the whole field's."""
    if jitter == 0:
        return r
    which = (jitter - 1) % 3
    axis = (r.ndim - 3) + which
    n = r.shape[axis]
    start = (0, *offset)[which]
    sign = (((start + torch.arange(n, device=r.device)) % 2) * 2 - 1).to(r.dtype)
    sign = sign.reshape([n if d == axis else 1 for d in range(r.ndim)])
    return r * (1.0 + torch.tensor(0.1 * jitter, dtype=r.dtype) * sign)


def _scalars(b: torch.Tensor, value: float) -> torch.Tensor:
    """The engine's scalar `value`: 0-d for a field, (B,) for a batch."""
    return torch.full(b.shape[:-3], value, dtype=b.dtype, device=b.device)


def _initial_state(sys_: _System, algorithm: str, b: torch.Tensor):
    """The state at x = 0: r = rhat = b."""
    zero = torch.zeros_like(b)
    if algorithm == "bicgstab":
        return _State1(zero, b, b, b, sys_.dot(b, b))
    one = _scalars(b, 1.0)
    return _State2(zero, b, zero, b, one, torch.zeros_like(one), one)


def _restart_state(sys_: _System, algorithm: str, step, x: torch.Tensor, b: torch.Tensor,
                   jitter: int):
    """A fresh Krylov space at the iterate `x`: the true residual
    r = b - A x (b - A M y for BiCGStab(2), through the engine's `step`),
    rhat = r jittered by `jitter`, and rho = <rhat, r> (the JAX package
    seeds BiCGStab(1)'s rho with <r, r>, inconsistent with a jittered
    rhat)."""
    if algorithm == "bicgstab":
        r = b - sys_.apply(x)
        rhat = _jitter_rhat(r, jitter, sys_.field.offset)
        return _State1(x, r, r, rhat, sys_.dot(rhat, r))
    r = b - step(x, None, None, None)[1]
    one = _scalars(b, 1.0)
    return _State2(x, r, torch.zeros_like(r), _jitter_rhat(r, jitter, sys_.field.offset), one,
                   torch.zeros_like(one), one)


def _bicgstab_steps(sys_: _System, st: _State1, nsteps: int) -> _State1:
    """`nsteps` iterations of right-preconditioned BiCGStab, with the
    breakdown guards of the JAX package's `_sr_chunk1`."""
    x, r, p, rhat, rho = st
    A, M, dot = sys_.apply, sys_.M, sys_.dot
    for _ in range(nsteps):
        phat = M(p)
        v = A(phat)
        alpha = rho / _nonzero(dot(rhat, v))
        s = _axpy(r, -alpha, v)
        shat = M(s)
        t = A(shat)
        omega = dot(t, s) / _nonzero(dot(t, t))
        x = _axpy(_axpy(x, alpha, phat), omega, shat)
        r = _axpy(s, -omega, t)
        rho_new = dot(rhat, r)
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = _axpy(r, beta, _axpy(p, -omega, v))
        rho = rho_new
    return _State1(x, r, p, rhat, rho)


def _unfused_step(sys_: _System):
    """The Krylov half-step as separate passes: the combination x1 + c x2,
    M (K2), A (K1) and the dot <rhat, out>, each its own launch."""

    def step(x1, x2, c, rhat):
        z = x1 if x2 is None else _axpy(x1, c, x2)
        out = sys_.apply(sys_.M(z))
        return z, out, (None if rhat is None else sys_.dot(rhat, out))

    return step


def _fused_step(sys_: _System, scratch):
    """The Krylov half-step as one K3 launch (`ops/krylov.py`)."""

    def step(x1, x2, c, rhat):
        return fused_krylov_step(sys_.a, *sys_.m_legs, x1, x2, c, rhat, sys_.topology,
                                 with_combine=x2 is not None, with_dot=rhat is not None,
                                 scratch=scratch)

    return step


def _bicgstab2_cycles(sys_: _System, step, st: _State2, ncycles: int) -> _State2:
    """`ncycles` of BiCGStab(l=2) (Sleijpen & Fokkema 1993) on K = A o M,
    in y-space. `step(x1, x2, c, rhat)` returns (z = x1 + c x2, K z,
    <rhat, K z>); the algebra is that of the JAX package's
    `_sr_chunk2_fused`, and with the unfused step that of
    `_bicgstab2_cycles`. Each cycle ends in two kernels: K11 (r0 -= alpha
    u1 and the five polish sums) and K12 (the updates of y, r0 and u0,
    with the deferred y += alpha u0, and <rhat, r0> for the next cycle's
    top; the first cycle of a call forms that dot on its own). The dots
    and sums are `sys_`'s (all-reduced on a shard)."""
    dot, reduce = sys_.dot, sys_.field.reduce
    y, r0, u0, rhat, rho0, alpha, omega = st
    one = torch.ones_like(rho0)
    guard = lambda d: torch.where(d == 0, one, d)
    rho_next = None
    for cycle in range(ncycles):
        rho0 = -omega * rho0
        # BiCG step j = 0
        rho1 = dot(rhat, r0) if rho_next is None else rho_next
        beta = alpha * rho1 / guard(rho0)
        rho0 = rho1
        u0, u1, d1 = step(r0, u0, -beta, rhat)
        alpha = rho0 / guard(d1)
        r0, r1, d2 = step(r0, u1, -alpha, rhat)
        y = _axpy(y, alpha, u0)
        # BiCG step j = 1
        rho1 = d2
        beta = alpha * rho1 / guard(rho0)
        rho0 = rho1
        u0 = _axpy(r0, -beta, u0)
        u1, u2, d3 = step(r1, u1, -beta, rhat)
        alpha = rho0 / guard(d3)
        r1, r2, _ = step(r1, u2, -alpha, None)
        # 2D minimal-residual polish: min ||r0 - w1 r1 - w2 r2||, with
        # r0 -= alpha u1 and y += alpha u0 folded into K11 and K12
        r0, sums = polish_sums(r0, u1, r1, r2, alpha)
        t11, t12, t22, s1, s2 = reduce(sums).unbind(-1)
        det = guard(t11 * t22 - t12 * t12)
        w1 = (t22 * s1 - t12 * s2) / det
        w2 = (t11 * s2 - t12 * s1) / det
        y, r0, u0, rho_next = polish_update(y, u0, r0, r1, r2, u1, u2, alpha, w1, w2,
                                            rhat if cycle + 1 < ncycles else None)
        if rho_next is not None:
            rho_next = reduce(rho_next)
        omega = w2
    return _State2(y, r0, u0, rhat, rho0, alpha, omega)


def _doubling(n: int) -> list[int]:
    """1, 2, 4, ... summing to n (the last part what is left)."""
    parts, size = [], 1
    while n > 0:
        parts.append(min(size, n))
        n -= parts[-1]
        size *= 2
    return parts


def _restart_members(sys_: _System, algorithm: str, step, state, x: torch.Tensor,
                     b: torch.Tensor, mask: list[bool], jitter: int):
    """`_restart_state` for the members of a batch in `mask` (a fresh Krylov
    space at their iterates in `x`, rho = <rhat, r> per member); the other
    members' state passes through untouched. A state restarted whole (a
    field, or every member) is `_restart_state`'s. The JAX package's
    `_mr_restart_members` seeds BiCGStab(1)'s rho with <r, r>."""
    fresh = _restart_state(sys_, algorithm, step, x, b, jitter)
    if all(mask):
        return fresh
    keep = torch.tensor(mask, device=b.device)
    return type(state)(*(torch.where(keep.view((-1,) + (1,) * (old.ndim - 1)), new, old)
                         for old, new in zip(state, fresh)))


def _arnoldi(sys_: _System, v0: torch.Tensor, m: int):
    """`m` Arnoldi steps on K = A o M from the unit vector `v0`, by classical
    Gram-Schmidt with one re-orthogonalisation (the JAX package's
    "batched" GMRES). Returns the basis V (m + 1, nz, ny, nx) and the
    Hessenberg matrix H (m + 1, m), both on the device: the loop reads
    nothing. Each projection is one matrix-vector product over the basis
    through `sys_.dot` (on a shard, one all-reduce of the (j,) partial
    dots). A zero norm (the Krylov space holds the solution) gives a zero
    basis vector, and zero columns from there on."""
    V = torch.empty((m + 1, *v0.shape), dtype=v0.dtype, device=v0.device)
    H = torch.zeros((m + 1, m), dtype=v0.dtype, device=v0.device)
    V[0] = v0
    for j in range(m):
        basis = V[:j + 1]
        flat = basis.reshape(j + 1, -1)
        w = sys_.apply(sys_.M(V[j]))
        h = sys_.dot(basis, w)
        w = w - (h @ flat).view_as(w)
        h2 = sys_.dot(basis, w)
        w = w - (h2 @ flat).view_as(w)
        hn = torch.sqrt(sys_.dot(w, w))
        H[:j + 1, j] = h + h2
        H[j + 1, j] = hn
        V[j + 1] = w / torch.where(hn == 0, 1.0, hn)
    return V, H


def _read(values, what: str) -> list[float]:
    """Values the engine reads to the host, as floats; with NaN debugging
    on (`utils.debugging.enable_nan_debugging`), a non-finite one raises
    FloatingPointError."""
    out = values.reshape(-1).tolist() if isinstance(values, torch.Tensor) else list(values)
    if debugging.NAN_DEBUG and not all(math.isfinite(v) for v in out):
        raise FloatingPointError(f"non-finite {what} read by the Krylov engine: {out}")
    return out


def _gmres(sys_: _System, b: torch.Tensor, tol: float, maxiter: int, early_stop: bool,
           stats: dict | None, verbose: bool):
    """Restarted GMRES(`GMRES_RESTART`) on a field, right-preconditioned:
    each cycle builds the Arnoldi basis V of K = A o M from the residual r
    of x, solves min ||beta e1 - H y|| on the host in f64 (beta = ||r||),
    and sets x <- x + M (V y). So the residual it minimises is the true
    b - A x, and the engine's contract holds: it stops once ||b - A x|| <=
    tol ||b||. The JAX package's GMRES is left-preconditioned and stops on
    ||M (b - A x)|| <= tol ||M b|| (jax/_src/scipy/sparse/linalg.py, the
    "batched" method): the two stop at different iterates, and their
    iteration counts differ.

    One read per cycle brings back H and ||r||^2 of the cycle's starting
    iterate. When the least-squares residual says a cycle converged, the
    true residual of the new x is read before the next cycle, which runs
    only if it did not. `maxiter` bounds the Arnoldi steps (one matvec
    each); a cycle is cut short to stay inside it. With `early_stop`, three
    cycles without 2 % of gain in the true residual stop the solve with a
    warning. A non-finite H stops it ("diverged") with the best iterate.
    Restarts and jitter do not apply: every cycle restarts from x."""
    bnorm2 = _read(sys_.dot(b, b), "||b||^2")[0]
    atol2 = tol ** 2 * bnorm2
    x, r = torch.zeros_like(b), b
    rn2 = bnorm2  # ||b - A x||^2 of the current x, when read
    best_x, best_rn2 = x, bnorm2
    window_rn2 = math.inf
    iters = cycles = 0
    stop = "maxiter"
    chunk_s = []
    say = (lambda msg: print(f"#   gmres step {iters}: {msg}", file=sys.stderr)
           ) if verbose else (lambda msg: None)
    while True:
        if rn2 is not None:
            if rn2 < best_rn2:
                best_x, best_rn2 = x, rn2
            if rn2 <= atol2:
                stop = "converged"
                break
        if iters >= maxiter or stop != "maxiter":
            break
        t_cycle = time.perf_counter()
        m = min(GMRES_RESTART, maxiter - iters)
        beta2 = sys_.dot(r, r)
        V, H = _arnoldi(sys_, r / torch.sqrt(torch.where(beta2 == 0, 1.0, beta2)), m)
        host = _read(torch.cat([beta2.reshape(1), H.reshape(-1)]).double(), "GMRES cycle")
        iters += m
        cycles += 1
        start_rn2, Hh = host[0], np.array(host[1:]).reshape(m + 1, m)
        if start_rn2 < best_rn2:  # the true residual of the cycle's starting x
            best_x, best_rn2 = x, start_rn2
        if not np.isfinite(Hh).all() or not math.isfinite(start_rn2):
            stop = "diverged"
            break
        e1 = np.zeros(m + 1)
        e1[0] = math.sqrt(start_rn2)
        y = np.linalg.lstsq(Hh, e1, rcond=None)[0]
        est2 = float(np.sum((e1 - Hh @ y) ** 2))
        y_dev = torch.as_tensor(y, dtype=b.dtype, device=b.device)
        x = x + sys_.M((y_dev @ V[:m].reshape(m, -1)).view_as(b))
        del V
        r = b - sys_.apply(x)
        rn2 = None
        say(f"cycle {cycles}: rel residual at its start {math.sqrt(start_rn2 / bnorm2):.3e}, "
            f"least-squares estimate after {math.sqrt(est2 / bnorm2):.3e}")
        if early_stop and cycles % 3 == 0:
            if not start_rn2 < 0.98 ** 2 * window_rn2:
                warnings.warn(
                    f"solve_shifted_chunked: GMRES relative residual "
                    f"{math.sqrt(start_rn2 / bnorm2):.3e} after {iters} Arnoldi steps improved "
                    f"<2% over the last 3 cycles — likely the rounding floor of {b.dtype}; "
                    f"wrap in solve_shifted_ir for tighter residuals, or pass early_stop=False "
                    f"to keep iterating.", stacklevel=4)
                stop = "stall"
            window_rn2 = start_rn2
        if est2 <= atol2 or iters >= maxiter or stop != "maxiter":
            rn2 = _read(sys_.dot(r, r), "residual")[0]  # confirm with the true residual
        chunk_s.append(round(time.perf_counter() - t_cycle, 4))
    return _finish(sys_, b, best_x, [best_rn2], [bnorm2], stats,
                   dict(iters=iters, restarts=0, stop=stop, diverge_restarts=0, cycles=cycles,
                        chunk_s=chunk_s))


def _finish(sys_: _System, b: torch.Tensor, x: torch.Tensor, best_rn2: list, bnorm2: list,
            stats: dict | None, fields: dict):
    """The engine's end: `stats` gets `fields`, start_rel and end_rel (the
    best recurrence residual per member, the worst of them); returns (x,
    the relative residuals ||A x - b|| / ||b|| recomputed from x, one float
    per member). The norms are the square roots of the field's dot, so a
    batch of one gives a field's residual bit for bit, and on a process
    grid they are the whole field's: one all-reduce of the (B,) sums."""
    if stats is not None:
        stats.update(fields, start_rel=1.0,
                     end_rel=max(math.sqrt(v) / (math.sqrt(w) if w > 0 else 1.0)
                                 for v, w in zip(best_rn2, bnorm2)))
    r = sys_.apply(x) - b
    rnorm = [math.sqrt(v) for v in sys_.dot(r, r).reshape(-1).tolist()]
    return x, [v / (math.sqrt(w) if w > 0 else 1.0) for v, w in zip(rnorm, bnorm2)]


def _engine(sys_: _System, b: torch.Tensor, tol: float, maxiter: int, chunk: int,
            algorithm: str, fused: bool, early_stop: bool, max_restarts: int,
            max_diverge_restarts: int, stats: dict | None, verbose: bool = False):
    """The one Krylov loop, for a field b (nz, ny, nx) or in lockstep for a
    batch (B, nz, ny, nx) (`solve_shifted_chunked` and
    `solve_shifted_chunked_multi` document its rules). A field is one
    member whose state stays a field with 0-d scalars; GMRES takes fields
    only (`_gmres`). Returns (x, relative residuals ||A x - b|| / ||b||
    recomputed from x, a list of one float per member)."""
    if algorithm == "gmres":
        return _gmres(sys_, b, tol, maxiter, early_stop, stats, verbose)
    step = (_fused_step(sys_, krylov_scratch(*sys_.m_legs, factor=sys_.factor)) if fused
            else _unfused_step(sys_))
    batch = b.ndim == 4
    bnorm2 = _read(sys_.dot(b, b), "||b||^2")
    members = range(len(bnorm2))
    atol2 = [tol ** 2 * v for v in bnorm2]
    state = _initial_state(sys_, algorithm, b)
    best_x, best_rn2 = state.x, list(bnorm2)  # the residual at x0 = 0 is b
    rn2 = list(bnorm2)
    pass_rn2 = list(bnorm2)  # per member, at the start of its current Krylov pass
    window_rn2 = [math.inf] * len(members)
    div_streak = [0] * len(members)
    # A member is finished once it met tol at a read ("converged") or went
    # non-finite with no jittered restart left ("diverged"). It stays
    # finished and keeps its best iterate while a batch runs on in
    # lockstep: a later breakdown of its recurrence is ignored.
    finished: list[str | None] = [None] * len(members)
    iters = chunks_done = restarts = div_restarts = 0
    diverge_exit_alive = True
    stop = "maxiter"
    chunk_s = []
    say = (lambda msg: print(f"#   chunked iter {iters}: {msg}", file=sys.stderr)
           ) if verbose else (lambda msg: None)

    def restart(mask: list[bool], jitter: int = 0):
        nonlocal state, restarts
        # A field's jittered restarts count against `max_restarts`, a
        # batch's do not: the JAX package's two engines differ so.
        restarts += 1 if not (batch and jitter) else 0
        state = _restart_members(sys_, algorithm, step, state, best_x, b, mask, jitter)
        for m in members:
            if mask[m]:
                div_streak[m] = 0
                window_rn2[m] = math.inf
                pass_rn2[m] = best_rn2[m]

    def read():
        nonlocal rn2, best_x
        rn2 = _read(sys_.dot(state.r, state.r), "recurrence residual")
        better = [v < w for v, w in zip(rn2, best_rn2)]  # False for NaN
        # No copies: the loop never writes a tensor in place.
        if all(better):
            best_x = state.x
        elif any(better):
            best_x = torch.where(torch.tensor(better, device=b.device).view(-1, 1, 1, 1),
                                 state.x, best_x)
        for m in members:
            if better[m]:
                best_rn2[m] = rn2[m]
            if finished[m] is None and rn2[m] <= atol2[m]:
                finished[m] = "converged"

    first_chunk = True
    while iters < maxiter:
        t_chunk = time.perf_counter()
        nsteps = min(chunk, maxiter - iters)
        # BiCGStab(1) iterations, or BiCGStab(2) cycles of two matvec pairs
        units = nsteps if algorithm == "bicgstab" else max(1, nsteps // 2)
        # The first chunk is read after 1, 2, 4, ... units as well, for the
        # convergence test and the best iterate only.
        parts = _doubling(units) if first_chunk else [units]
        first_chunk = False
        for n in parts:
            if algorithm == "bicgstab":
                state = _bicgstab_steps(sys_, state, n)
                iters += n
            else:
                state = _bicgstab2_cycles(sys_, step, state, n)
                iters += 2 * n
            read()
            say("rel recurrence residual "
                + " ".join(f"{math.sqrt(v / w) if w else 0.0:.3e}" for v, w in zip(rn2, bnorm2)))
            if all(finished) or any(f is None and not math.isfinite(v)
                                    for f, v in zip(finished, rn2)):
                break
        chunk_s.append(round(time.perf_counter() - t_chunk, 4))
        if all(finished):
            stop = "converged" if all(f == "converged" for f in finished) else "diverged"
            break
        active = [f is None for f in finished]
        finite = [math.isfinite(v) for v in rn2]
        # Divergence, per active member: the recurrence residual above 16x
        # (4x in norm) its pass-start value at two consecutive reads, or
        # non-finite at one. The jittered restarts share one budget.
        for m in members:
            over = active[m] and not rn2[m] <= 16.0 * pass_rn2[m]
            div_streak[m] = (div_streak[m] + 1 if finite[m] else 2) if over else 0
        fire = [div_streak[m] >= 2 and (diverge_exit_alive or not finite[m]) for m in members]
        if any(fire):
            for m in members:
                if fire[m]:
                    div_streak[m] = 0
            if div_restarts < max_diverge_restarts:
                div_restarts += 1
                say(f"members {[m for m in members if fire[m]]} diverged; jittered restart "
                    f"{div_restarts} from their best iterates")
                restart(fire, jitter=div_restarts)
                continue
            no_progress = False
            for m in members:
                if fire[m] and not finite[m]:
                    finished[m] = "diverged"  # a non-finite recurrence never recovers
                elif fire[m] and not best_rn2[m] < pass_rn2[m]:
                    no_progress = True
            if no_progress:
                # A finite member with no progress to protect: let the
                # recurrences run, as blow-up-then-recover trajectories
                # still reach useful contractions (the stall window and
                # maxiter bound the waste); non-finite members still end.
                diverge_exit_alive = False
            elif all(fire[m] or finished[m] for m in members):
                stop = "diverged"
                break
            # Otherwise the members still converging go on; the diverged
            # ones are protected by their best iterates.
        # Stall, per active member: a whole 3-chunk window without 2 % of
        # gain in the norm.
        chunks_done += 1
        if early_stop and chunks_done % 3 == 0:
            stalled = [finished[m] is None and not rn2[m] < 0.98 ** 2 * window_rn2[m]
                       for m in members]
            if any(stalled):
                if restarts < max_restarts:
                    say(f"members {[m for m in members if stalled[m]]} stalled; restart "
                        f"{restarts + 1} from their best iterates")
                    restart(stalled)
                    continue
                if all(stalled[m] or finished[m] for m in members):
                    worst = max(math.sqrt(rn2[m] / bnorm2[m]) if bnorm2[m] else 0.0
                                for m in members if stalled[m])
                    warnings.warn(
                        f"solve_shifted_chunked{'_multi' if batch else ''}: "
                        f"{'worst ' if batch else ''}relative residual {worst:.3e} after {iters} "
                        f"iterations improved <2% over the last {3 * chunk} iterations (after "
                        f"{restarts} restart(s)) — likely the rounding floor of {b.dtype}; "
                        + ("" if batch else "wrap in solve_shifted_ir for tighter residuals, ")
                        + "or pass early_stop=False to keep iterating.",
                        stacklevel=3,
                    )
                    stop = "stall"
                    break
            window_rn2 = list(rn2)

    del state
    x = sys_.M(best_x) if algorithm == "bicgstab2" else best_x  # y-space for BiCGStab(2)
    return _finish(sys_, b, x, best_rn2, bnorm2, stats,
                   dict(iters=iters, restarts=restarts, stop=stop,
                        diverge_restarts=div_restarts, chunk_s=chunk_s))


def solve_shifted_chunked(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                          shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                          tol: float = 1e-10, maxiter: int = 2000, chunk: int = CHUNK,
                          transpose: bool = False, preconditioner: str = "tridiag",
                          verbose: bool = False, early_stop: bool = True,
                          max_restarts: int = 2, algorithm: str = "bicgstab",
                          stats: dict | None = None, fused: bool | None = None,
                          max_diverge_restarts: int = 2, grid=None, overlap: bool = True):
    """Solve (shift * I + D_extra + T) x = b (T' when `transpose`) with the
    host-driven Krylov engine. Returns (x, relative residual ||Ax - b|| /
    ||b||, recomputed from x in b's dtype); for a batch b (B, nz, ny, nx),
    `solve_shifted_chunked_multi`'s lockstep solve, the (B,) residuals as
    a float64 host tensor.

    - `algorithm`: "bicgstab" (right-preconditioned BiCGStab(1)),
      "bicgstab2" (BiCGStab(l=2), Sleijpen & Fokkema 1993: two BiCG steps
      and a 2D minimal-residual polish per cycle, which handles the
      complex-conjugate eigenvalue pairs of advective operators that stall
      BiCGStab(1); it runs in y-space, K = A o M, x = M y), or "gmres"
      (right-preconditioned restarted GMRES(30), `_gmres`: the residual is
      read once per cycle, and `maxiter` counts Arnoldi steps, one matvec
      each; `chunk`, the restarts and the divergence rule do not apply;
      the stall rule is three cycles without 2 % of gain). `maxiter` and
      `chunk` count matvec pairs under BiCGStab(1) and (2).
    - `chunk`: matvec pairs between host reads of the residual; the first
      chunk is also read after 1, 2, 4, ... iterations (cycles for
      BiCGStab(2)), for the convergence test and the best iterate only.
    - The iterate with the best recurrence residual at a read is kept and
      returned.
    - `early_stop`: stop (after `max_restarts` restarts from the best
      iterate with a fresh Krylov space, jittered restarts counted among
      them) when a 3-chunk window improves the residual norm by less than
      2 %, with a warning.
    - Divergence: a recurrence residual above 4x its pass-start norm at two
      consecutive reads restarts from the best iterate with a jittered
      shadow vector, at most `max_diverge_restarts` times (a budget apart
      from `max_restarts`); then the solve stops with the best iterate if
      it made progress. A non-finite recurrence always stops it once that
      budget is spent.
    - `fused` (default: on for "bicgstab2" with the "tridiag"
      preconditioner) runs each BiCGStab(2) half-step as one K3 launch;
      False runs the separate K2, K1 and vector passes.
    - `stats`, if a dict, receives ``iters``, ``restarts`` (the jittered
      ones included), ``stop`` ("converged" / "stall" / "diverged" /
      "maxiter"), ``diverge_restarts``, ``start_rel``, ``end_rel``
      (recurrence residuals) and ``chunk_s`` (wall seconds per chunk, host
      read included).
    - `grid` (a `parallel.mesh.ProcessGrid`; the JAX package's `mesh=`)
      runs the solve on a process grid: `coeffs`, `b` (one field, or a
      batch (B, nz, ny_l, nx_l)) and `extra_diag` are the rank's shards,
      `topology` the global one, and every rank calls it. The matvec is
      the halo exchange plus K7 (K7 multi for a batch: one exchange of the
      batch's lines and one launch; `overlap` as in
      `parallel.halo_kernel.stencil_apply_halo`), the dots are all-reduced
      (one all-reduce of the (B,) sums for a batch), and the solve runs
      unfused (K3 has no halo mode). Returns the rank's shard of x and the
      whole field's residual."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if algorithm == "gmres" and b.ndim != 3:
        raise ValueError("gmres takes one field (nz, ny, nx); the batched solves have no GMRES")
    narrow = _narrow(coeffs, b.dtype)
    if fused is None:
        fused = (algorithm == "bicgstab2" and preconditioner == "tridiag" and grid is None
                 and not narrow)
    if fused and preconditioner != "tridiag":
        raise ValueError("fused=True needs the tridiag preconditioner (K3 is its Thomas solve)")
    if fused and narrow:
        raise ValueError("fused=True needs coefficients of b's dtype (K3 has no bf16 entry)")
    if grid is not None and fused:
        raise ValueError("on a process grid the solve runs unfused (K3 has no halo mode)")
    sys_ = _system(coeffs, b.dtype, topology, shift, extra_diag, transpose, preconditioner,
                   grid, overlap)
    x, res = _engine(sys_, b, tol, maxiter, chunk, algorithm, fused and algorithm == "bicgstab2",
                     early_stop, max_restarts, max_diverge_restarts, stats, verbose)
    return x, (res[0] if b.ndim == 3 else torch.tensor(res, dtype=torch.float64))


def solve_shifted(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                  shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                  tol: float = 1e-10, maxiter: int = 2000, transpose: bool = False,
                  preconditioner: str = "tridiag", stats: dict | None = None, grid=None,
                  algorithm: str = "bicgstab"):
    """Solve (shift * I + D_extra + T) x = b matrix-free with BiCGStab
    (T' instead of T when `transpose`). Returns (x, relative residual
    ||Ax - b|| / ||b||, recomputed from x in b's dtype). `grid` as in
    `solve_shifted_chunked`. `algorithm` (the JAX package's `method`):
    "bicgstab", "bicgstab2" or "gmres" (GMRES(30), `maxiter` Arnoldi
    steps; `solve_shifted_chunked` documents each).

    The operator runs in b's dtype. The solve runs until ||r|| <= tol *
    ||b|| (read every `CHUNK` iterations), maxiter, or a recurrence that
    stops being finite or diverges; it is the engine of
    `solve_shifted_chunked` without stall stops or restarts. A solve that
    stops at maxiter is not an error; the residual says so.
    `stats`, if a dict, receives the engine's stats (``iters`` first)."""
    return solve_shifted_chunked(coeffs, b, topology, shift=shift, extra_diag=extra_diag,
                                 tol=tol, maxiter=maxiter, transpose=transpose,
                                 preconditioner=preconditioner, early_stop=False,
                                 max_restarts=0, algorithm=algorithm, stats=stats,
                                 max_diverge_restarts=0, grid=grid)


def implicit_euler_step(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float,
                        topology: GridTopology, tol: float = 1e-10,
                        algorithm: str = "bicgstab"):
    """One implicit Euler step of d(chi)/dt = -T chi: solve
    (I/dt + T) chi_next = chi/dt, unconditionally stable (the JAX package's
    `implicit_euler_step`, whose `method` is `algorithm` here). Returns
    (chi_next, relative residual), through `solve_shifted` (K1 matvecs and
    K2 preconditioning on the card)."""
    return solve_shifted(coeffs, chi / dt, topology, shift=1.0 / dt, tol=tol,
                         algorithm=algorithm)


def _ir_defect(field: _Field, c_narrow: StencilCoeffs, x: torch.Tensor,
               b_narrow: torch.Tensor, extra_narrow: torch.Tensor, shift: float,
               bnorm_safe: float):
    """One wide defect r = b - A x from the NARROW coefficients (widened
    inside the K1 or K7 kernel, exactly), and its normalised form: returns
    (r / s, s, s / ||b||) with s = ||r|| (1 where r == 0)."""
    wide = x.dtype
    r = b_narrow.to(wide) - (shift * x + extra_narrow.to(wide) * x + field.apply(c_narrow, x))
    s = field.norm(r)
    s_safe = s if s != 0 else 1.0
    return r / s_safe, s_safe, s / bnorm_safe


def solve_shifted_ir(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                     shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                     tol: float = 1e-9, inner_tol: float = 1e-4,
                     max_refinements: int = 10, maxiter: int = 2000,
                     inner_maxiter: int | None = None, transpose: bool = False,
                     preconditioner: str = "tridiag", stats: dict | None = None,
                     inner_algorithm: str = "bicgstab", grid=None):
    """`solve_shifted` with mixed-precision iterative refinement: inner
    Krylov solves in the coefficients' precision (f32 or f64) and the
    defect b - A x in f64, through the K1 kernel on the narrow
    coefficients. Returns (x in f64, relative residual). bf16 coefficients
    run the JAX package's bf16-narrow mode: the inner solves keep b and
    their Krylov vectors in f32 and stream the bf16 coefficients through
    K1's (bf16, f32) kernel, M is built on the legs widened to f32, and the
    refinement converges against the bf16-rounded operator.

    `grid` (a `parallel.mesh.ProcessGrid`; the JAX package's `mesh=`) runs
    the solve on a process grid: `coeffs`, `b` and `extra_diag` are the
    rank's shards, `topology` the global one, every rank calls it, and the
    inner solves and the f64 defects go through the halo exchange and K7
    (`parallel.solve_halo`). Returns the rank's shard of x.

    `inner_algorithm`: "bicgstab" runs each pass through `solve_shifted`;
    "bicgstab2" through `solve_shifted_chunked(algorithm="bicgstab2",
    max_restarts=0)` (the outer loop is the restart), with a pass budget of
    min(maxiter, 600) matvec pairs unless `inner_maxiter` says otherwise;
    "gmres" through `solve_shifted_chunked(algorithm="gmres")` (GMRES(30)
    with its stall stop), with a budget of min(maxiter, 1200) Arnoldi
    steps, the matvecs of 600 BiCGStab(2) pairs. In the bf16-narrow mode
    every algorithm keeps f32 vectors.

    The best iterate is kept (narrow) and restored after a pass that left
    the defect more than 1/0.9x the best (or not finite); that reverted
    pass gets one retry, from the narrow-rounded best iterate, whose inner
    solve takes another path. (The JAX package reverts only a pass 4x
    worse, and refines on from the iterate a pass 1-4x worse left.) Any
    other pass that starts without a 0.9x contraction of the previous
    pass's start stops the loop with a warning: repeating a stalled pass
    from the same defect cannot help. Each pass asks its inner solve only
    for the contraction still needed, max(inner_tol, 0.5 * tol / rel), at
    most 0.9.

    `stats`, if a dict, receives ``passes`` (one dict per pass: rel_start,
    reverted, inner_tol, inner_iters, inner_stop, inner_restarts,
    inner_end_rel, inner_chunk_s, wall_s), ``refinements`` and
    ``rel_final``."""
    if inner_algorithm not in ALGORITHMS:
        raise ValueError(f"unknown inner_algorithm {inner_algorithm!r}")
    field, coeffs = _field_for(coeffs, topology, transpose, grid)
    wide = torch.float64
    narrow = coeffs.diag.dtype
    # bf16-narrow mode (the JAX package's `narrow_vec`): bf16 coefficients
    # stream into the inner matvecs, while b, the Krylov vectors and M stay
    # f32; the f64 defect reads the coefficients widened to f32 (exactly).
    narrow_vec = torch.float32 if narrow == torch.bfloat16 else narrow
    c_defect = coeffs.to(narrow_vec)
    if inner_maxiter is None:
        inner_maxiter = {"bicgstab2": min(maxiter, 600),
                         "gmres": min(maxiter, 1200)}.get(inner_algorithm, maxiter)
    else:
        inner_maxiter = min(maxiter, inner_maxiter)

    extra_n = torch.zeros((), dtype=b.dtype, device=b.device) if extra_diag is None else extra_diag
    b_nv = b.to(narrow_vec)
    bn_n = field.norm(b_nv)
    bnorm_safe = bn_n if bn_n != 0 else 1.0

    x = torch.zeros(b.shape, dtype=wide, device=b.device)
    rel = math.inf
    rel_prev = math.inf
    prev_reverted = False
    best_x = None
    best_rel = math.inf
    pass_log = [] if stats is None else stats.setdefault("passes", [])

    for pass_i in range(max_refinements):
        t_pass = time.perf_counter()
        if pass_i == 0:
            # x == 0, so the defect is b: no wide apply needed.
            r_hat, s_safe, rel = b_nv / bnorm_safe, bnorm_safe, bn_n / bnorm_safe
        else:
            r_hat, s_safe, rel = _ir_defect(field, c_defect, x, b, extra_n, shift, bnorm_safe)
        if rel < best_rel:
            best_rel = rel
            best_x = x.to(narrow_vec)
        if rel <= tol:
            break
        reverted = False
        if best_x is not None and not rel <= best_rel / 0.9:
            # the last pass made the defect worse by more than the 0.9x
            # that counts as progress: refine from the best iterate
            x = best_x.to(wide)
            r_hat, s_safe, rel = _ir_defect(field, c_defect, x, b, extra_n, shift, bnorm_safe)
            reverted = True
        entry = {"rel_start": rel, "reverted": reverted}
        pass_log.append(entry)
        retry = reverted and not prev_reverted
        if rel >= 0.9 * rel_prev and not retry:
            warnings.warn(
                f"solve_shifted_ir: refinement stagnated at relative residual "
                f"{rel:.3e} (previous {rel_prev:.3e}); the inner {inner_algorithm} solve is "
                f"likely exiting at its inner_maxiter={inner_maxiter} budget without "
                f"reaching inner_tol={inner_tol}.",
                stacklevel=2,
            )
            entry["stagnated"] = True
            break
        rel_prev, prev_reverted = rel, reverted
        pass_tol = min(0.9, max(inner_tol, 0.5 * tol / rel))
        inner = {}
        rhs = r_hat.to(narrow_vec)
        del r_hat
        kw = dict(shift=shift, extra_diag=extra_diag, tol=pass_tol, maxiter=inner_maxiter,
                  preconditioner=preconditioner, stats=inner, grid=grid)
        if inner_algorithm != "bicgstab":
            d, _ = solve_shifted_chunked(coeffs, rhs, topology, max_restarts=0,
                                         algorithm=inner_algorithm, **kw)
        else:
            d, _ = solve_shifted(coeffs, rhs, topology, **kw)
        del rhs
        x = x + s_safe * d.to(wide)
        entry.update(inner_tol=pass_tol, inner_iters=inner["iters"], inner_stop=inner["stop"],
                     inner_restarts=inner["restarts"], inner_end_rel=inner["end_rel"],
                     inner_chunk_s=inner["chunk_s"], wall_s=time.perf_counter() - t_pass)
    else:
        _, _, rel = _ir_defect(field, c_defect, x, b, extra_n, shift, bnorm_safe)
        if rel < best_rel:
            best_rel, best_x = rel, x
    if best_x is not None and best_rel < rel:
        # the f32-rounded recovery point: keep it only if it really is better
        x_cand = best_x.to(wide)
        _, _, rel_cand = _ir_defect(field, c_defect, x_cand, b, extra_n, shift, bnorm_safe)
        if rel_cand < rel:
            x, rel = x_cand, rel_cand
    if stats is not None:
        stats.update(refinements=len(pass_log), rel_final=rel)
    return x, rel


def _steady_state(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
                  surface_rate: float, tol: float, refine: bool, algorithm: str,
                  transpose: bool, stats: dict | None, grid=None):
    """(T + M) x = 1 (T' when `transpose`) on wet cells, M = surface_rate on
    the surface layer; NaN on land. On a process grid, on the rank's shard."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    wet = wet3d.to(torch.bool)
    ones = wet.to(coeffs.diag.dtype)
    surf = torch.zeros_like(ones)
    surf[0] = surface_rate
    surf = torch.where(wet, surf, 0.0)
    kw = dict(extra_diag=surf, tol=tol, transpose=transpose, stats=stats, grid=grid)
    if refine:
        x, res = solve_shifted_ir(coeffs, ones, topology, inner_algorithm=algorithm, **kw)
    elif algorithm == "bicgstab":
        x, res = solve_shifted(coeffs, ones, topology, **kw)
    else:
        x, res = solve_shifted_chunked(coeffs, ones, topology, algorithm=algorithm, **kw)
    return torch.where(wet, x, float("nan")), res


def ideal_age(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
              surface_rate: float = 1.0, tol: float = 1e-8, refine: bool = False,
              stats: dict | None = None, algorithm: str = "bicgstab", grid=None):
    """Steady-state ideal mean age Gamma (seconds) from
    (T + M) Gamma = 1 on wet cells, M = surface_rate on the surface layer
    (reference test/local_full.jl:155-168). Returns (gamma with NaN on
    land, relative residual). `refine=True` runs `solve_shifted_ir`
    (inner solves in the coefficients' f32 or f64, f32 for bf16
    coefficients; f64 defects) and returns gamma in f64.
    `algorithm` ("bicgstab", "bicgstab2" or "gmres"; the JAX package's
    `method`) is the refinement's inner algorithm, or the engine's
    algorithm without refinement.

    `grid` (a `parallel.mesh.ProcessGrid`; the JAX package's `mesh=`) runs
    it on a process grid: `coeffs` and `wet3d` are the rank's shards,
    `topology` the global one, every rank calls it, and it returns the
    rank's shard of gamma (`parallel.solve_halo`)."""
    return _steady_state(coeffs, wet3d, topology, surface_rate, tol, refine, algorithm,
                         False, stats, grid)


def sequestration_time(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
                       surface_rate: float = 1.0, tol: float = 1e-8, refine: bool = False,
                       stats: dict | None = None, algorithm: str = "bicgstab", grid=None):
    """Mean sequestration time (seconds), the adjoint of the ideal age: the
    expected time for water at each cell to next reach the surface,
    (T' + M) Gamma_dagger = 1 on wet cells, through the stencil form of
    T' (`transpose_coeffs`). Arguments and returns as `ideal_age`, `grid`
    included."""
    return _steady_state(coeffs, wet3d, topology, surface_rate, tol, refine, algorithm,
                         True, stats, grid)


def solve_shifted_chunked_multi(coeffs: StencilCoeffs, bs: torch.Tensor,
                                topology: GridTopology, shift: float = 0.0,
                                extra_diag: torch.Tensor | None = None, tol: float = 1e-10,
                                maxiter: int = 2000, chunk: int = CHUNK,
                                transpose: bool = False, preconditioner: str = "tridiag",
                                verbose: bool = False, early_stop: bool = True,
                                max_restarts: int = 2, algorithm: str = "bicgstab",
                                stats: dict | None = None, max_diverge_restarts: int = 2,
                                grid=None):
    """Solve (shift * I + D_extra + T) x_b = b_b (T' when `transpose`) for a
    batch of right-hand sides `bs` (B, nz, ny, nx) in one lockstep Krylov
    loop. Returns (xs, residuals): xs (B, nz, ny, nx) and the (B,) relative
    residuals ||A x_b - b_b|| / ||b_b|| as a float64 host tensor,
    recomputed from xs in bs's dtype.

    The engine of `solve_shifted_chunked` for a batch: the same algebra
    with (B,) per-member scalars; each matvec is one K5 launch for all
    members (the coefficients read once for the batch) and M one batched K2
    launch (or Jacobi). BiCGStab(2) runs in y-space, x = M y. Arguments as
    in `solve_shifted_chunked`, with these rules per member:

    - The per-member residuals are read every `chunk` matvec pairs (the
      first chunk also after 1, 2, 4, ...); each member keeps its best
      iterate, which is what it returns.
    - A member that meets tol at a read is done and stays done, however its
      recurrence goes on in lockstep; the solve stops when all are done.
    - Divergence (4x the pass-start norm at two consecutive reads, or
      non-finite at one) restarts the diverged members from their best
      iterates with a jittered shadow vector, from one budget of
      `max_diverge_restarts` for the batch. With the budget spent, a
      non-finite member is done (with its best iterate); a finite member
      with no progress makes the exits dormant, as for a single field;
      when every member still running has diverged, the solve stops.
    - `early_stop`: a 3-chunk window without 2 % of gain restarts the
      stalled members (converged ones masked out), at most `max_restarts`
      times for the batch (the jittered restarts have their own budget,
      as in the JAX package); then the solve stops with a warning once
      every member still running has stalled.
    - `stats` as in `solve_shifted_chunked`, but ``restarts`` counts the
      stall restarts only; ``end_rel`` is the worst member's.
    - `grid` (a `parallel.mesh.ProcessGrid`) runs the batch on a process
      grid, where the JAX package runs it by GSPMD: `coeffs`, `bs` (B, nz,
      ny_l, nx_l) and `extra_diag` are the rank's shards, `topology` the
      global one, and every rank calls it. A matvec is one exchange of the
      batch's halo lines and one K7 multi launch (overlapped as in
      `parallel.halo_kernel.euler_propagate_halo_multi`), M the batched K2
      on the shard's own columns, and each reduction one all-reduce of
      the (B,) partial sums. Returns the rank's shard of xs and the whole
      field's residuals, the same on every rank."""
    if algorithm not in MULTI_ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if bs.ndim != 4 or bs.shape[0] < 1:
        raise ValueError(f"bs must be (B, nz, ny, nx) with B >= 1; got {tuple(bs.shape)}")
    return solve_shifted_chunked(coeffs, bs, topology, shift=shift, extra_diag=extra_diag,
                                 tol=tol, maxiter=maxiter, chunk=chunk, transpose=transpose,
                                 preconditioner=preconditioner, verbose=verbose,
                                 early_stop=early_stop, max_restarts=max_restarts,
                                 algorithm=algorithm, stats=stats, fused=False,
                                 max_diverge_restarts=max_diverge_restarts, grid=grid)


def solve_shifted_multi(coeffs: StencilCoeffs, bs: torch.Tensor, topology: GridTopology,
                        shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                        tol: float = 1e-10, maxiter: int = 2000, transpose: bool = False,
                        preconditioner: str = "tridiag", stats: dict | None = None,
                        grid=None):
    """`solve_shifted` for a batch `bs` (B, nz, ny, nx): one lockstep
    BiCGStab over all members, the engine without stall stops or
    restarts (`solve_shifted_chunked_multi` documents it, `grid`
    included). Returns (xs, (B,) relative residuals)."""
    return solve_shifted_chunked_multi(coeffs, bs, topology, shift=shift,
                                       extra_diag=extra_diag, tol=tol, maxiter=maxiter,
                                       transpose=transpose, preconditioner=preconditioner,
                                       early_stop=False, max_restarts=0, algorithm="bicgstab",
                                       stats=stats, max_diverge_restarts=0, grid=grid)


def water_mass_fractions(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
                         region_masks, surface_rate: float = 1.0, tol: float = 1e-8,
                         preconditioner: str = "tridiag", algorithm: str = "bicgstab",
                         stats: dict | None = None, grid=None):
    """Steady-state surface-origin water-mass fractions, one batched solve
    for all regions. For a partition of the surface into R regions,
    fraction r satisfies the dye steady state

        (T + M) f_r = M 1_region_r,   M = surface_rate on the wet surface,

    so f_r(cell) is the fraction of the water at `cell` that last touched
    the surface in region r; by linearity the fractions of a partition sum
    to the all-surface dye solve. `region_masks` is (R, ny, nx) boolean.
    Returns (fractions (R, nz, ny, nx) with NaN on land, (R,) relative
    residuals); a region with no wet surface cell gives zeros and residual 0.

    The solve runs in the coefficients' dtype, without refinement.
    `algorithm` routes it: "bicgstab" (`solve_shifted_multi`, the JAX
    package's 1-degree route) or "bicgstab2" (`solve_shifted_chunked_multi`
    with BiCGStab(2), its 0.25-degree route). `stats` receives the
    engine's stats.

    The relative residual is the surface rows' (b is `surface_rate` there,
    the interior legs are orders of magnitude smaller), so a loose tol
    leaves the interior unresolved: on the 1-degree synthetic operator the
    all-surface dye at tol 1e-8 spans [0.0009, 1.92] against the converged
    [0.9998, 1.0002]; an f64 solve converges from tol 1e-12. The JAX
    package's `water_mass_fractions` shares this: on a 72x60x12 grid its
    fractions, like these, miss the converged dye by ~1 at tol 1e-8
    (`tests/test_torch_multi.py`).

    `grid` (a `parallel.mesh.ProcessGrid`; the JAX package runs the batch
    by GSPMD on a sharded one) runs it on a process grid: `coeffs` and
    `wet3d` are the rank's shards, as in `ideal_age(grid=)`, while
    `region_masks` stays the GLOBAL (R, ny, nx) partition, as the JAX
    function takes it; each rank slices it to its shard by
    `grid.offset`. Every rank calls it and gets its shard of the fractions
    and the whole field's residuals (`solve_shifted_chunked_multi`)."""
    if algorithm not in MULTI_ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    wet = wet3d.to(torch.bool)
    dtype = coeffs.diag.dtype
    masks = torch.as_tensor(region_masks, dtype=torch.bool, device=wet.device)
    if grid is not None:
        if tuple(masks.shape[-2:]) != (topology.ny, topology.nx):
            raise ValueError(f"region_masks must be the global (R, {topology.ny}, "
                             f"{topology.nx}) partition; got {tuple(masks.shape)}")
        (ny_l, nx_l), (j0, i0) = wet.shape[-2:], grid.offset(topology.ny, topology.nx)
        masks = masks[:, j0:j0 + ny_l, i0:i0 + nx_l]
    surf = torch.zeros(wet.shape, dtype=dtype, device=wet.device)
    surf[0] = surface_rate
    surf = torch.where(wet, surf, 0.0)
    bs = torch.where(wet[None] & masks[:, None], surf[None], 0.0)
    kw = dict(extra_diag=surf, tol=tol, preconditioner=preconditioner, stats=stats, grid=grid)
    if algorithm == "bicgstab":
        fr, res = solve_shifted_multi(coeffs, bs, topology, **kw)
    else:
        fr, res = solve_shifted_chunked_multi(coeffs, bs, topology, algorithm=algorithm, **kw)
    return torch.where(wet[None], fr, float("nan")), res
