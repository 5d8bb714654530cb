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

On one card BiCGStab(1) is issued as CUDA graphs: after one eager
iteration, each iteration is one replay of a captured iteration (two K2,
two K1 and K13's five entry calls) between two preallocated state sets,
so the host issues an iteration in one launch-path call rather than nine
and stays ahead of the device (`_graphed` says where, from the input
alone: BiCGStab(1) on a CUDA tensor on the whole field; `_PingPong`).
Each public solve builds one system (`_system`) and hands it to `_solve`;
the system keeps the two graphs' loop captured on it, so the passes of a
refinement, which share its system, capture once, and the state sets go
when the public call returns (`_capture` says what stays).
Shards (whose all-reduces cannot be captured), CPU tensors, BiCGStab(2)
and GMRES issue every entry call eagerly.

With the Redi operator R (`redi=`, `models.redi.build_redi_operator`) a
field's system is (shift * I + D_extra + T - R) x = b, the neutral
physics' steady states: on the card each matvec is one launch of K6's
matvec mode (`models.redi_kernel.matvec`, no K1), the Thomas legs of M are
T's vertical legs less R's pure vertical ones (`models.redi.vertical_legs`),
and the refinement's defects apply T - R in f64 through K6's f64 matvec
mode. The batched solves, the adjoint (T'), shards and K3 do not take R
yet and say so.

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
import threading
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build
from ..grid.topology import GridTopology
from ..ops.apply import transpose_coeffs
from ..ops.coeffs import StencilCoeffs
from ..ops.krylov import fused_krylov_step, krylov_scratch
from ..ops.krylov_algebra import (bicg1_p, bicg1_s, bicg1_sums, bicg1_update, polish_sums,
                                  polish_update)
from ..ops.stencil import euler_propagate, euler_step, stencil_apply, stencil_apply_multi
from ..ops.tridiag import tridiag_factor, tridiag_solve_factored
from ..utils import debugging
from ..utils.tracing import span, traced
from . import redi_kernel
from .redi import RediOperator, redi_apply, vertical_legs

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


def _thomas(coeffs: StencilCoeffs, shifted_diag: torch.Tensor,
            redi: RediOperator | None = None):
    """The Thomas legs (lower, guarded diagonal, upper) of M = diag(shifted)
    + T_top + T_bottom, less R's pure vertical legs with `redi`
    (`vertical_legs`), in the shifted diagonal's dtype (bf16 legs widen
    exactly to f32), and their factor (cp, rden): one K2 factor launch."""
    dtype = shifted_diag.dtype
    # lower = bottom couples to k+1, upper = top to k-1
    lower, upper = coeffs.bottom.to(dtype), coeffs.top.to(dtype)
    if redi is not None:
        r_upper, r_diag, r_lower = vertical_legs(redi, dtype)
        lower, shifted_diag, upper = lower - r_lower, shifted_diag - r_diag, upper - r_upper
    legs = (lower, _guarded(shifted_diag), upper)
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
    whole: bool = False  # the whole field on one device: its reductions never leave it


def _whole_field(topology: GridTopology) -> _Field:
    """The whole field on one device: K1 on a field, K5 on a batch (B, nz,
    ny, nx); plain dots and norms."""

    def apply(c: StencilCoeffs, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            return stencil_apply_multi(c, x, topology)
        return stencil_apply(c, x, topology)

    return _Field(apply, _dot, lambda v: _read(torch.linalg.vector_norm(v), "norm")[0],
                  lambda s: s, whole=True)


class _System(NamedTuple):
    """One shifted system (shift * I + D_extra + A - R) x = b in the
    engine's form: `a` is A with shift + extra folded into its diagonal,
    `redi` the Redi operator R in the system's types or None, `M` the
    preconditioner, `m_legs` the Thomas legs (lower, guarded diagonal,
    upper) and `factor` their (cp, rden) when M is the tridiagonal one,
    `field` the whole field or a shard, `coeffs` A's own coefficients (T'
    formed), which the refinement's defects read. With bf16 coefficients
    and f32 vectors (`solve_shifted_ir`'s bf16-narrow mode) `a` keeps the
    bf16 coefficients and `outside` holds (shift, extra), applied beside the
    kernel as the JAX package's matvec applies them. `loops` holds the
    graphed BiCGStab(1) loops captured on the system (`_loop`): whoever
    shares the system shares them, and they go with it."""

    a: StencilCoeffs
    topology: GridTopology
    M: Callable[[torch.Tensor], torch.Tensor]
    m_legs: tuple | None
    field: _Field
    factor: tuple | None
    outside: tuple | None
    coeffs: StencilCoeffs
    loops: dict
    redi: RediOperator | None = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """(shift * I + D_extra + A - R) x: with R, one launch of K6's
        matvec mode on the card, or in the bf16-narrow mode K1 and K6
        beside the shift."""
        if self.outside is None:
            if self.redi is None:
                return self.field.apply(self.a, x)
            return _matvec(self.a, self.redi, x, self.topology)
        shift, extra = self.outside
        y = shift * x + extra * x + self.field.apply(self.a, x)
        return y if self.redi is None else y - redi_kernel.redi_apply_fused(self.redi, x)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.field.dot(a, b)


def _matvec(legs: StencilCoeffs, redi: RediOperator, x: torch.Tensor,
            topology: GridTopology) -> torch.Tensor:
    """T x - R x for one field: one launch of K6's matvec mode on the card,
    the plain versions composed on the CPU (the same bits)."""
    if x.is_cuda:
        return redi_kernel.matvec(legs, redi, x)
    return stencil_apply(legs, x, topology) - redi_apply(redi, x)


def _not_yet(what: str, redi) -> None:
    """A ValueError for `redi=` where `what` does not take it yet."""
    if redi is not None:
        raise ValueError(f"{what} with redi= is not yet supported: the Redi operator runs in "
                         f"the steady-state solves of one field on one device (ideal_age, "
                         f"solve_shifted, solve_shifted_chunked, solve_shifted_ir)")


def _system_redi(redi, t_leg: torch.Tensor, topology: GridTopology, dtype: torch.dtype,
                 narrow: bool, stand_in: torch.Tensor) -> RediOperator:
    """`redi` checked against T (`t_leg`, one of its legs as given) and
    taken to the system's types: a RediOperator on T's grid, in T's dtype,
    on T's device; in the bf16-narrow mode R stays bf16 (K6's (bf16, f32)
    kernel), elsewhere it takes `dtype` with T, in which K6's matvec mode
    must have an entry. `stand_in` is a field of the system's values, for
    K6's own checks."""
    if not isinstance(redi, RediOperator):
        raise TypeError(f"redi: got a {type(redi).__name__}, expected a RediOperator "
                        f"(build_redi_operator)")
    topo = redi.topology
    if topo.kind != topology.kind or topo.shape3d != topology.shape3d:
        raise ValueError(f"redi: the operator is on a {topo.kind} grid of {topo.shape3d}, T "
                         f"on a {topology.kind} grid of {topology.shape3d}")
    if redi.ae.dtype != t_leg.dtype:
        raise TypeError(f"redi: R's coefficients are {redi.ae.dtype}, T's {t_leg.dtype}: "
                        f"R's type must match T's")
    if redi.ae.device != t_leg.device:
        raise ValueError(f"redi: R is on {redi.ae.device}, T on {t_leg.device}")
    if not narrow:
        redi = redi.to(dtype)
        redi_kernel.apply_entry(dtype, dtype, dtype)
    redi_kernel.validate(redi, stand_in, False, topology)
    return redi


def _system(coeffs: StencilCoeffs, dtype: torch.dtype, topology: GridTopology, shift=0.0,
            extra_diag: torch.Tensor | None = None, transpose: bool = False,
            preconditioner: str = "tridiag", grid=None, overlap: bool = True,
            redi: RediOperator | None = None) -> _System:
    """The engine's system in `dtype`, on the whole field or (`grid`) on
    this rank's shard; each public solve builds one and hands it on. For
    T' the stencil form of T' is built once; its vertical legs are the
    transposed operator's, so the Thomas M is built from them too, and
    factored once. On a shard the Thomas solve needs no neighbours, since k
    is never sharded. bf16 coefficients with f32 vectors (the bf16-narrow
    mode) stay bf16 in A (K1's (bf16, f32) kernel) and are widened to f32
    in M. With `redi` (`_system_redi`: one field, no T', no grid, the
    Thomas M) the system is T - R, and M's legs lose R's pure vertical
    ones."""
    if grid is not None or transpose:
        _not_yet("a process grid (grid=)" if grid is not None else
                 "the adjoint (transpose=True)", redi)
    if grid is None:
        field = _whole_field(topology)
        coeffs = transpose_coeffs(coeffs, topology) if transpose else coeffs
    else:
        from ..parallel.solve_halo import halo_field, transpose_coeffs_halo

        field = halo_field(topology, grid, overlap)
        coeffs = transpose_coeffs_halo(coeffs, topology, grid) if transpose else coeffs
    t_leg = coeffs.diag
    narrow = coeffs.diag.dtype == torch.bfloat16 and dtype == torch.float32
    if not narrow:
        coeffs = coeffs.to(dtype)
    extra = 0.0 if extra_diag is None else extra_diag.to(dtype)
    shifted = shift + extra + coeffs.diag.to(dtype)
    a = coeffs if narrow else coeffs._replace(diag=shifted)
    outside = (shift, extra) if narrow else None
    if redi is not None:
        redi = _system_redi(redi, t_leg, topology, dtype, narrow, shifted)
    if preconditioner == "tridiag":
        m_legs, (cp, rden) = _thomas(coeffs, shifted, redi)
        M, factor = (lambda v: tridiag_solve_factored(cp, rden, m_legs[2], v)), (cp, rden)
    elif preconditioner == "jacobi":
        _not_yet("the jacobi preconditioner", redi)
        M, m_legs, factor = _jacobi_preconditioner(shifted), None, None
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    return _System(a, topology, M, m_legs, field, factor, outside, coeffs, {}, redi)


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


def _bicgstab_iteration(sys_: _System, st: _State1, out: _State1 | None = None) -> _State1:
    """One iteration of right-preconditioned BiCGStab, with the breakdown
    guards of the JAX package's `_sr_chunk1`. Around its two M (K2) and two
    A (K1) applications its vector algebra is K13's four entries
    (`ops/krylov_algebra.py`), the scalars on the device; the sums are
    `sys_`'s, reduced over the field (on a shard, one all-reduce each:
    <rhat, v>, then <t, s> with <t, t>, then <rhat, r>). Nothing is read
    back, so on a whole field the iteration can be captured as a CUDA graph
    (`_PingPong`). `out`, a state set of a whole field, receives x', r', p'
    and rho' (its rhat is st's); otherwise they are fresh tensors."""
    x, r, p, rhat, rho = st
    A, M, reduce = sys_.apply, sys_.M, sys_.field.reduce
    phat = M(p)
    v = A(phat)
    s, alpha = bicg1_s(r, v, rho, reduce(bicg1_sums(v, rhat)))
    shat = M(s)
    t = A(shat)
    to = _State1(*(None,) * 5) if out is None else out
    x, r, omega, rho_new = bicg1_update(x, phat, shat, s, t, rhat, alpha,
                                        reduce(bicg1_sums(t, s, with_aa=True)),
                                        x_out=to.x, r_out=to.r, rho_out=to.rho)
    rho_new = reduce(rho_new)
    p = bicg1_p(r, p, v, rho, rho_new, alpha, omega, out=to.p)
    return _State1(x, r, p, rhat, rho_new)


def _bicgstab_steps(sys_: _System, st: _State1, nsteps: int) -> _State1:
    """`nsteps` iterations (`_bicgstab_iteration`) issued one entry call at a
    time, each into fresh tensors: the eager loop, which shards, CPU
    tensors and the first part of a graphed solve take. Where `_graphed`
    engages (BiCGStab(1) on the whole field of a CUDA tensor) the engine
    issues the later iterations as replays of captured ones instead
    (`_PingPong`), with the same bits."""
    for _ in range(nsteps):
        st = _bicgstab_iteration(sys_, st)
    return st


def _graphed(sys_: _System, algorithm: str, b) -> bool:
    """Whether the engine replays BiCGStab(1)'s iterations as CUDA graphs
    (`_PingPong`), read from the solve's input alone: BiCGStab(1) on a CUDA
    tensor (a field or a batch, f32 or f64, the bf16-narrow mode too) on the
    whole field. A shard's all-reduces (gloo's are staged through the host)
    cannot be captured, a CPU tensor has no graph, and BiCGStab(2) and GMRES
    keep their own loops."""
    return algorithm == "bicgstab" and b.is_cuda and sys_.field.whole


#: Per host thread, per device: [the side stream on which the engine
#: captures its graphs, the memory pool of their intermediates, the graphs
#: captured last].
_side = threading.local()


def _capture(sys_: _System, sets: list[_State1]) -> list:
    """Graphs AB and BA: one BiCGStab(1) iteration each, captured from
    `_bicgstab_iteration` on set 0 into set 1 and on set 1 into set 0, each
    with what its entry calls were counted (`_build.capturing`): [(graph,
    tally), ...]. Captured on this thread's side stream, which first waits
    on the current one, directly through `capture_begin`/`capture_end`:
    `torch.cuda.graph` synchronises, empties the caching allocator and may
    run a full garbage collection at every capture, each dearer than a
    solve's gain. Nothing runs while capturing.

    The intermediates (phat, v, s, shat, t, the scalars and partial sums)
    come from one memory pool that every capture of this thread on this
    device shares, through the same side stream (the caching allocator
    hands a freed block only to the stream that freed it). Each is dead
    when its iteration ends (the outputs are the state sets), so graphs
    that share the pool may be replayed in any order on one stream. A pool
    lives while a graph captured into it does, so the thread keeps the
    graphs it captured last until the next capture has taken the pool's
    blocks again: a fresh pool would allocate from the device at every
    capture, and a pool whose graphs are all gone keeps its memory
    reserved until an allocation fails. Between solves the pool holds the
    intermediates of the largest iteration the thread captured."""
    device = sets[0].x.device
    held = _side.__dict__.setdefault("devices", {})
    if device.index not in held:
        held[device.index] = [torch.cuda.Stream(device), torch.cuda.graph_pool_handle(), None]
    side, pool, _ = held[device.index]
    current = torch.cuda.current_stream(device)
    side.wait_stream(current)
    graphs = []
    with torch.cuda.stream(side):
        for i in (0, 1):
            graph = torch.cuda.CUDAGraph()
            with _build.capturing() as tally:
                graph.capture_begin(pool=pool)
                try:
                    _bicgstab_iteration(sys_, sets[i], out=sets[1 - i])
                finally:
                    graph.capture_end()
            graphs.append((graph, tally))
    current.wait_stream(side)
    held[device.index][2] = graphs
    return graphs


class _PingPong:
    """BiCGStab(1) as the replay of one captured CUDA graph an iteration,
    for one `_engine` call, on two state sets A and B (x, r, p, rho each;
    one rhat tensor that both read): graph AB runs an iteration from A into
    B, graph BA one from B back into A, so no state is copied between
    iterations. The graphs read the system's own tensors. `state` is the
    set the next replay reads; its tensors are overwritten two replays
    later, so whatever must outlive them (the engine's best iterate) is a
    copy. The state sets go with the loop; the graphs at the thread's next
    capture (`_capture`)."""

    def __init__(self, sys_: _System, state: _State1):
        rhat = torch.empty_like(state.rhat)
        self.sets = [_State1(*(rhat if name == "rhat" else torch.empty_like(t)
                               for name, t in zip(_State1._fields, state)))
                     for _ in range(2)]
        self.cur = 0
        self.load(state)
        with span("engine.capture"):
            self.graphs = _capture(sys_, self.sets)

    @property
    def state(self) -> _State1:
        return self.sets[self.cur]

    def load(self, state: _State1) -> None:
        """Copy `state` (rhat included) into the set the next replay reads."""
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    def steps(self, nsteps: int) -> _State1:
        """`nsteps` replays, alternating AB and BA; one launch-path call
        each (`_build.replay`, "graph:bicg1")."""
        for _ in range(nsteps):
            _build.replay(*self.graphs[self.cur], "graph:bicg1")
            self.cur ^= 1
        return self.state


def _loop(sys_: _System, state: _State1) -> _PingPong:
    """The graphed loop on `sys_` for `state`'s shape and dtype, loaded with
    it: the one an earlier engine call on the system captured (a pass of
    `solve_shifted_ir` before), or a new one, which the system keeps."""
    key = (state.x.shape, state.x.dtype)
    if key not in sys_.loops:
        sys_.loops[key] = _PingPong(sys_, state)
    else:
        sys_.loops[key].load(state)
    return sys_.loops[key]


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
    """Values the engine or the refinement reads to the host, as floats,
    inside an `engine.read` span (every read of theirs comes through here);
    with NaN debugging on (`utils.debugging.enable_nan_debugging`), a
    non-finite one raises FloatingPointError."""
    with span("engine.read", what=what):
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
        with span("gmres.cycle") as cycle:
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
            say(f"cycle {cycles}: rel residual at its start "
                f"{math.sqrt(start_rn2 / bnorm2):.3e}, least-squares estimate after "
                f"{math.sqrt(est2 / bnorm2):.3e}")
            if early_stop and cycles % 3 == 0:
                if not start_rn2 < 0.98 ** 2 * window_rn2:
                    warnings.warn(
                        f"solve_shifted_chunked: GMRES relative residual "
                        f"{math.sqrt(start_rn2 / bnorm2):.3e} after {iters} Arnoldi steps "
                        f"improved <2% over the last 3 cycles — likely the rounding floor of "
                        f"{b.dtype}; wrap in solve_shifted_ir for tighter residuals, or pass "
                        f"early_stop=False to keep iterating.", stacklevel=5)
                    stop = "stall"
                window_rn2 = start_rn2
            if est2 <= atol2 or iters >= maxiter or stop != "maxiter":
                rn2 = _read(sys_.dot(r, r), "residual")[0]  # confirm with the true residual
        chunk_s.append(round(cycle.seconds, 4))
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
    rnorm = [math.sqrt(v) for v in _read(sys_.dot(r, r), "final residual")]
    return x, [v / (math.sqrt(w) if w > 0 else 1.0) for v, w in zip(rnorm, bnorm2)]


def _engine(sys_: _System, b: torch.Tensor, tol: float, maxiter: int, chunk: int,
            algorithm: str, fused: bool, early_stop: bool, max_restarts: int,
            max_diverge_restarts: int, stats: dict | None, verbose: bool = False):
    """The one Krylov loop, for a field b (nz, ny, nx) or in lockstep for a
    batch (B, nz, ny, nx) (`solve_shifted_chunked` and
    `solve_shifted_chunked_multi` document its rules). A field is one
    member whose state stays a field with 0-d scalars; GMRES takes fields
    only (`_gmres`). Returns (x, relative residuals ||A x - b|| / ||b||
    recomputed from x, a list of one float per member).

    Where `_graphed` engages (BiCGStab(1) on the whole field of a CUDA
    tensor), the first part of the first chunk runs eagerly, as the warm-up;
    then two iterations are captured as graphs (`_PingPong`, in an
    `engine.capture` span; a later engine call on the same system, a later
    pass of `solve_shifted_ir`, takes the loop the system keeps, `_loop`)
    and every later iteration is one replay, issued while the device works
    through the previous ones. The reads stay outside the graphs; restarts
    are copied into the state the next replay reads, and the best iterate
    is a copy. The state sets go with the system, when the public call that
    built it returns; the graphs at the thread's next capture. Shards, CPU
    tensors, BiCGStab(2) and GMRES issue every entry call themselves. Both
    loops give the same bits."""
    if algorithm == "gmres":
        return _gmres(sys_, b, tol, maxiter, early_stop, stats, verbose)
    step = (_fused_step(sys_, krylov_scratch(*sys_.m_legs, factor=sys_.factor)) if fused
            else _unfused_step(sys_))
    batch = b.ndim == 4
    bnorm2 = _read(sys_.dot(b, b), "||b||^2")
    members = range(len(bnorm2))
    atol2 = [tol ** 2 * v for v in bnorm2]
    state = _initial_state(sys_, algorithm, b)
    graphed = _graphed(sys_, algorithm, b)
    loop = None  # the graphed loop, captured at the first part after the warm-up
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
        with span("engine.restart", jitter=jitter):
            state = _restart_members(sys_, algorithm, step, state, best_x, b, mask, jitter)
            if loop is not None:
                loop.load(state)
                state = loop.state
        for m in members:
            if mask[m]:
                div_streak[m] = 0
                window_rn2[m] = math.inf
                pass_rn2[m] = best_rn2[m]

    def read():
        nonlocal rn2, best_x
        rn2 = _read(sys_.dot(state.r, state.r), "recurrence residual")
        better = [v < w for v, w in zip(rn2, best_rn2)]  # False for NaN
        # The eager loop never writes a tensor in place; a graphed one
        # overwrites its state two replays on, so its best iterate is a copy.
        if all(better):
            best_x = state.x if loop is None else state.x.clone()
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
        with span("engine.chunk") as this_chunk:
            nsteps = min(chunk, maxiter - iters)
            # BiCGStab(1) iterations, or BiCGStab(2) cycles of two matvec pairs
            units = nsteps if algorithm == "bicgstab" else max(1, nsteps // 2)
            # The first chunk is read after 1, 2, 4, ... units as well, for the
            # convergence test and the best iterate only.
            parts = _doubling(units) if first_chunk else [units]
            first_chunk = False
            for n in parts:
                pairs = n if algorithm == "bicgstab" else 2 * n
                # issued without a read: the span's length is the host's
                # issue time while the launch queue has room
                replayed = graphed and iters > 0
                with span("engine.steps", iters=pairs, graphed=replayed):
                    if replayed:
                        if loop is None:
                            loop = _loop(sys_, state)
                        state = loop.steps(n)
                    elif algorithm == "bicgstab":
                        state = _bicgstab_steps(sys_, state, n)
                    else:
                        state = _bicgstab2_cycles(sys_, step, state, n)
                iters += pairs
                read()
                say("rel recurrence residual " + " ".join(
                    f"{math.sqrt(v / w) if w else 0.0:.3e}" for v, w in zip(rn2, bnorm2)))
                if all(finished) or any(f is None and not math.isfinite(v)
                                        for f, v in zip(finished, rn2)):
                    break
        chunk_s.append(round(this_chunk.seconds, 4))
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
                        stacklevel=4,
                    )
                    stop = "stall"
                    break
            window_rn2 = list(rn2)

    del state, loop
    x = sys_.M(best_x) if algorithm == "bicgstab2" else best_x  # y-space for BiCGStab(2)
    return _finish(sys_, b, x, best_rn2, bnorm2, stats,
                   dict(iters=iters, restarts=restarts, stop=stop,
                        diverge_restarts=div_restarts, chunk_s=chunk_s))


def _check(algorithm: str, b: torch.Tensor, batch: bool = False) -> None:
    """A public solve's `algorithm` and right-hand side: a field or a
    batch; `batch`, the batched solves' (B, nz, ny, nx) with B >= 1,
    which have no GMRES."""
    if algorithm not in (MULTI_ALGORITHMS if batch else ALGORITHMS):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if batch and (b.ndim != 4 or b.shape[0] < 1):
        raise ValueError(f"bs must be (B, nz, ny, nx) with B >= 1; got {tuple(b.shape)}")
    if algorithm == "gmres" and b.ndim != 3:
        raise ValueError("gmres takes one field (nz, ny, nx); the batched solves have no GMRES")


def _solve(sys_: _System, b: torch.Tensor, tol: float, maxiter: int, algorithm: str,
           early_stop: bool, max_restarts: int, max_diverge_restarts: int, stats: dict | None,
           chunk: int = CHUNK, fused: bool | None = None, verbose: bool = False):
    """Every solve's way to the engine, in an `engine` span: `_engine` on
    `sys_` for b, under the caller's rules. Returns (x, the relative
    residual: a float for a field, the (B,) float64 host tensor for a
    batch). `fused`, unless the caller says, runs BiCGStab(2) on K3 where
    K3 can: the Thomas M, the whole field, coefficients of b's dtype, b a
    single field and no R."""
    thomas, whole, narrow = sys_.m_legs is not None, sys_.field.whole, sys_.outside is not None
    redi = sys_.redi is not None
    if fused is None:
        fused = (algorithm == "bicgstab2" and thomas and whole and not narrow and b.ndim == 3
                 and not redi)
    if fused and redi:
        raise ValueError("fused=True runs K3, which has no Redi operator: pass redi=None or "
                         "fused=False")
    if fused and not thomas:
        raise ValueError("fused=True needs the tridiag preconditioner (K3 is its Thomas solve)")
    if fused and narrow:
        raise ValueError("fused=True needs coefficients of b's dtype (K3 has no bf16 entry)")
    if fused and not whole:
        raise ValueError("on a process grid the solve runs unfused (K3 has no halo mode)")
    with span("engine", algorithm=algorithm, batch=b.shape[0] if b.ndim == 4 else 0,
              redi=redi):
        x, res = _engine(sys_, b, tol, maxiter, chunk, algorithm,
                         fused and algorithm == "bicgstab2", early_stop, max_restarts,
                         max_diverge_restarts, stats, verbose)
    return x, (res[0] if b.ndim == 3 else torch.tensor(res, dtype=torch.float64))


@traced
def solve_shifted_chunked(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                          shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                          tol: float = 1e-10, maxiter: int = 2000, chunk: int = CHUNK,
                          transpose: bool = False, preconditioner: str = "tridiag",
                          verbose: bool = False, early_stop: bool = True,
                          max_restarts: int = 2, algorithm: str = "bicgstab",
                          stats: dict | None = None, fused: bool | None = None,
                          max_diverge_restarts: int = 2, grid=None, overlap: bool = True,
                          redi: RediOperator | None = None):
    """Solve (shift * I + D_extra + T) x = b (T' when `transpose`; T - R
    with `redi`) with the host-driven Krylov engine. Returns (x, relative
    residual ||Ax - b|| / ||b||, recomputed from x in b's dtype); for a
    batch b (B, nz, ny, nx), `solve_shifted_chunked_multi`'s lockstep
    solve, the (B,) residuals as a float64 host tensor.

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
      read included; the `engine.chunk` (GMRES: `gmres.cycle`) spans'
      readings of the wall clock, `time.time_ns()`, which a clock step
      moves).
    - `grid` (a `parallel.mesh.ProcessGrid`; the JAX package's `mesh=`)
      runs the solve on a process grid: `coeffs`, `b` (one field, or a
      batch (B, nz, ny_l, nx_l)) and `extra_diag` are the rank's shards,
      `topology` the global one, and every rank calls it. The matvec is
      the halo exchange plus K7 (K7 multi for a batch: one exchange of the
      batch's lines and one launch; `overlap` as in
      `parallel.halo_kernel.stencil_apply_halo`), the dots are all-reduced
      (one all-reduce of the (B,) sums for a batch), and the solve runs
      unfused (K3 has no halo mode). Returns the rank's shard of x and the
      whole field's residual.
    - `redi` (a `RediOperator` on T's grid, in T's dtype, on T's device)
      solves (shift * I + D_extra + T - R) x = b, R the Redi isoneutral
      diffusion: on the card each matvec is one launch of K6's matvec mode
      (f32 or f64; the bf16-narrow mode runs K1 and K6's (bf16, f32)
      kernel), M's Thomas legs are T's vertical legs less R's pure vertical
      ones (`models.redi.vertical_legs`), and BiCGStab(2) runs unfused (K3
      has no R). Not yet with a batch, `transpose` or `grid`: they raise
      ValueError."""
    _check(algorithm, b)
    sys_ = _system(coeffs, b.dtype, topology, shift, extra_diag, transpose, preconditioner,
                   grid, overlap, redi)
    return _solve(sys_, b, tol, maxiter, algorithm, early_stop, max_restarts,
                  max_diverge_restarts, stats, chunk, fused, verbose)


@traced
def solve_shifted(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                  shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                  tol: float = 1e-10, maxiter: int = 2000, transpose: bool = False,
                  preconditioner: str = "tridiag", stats: dict | None = None, grid=None,
                  algorithm: str = "bicgstab", redi: RediOperator | None = None):
    """Solve (shift * I + D_extra + T) x = b matrix-free with BiCGStab
    (T' instead of T when `transpose`). Returns (x, relative residual
    ||Ax - b|| / ||b||, recomputed from x in b's dtype). `grid` and `redi`
    (T - R) as in `solve_shifted_chunked`. `algorithm` (the JAX package's
    `method`): "bicgstab", "bicgstab2" or "gmres" (GMRES(30), `maxiter`
    Arnoldi steps; `solve_shifted_chunked` documents each).

    The operator runs in b's dtype. The solve runs until ||r|| <= tol *
    ||b|| (read every `CHUNK` iterations), maxiter, or a recurrence that
    stops being finite or diverges; it is the engine of
    `solve_shifted_chunked` without stall stops or restarts. A solve that
    stops at maxiter is not an error; the residual says so.
    `stats`, if a dict, receives the engine's stats (``iters`` first)."""
    _check(algorithm, b)
    sys_ = _system(coeffs, b.dtype, topology, shift, extra_diag, transpose, preconditioner,
                   grid, redi=redi)
    return _solve(sys_, b, tol, maxiter, algorithm, early_stop=False, max_restarts=0,
                  max_diverge_restarts=0, stats=stats)


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


def _wide_apply(sys_: _System, narrow_vec: torch.dtype, shift: float,
                extra_narrow: torch.Tensor):
    """The refinement's wide A x (x f64): from the NARROW coefficients,
    widened inside the K1 or K7 kernel, exactly; with R, T - R in f64
    throughout, through K6's f64 matvec mode on f64 copies of T's legs (the
    shift and the extra diagonal folded in) and of R, made here once."""
    field, wide = sys_.field, torch.float64
    if sys_.redi is None:
        c_narrow = sys_.coeffs.to(narrow_vec)
        return lambda x: shift * x + extra_narrow.to(wide) * x + field.apply(c_narrow, x)
    legs = sys_.coeffs.to(wide)
    legs = legs._replace(diag=shift + extra_narrow.to(wide) + legs.diag)
    redi = sys_.redi.to(wide)
    return lambda x: _matvec(legs, redi, x, sys_.topology)


def _ir_defect(field: _Field, apply_wide, x: torch.Tensor, b_narrow: torch.Tensor,
               bnorm_safe: float, redi: bool = False):
    """One wide defect r = b - A x (`_wide_apply`), and its normalised
    form: returns (r / s, s, s / ||b||) with s = ||r|| (1 where r == 0)."""
    with span("ir.defect", redi=redi):
        r = b_narrow.to(x.dtype) - apply_wide(x)
        s = field.norm(r)
        s_safe = s if s != 0 else 1.0
        return r / s_safe, s_safe, s / bnorm_safe


@traced
def solve_shifted_ir(coeffs: StencilCoeffs, b: torch.Tensor, topology: GridTopology,
                     shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                     tol: float = 1e-9, inner_tol: float = 1e-4,
                     max_refinements: int = 10, maxiter: int = 2000,
                     inner_maxiter: int | None = None, transpose: bool = False,
                     preconditioner: str = "tridiag", stats: dict | None = None,
                     inner_algorithm: str = "bicgstab", grid=None,
                     redi: RediOperator | None = None):
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

    `redi` (`solve_shifted_chunked` documents it) refines (shift * I +
    D_extra + T - R) x = b: the inner solves take K6's matvec mode in the
    coefficients' precision (K1 and K6 beside each other in the bf16-narrow
    mode), and each defect applies T - R in f64 through K6's f64 matvec
    mode, on f64 copies of T's legs and of R made once a solve.

    `inner_algorithm`: "bicgstab" runs each pass under `solve_shifted`'s
    rules (no stall stop, no restarts); "bicgstab2" under
    `solve_shifted_chunked`'s with max_restarts=0 (the outer loop is the
    restart), with a pass budget of min(maxiter, 600) matvec pairs unless
    `inner_maxiter` says otherwise; "gmres" under `solve_shifted_chunked`'s
    (GMRES(30) with its stall stop), with a budget of min(maxiter, 1200)
    Arnoldi steps, the matvecs of 600 BiCGStab(2) pairs. In the bf16-narrow
    mode every algorithm keeps f32 vectors.

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

    The solve builds one system, which its passes and defects share: T'
    formed once, the Thomas factor made once, one graphed BiCGStab(1) loop
    on the card (`_System.loops`), and on a process grid one set of halo
    plans.

    `stats`, if a dict, receives ``passes`` (one dict per pass: rel_start,
    reverted, inner_tol, inner_iters, inner_stop, inner_restarts,
    inner_end_rel, inner_chunk_s, wall_s), ``refinements`` and
    ``rel_final``. ``wall_s`` is the `ir.pass` span's length on the wall
    clock (`time.time_ns()`, which a clock step moves)."""
    if inner_algorithm not in ALGORITHMS:
        raise ValueError(f"unknown inner_algorithm {inner_algorithm!r}")
    wide = torch.float64
    # bf16-narrow mode (the JAX package's `narrow_vec`): bf16 coefficients
    # stream into the inner matvecs, while b, the Krylov vectors and M stay
    # f32; the f64 defect reads the coefficients widened to f32 (exactly).
    narrow_vec = torch.float32 if coeffs.diag.dtype == torch.bfloat16 else coeffs.diag.dtype
    sys_ = _system(coeffs, narrow_vec, topology, shift, extra_diag, transpose, preconditioner,
                   grid, redi=redi)
    field, with_redi = sys_.field, sys_.redi is not None
    # a pass's rules: `solve_shifted`'s for BiCGStab(1), else those of
    # `solve_shifted_chunked` (stall stop, jittered restarts)
    chunked = inner_algorithm != "bicgstab"
    if inner_maxiter is None:
        inner_maxiter = {"bicgstab2": min(maxiter, 600),
                         "gmres": min(maxiter, 1200)}.get(inner_algorithm, maxiter)
    else:
        inner_maxiter = min(maxiter, inner_maxiter)

    extra_n = torch.zeros((), dtype=b.dtype, device=b.device) if extra_diag is None else extra_diag
    apply_wide = _wide_apply(sys_, narrow_vec, shift, extra_n)
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
        with span("ir.pass", redi=with_redi, **{"pass": pass_i}) as this_pass:
            if pass_i == 0:
                # x == 0, so the defect is b: no wide apply needed.
                r_hat, s_safe, rel = b_nv / bnorm_safe, bnorm_safe, bn_n / bnorm_safe
            else:
                r_hat, s_safe, rel = _ir_defect(field, apply_wide, x, b, bnorm_safe, with_redi)
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
                r_hat, s_safe, rel = _ir_defect(field, apply_wide, x, b, bnorm_safe, with_redi)
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
            d, _ = _solve(sys_, rhs, tol=pass_tol, maxiter=inner_maxiter,
                          algorithm=inner_algorithm, early_stop=chunked, max_restarts=0,
                          max_diverge_restarts=2 if chunked else 0, stats=inner)
            del rhs
            x = x + s_safe * d.to(wide)
            entry.update(inner_tol=pass_tol, inner_iters=inner["iters"],
                         inner_stop=inner["stop"], inner_restarts=inner["restarts"],
                         inner_end_rel=inner["end_rel"], inner_chunk_s=inner["chunk_s"])
            this_pass.attrs.update(reverted=reverted, inner_iters=inner["iters"])
        entry["wall_s"] = this_pass.seconds
    else:
        _, _, rel = _ir_defect(field, apply_wide, x, b, bnorm_safe, with_redi)
        if rel < best_rel:
            best_rel, best_x = rel, x
    if best_x is not None and best_rel < rel:
        # the f32-rounded recovery point: keep it only if it really is better
        x_cand = best_x.to(wide)
        _, _, rel_cand = _ir_defect(field, apply_wide, x_cand, b, bnorm_safe, with_redi)
        if rel_cand < rel:
            x, rel = x_cand, rel_cand
    if stats is not None:
        stats.update(refinements=len(pass_log), rel_final=rel)
    return x, rel


def _steady_state(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
                  surface_rate: float, tol: float, refine: bool, algorithm: str,
                  transpose: bool, stats: dict | None, grid=None, redi=None):
    """(T + M) x = 1 (T' when `transpose`, T - R with `redi`) on wet cells,
    M = surface_rate on the surface layer; NaN on land. On a process grid,
    on the rank's shard."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    wet = wet3d.to(torch.bool)
    ones = wet.to(coeffs.diag.dtype)
    surf = torch.zeros_like(ones)
    surf[0] = surface_rate
    surf = torch.where(wet, surf, 0.0)
    kw = dict(extra_diag=surf, tol=tol, transpose=transpose, stats=stats, grid=grid, redi=redi)
    if refine:
        x, res = solve_shifted_ir(coeffs, ones, topology, inner_algorithm=algorithm, **kw)
    elif algorithm == "bicgstab":
        x, res = solve_shifted(coeffs, ones, topology, **kw)
    else:
        x, res = solve_shifted_chunked(coeffs, ones, topology, algorithm=algorithm, **kw)
    return torch.where(wet, x, float("nan")), res


def ideal_age(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
              surface_rate: float = 1.0, tol: float = 1e-8, refine: bool = False,
              stats: dict | None = None, algorithm: str = "bicgstab", grid=None,
              redi: RediOperator | None = None):
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
    rank's shard of gamma (`parallel.solve_halo`).

    `redi` (a `RediOperator` on T's grid, in T's dtype and on T's device,
    such as `build_redi_operator`'s) solves the age with the neutral
    physics, (T - R + M) Gamma = 1: T from the GM-augmented transports, R
    the Redi isoneutral diffusion. On the card each matvec is one launch of
    K6's matvec mode (no K1), M's Thomas legs are T's vertical legs less
    R's pure vertical ones, and the refinement's f64 defects apply T - R
    through K6's f64 matvec mode (`solve_shifted_ir`). Not yet with
    `grid`."""
    with span("ideal_age", redi=redi is not None):
        return _steady_state(coeffs, wet3d, topology, surface_rate, tol, refine, algorithm,
                             False, stats, grid, redi)


@traced
def sequestration_time(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
                       surface_rate: float = 1.0, tol: float = 1e-8, refine: bool = False,
                       stats: dict | None = None, algorithm: str = "bicgstab", grid=None,
                       redi: RediOperator | None = None):
    """Mean sequestration time (seconds), the adjoint of the ideal age: the
    expected time for water at each cell to next reach the surface,
    (T' + M) Gamma_dagger = 1 on wet cells, through the stencil form of
    T' (`transpose_coeffs`). Arguments and returns as `ideal_age`, `grid`
    included; `redi` (T' - R') raises ValueError: not yet supported."""
    _not_yet("sequestration_time", redi)
    return _steady_state(coeffs, wet3d, topology, surface_rate, tol, refine, algorithm,
                         True, stats, grid)


@traced
def solve_shifted_chunked_multi(coeffs: StencilCoeffs, bs: torch.Tensor,
                                topology: GridTopology, shift: float = 0.0,
                                extra_diag: torch.Tensor | None = None, tol: float = 1e-10,
                                maxiter: int = 2000, chunk: int = CHUNK,
                                transpose: bool = False, preconditioner: str = "tridiag",
                                verbose: bool = False, early_stop: bool = True,
                                max_restarts: int = 2, algorithm: str = "bicgstab",
                                stats: dict | None = None, max_diverge_restarts: int = 2,
                                grid=None, redi: RediOperator | None = None):
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
      field's residuals, the same on every rank.
    - `redi` raises ValueError: a batch with R is not yet supported."""
    _not_yet("solve_shifted_chunked_multi", redi)
    _check(algorithm, bs, batch=True)
    sys_ = _system(coeffs, bs.dtype, topology, shift, extra_diag, transpose, preconditioner,
                   grid)
    return _solve(sys_, bs, tol, maxiter, algorithm, early_stop, max_restarts,
                  max_diverge_restarts, stats, chunk, verbose=verbose)


@traced
def solve_shifted_multi(coeffs: StencilCoeffs, bs: torch.Tensor, topology: GridTopology,
                        shift: float = 0.0, extra_diag: torch.Tensor | None = None,
                        tol: float = 1e-10, maxiter: int = 2000, transpose: bool = False,
                        preconditioner: str = "tridiag", stats: dict | None = None,
                        grid=None, redi: RediOperator | None = None):
    """`solve_shifted` for a batch `bs` (B, nz, ny, nx): one lockstep
    BiCGStab over all members, the engine without stall stops or
    restarts (`solve_shifted_chunked_multi` documents it, `grid` and
    `redi` included). Returns (xs, (B,) relative residuals)."""
    _not_yet("solve_shifted_multi", redi)
    _check("bicgstab", bs, batch=True)
    sys_ = _system(coeffs, bs.dtype, topology, shift, extra_diag, transpose, preconditioner,
                   grid)
    return _solve(sys_, bs, tol, maxiter, "bicgstab", early_stop=False, max_restarts=0,
                  max_diverge_restarts=0, stats=stats)


@traced
def water_mass_fractions(coeffs: StencilCoeffs, wet3d: torch.Tensor, topology: GridTopology,
                         region_masks, surface_rate: float = 1.0, tol: float = 1e-8,
                         preconditioner: str = "tridiag", algorithm: str = "bicgstab",
                         stats: dict | None = None, grid=None,
                         redi: RediOperator | None = None):
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
    and the whole field's residuals (`solve_shifted_chunked_multi`).
    `redi` raises ValueError: the dyes with R are not yet supported."""
    _not_yet("water_mass_fractions", redi)
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
