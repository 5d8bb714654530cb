"""K3: the fused Krylov step of the BiCGStab(2) engine.

Replaces `otmb_tpu/ops/krylov_pallas.py:fused_krylov_step` with the CUDA
kernel `csrc/krylov.cu`. One call computes

    z   = x1 + c2 * x2       (only with_combine; z is x1 itself otherwise)
    out = A(M(z))            (A: 7-point stencil on `a_coeffs`, whose
                              diagonal already holds shift + extra_diag;
                              M: Thomas solve on m_lower/m_diag/m_upper,
                              m_diag already guarded: 0 -> 1 on land)
    d   = <rhat, out>        (only with_dot; None otherwise)

and returns (z, out, d). All fields are (nz, ny, nx) of one dtype, f32 or
f64; c2 is a number or a 0-d tensor and d a 0-d tensor of that dtype, so
the engine never reads a scalar back to the host between steps.

A CUDA tensor always goes to the kernel, whose z and out equal the
composition of the port's own kernels, stencil_apply(a, tridiag_solve(...,
x1 + c2 * x2)), bit for bit, and whose d is summed in f64 in a fixed order
(the same bits on every run). A CPU tensor takes the plain version,
`fused_krylov_step_plain`. Missing neighbours read 0, as in K1 and the
plain apply_stencil; the Pallas kernel instead clamps k+1 at the floor and
reads row ny-1 itself above a bipolar top row, which real operators never
see (their legs are 0 there).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..grid.topology import UNKNOWN, GridTopology
from .apply import apply_stencil
from .coeffs import StencilCoeffs
from .krylov_algebra import dot64
from .tridiag import tridiag_factor, tridiag_solve_plain

#: Kernel launches made by this module's wrappers.
LAUNCHES = 0

#: Columns each thread block owns along i and j (kTI, kTJ in csrc/krylov.cu).
TILE_I, TILE_J = 254, 2

_ENTRY = {torch.float32: "otmb_krylov_f32", torch.float64: "otmb_krylov_f64"}
_ARGTYPES = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class KrylovScratch(NamedTuple):
    """What one solve's half-steps share: the factorization of M (cp and
    rden = 1/denom of the Thomas forward sweep), the dp field of each
    step's sweep, the per-block partial sums of the dot (f64), and `legs`,
    which identifies the Thomas legs the factorization belongs to."""

    cp: torch.Tensor
    rden: torch.Tensor
    dp: torch.Tensor
    partials: torch.Tensor
    legs: tuple


def _legs_key(m_legs) -> tuple:
    return tuple((t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device) for t in m_legs)


def krylov_scratch(m_lower: torch.Tensor, m_diag: torch.Tensor, m_upper: torch.Tensor,
                   factor: tuple[torch.Tensor, torch.Tensor] | None = None) -> KrylovScratch:
    """The scratch of `fused_krylov_step` on these Thomas legs: M's factor
    (`factor`, K2's (cp, rden) of the same legs, or one `tridiag_factor`
    launch here) and the rest, allocated. Do it once per solve and pass the
    result to every step of the solve."""
    m_legs = (m_lower, m_diag, m_upper)
    for name, t in zip(("m_lower", "m_diag", "m_upper"), m_legs):
        if t.dtype not in _ENTRY:
            raise TypeError(f"krylov_scratch: no kernel for {t.dtype}")
        if t.ndim != 3 or t.shape != m_diag.shape or t.dtype != m_diag.dtype \
                or t.device != m_diag.device or not t.is_contiguous():
            raise ValueError(f"krylov_scratch: {name} must be a contiguous (nz, ny, nx) "
                             f"tensor of m_diag's dtype and device")
    nz, ny, nx = m_diag.shape
    nblocks = -(-nx // TILE_I) * -(-ny // TILE_J)
    partials = torch.empty(nblocks, dtype=torch.float64, device=m_diag.device)
    cp, rden = tridiag_factor(*m_legs) if factor is None else factor
    return KrylovScratch(cp, rden, torch.empty_like(m_diag), partials, _legs_key(m_legs))


def fused_krylov_step_plain(a_coeffs: StencilCoeffs, m_lower, m_diag, m_upper, x1, x2, c2,
                            rhat, topology: GridTopology, with_combine: bool = True,
                            with_dot: bool = True):
    """The kernel's plain version: the port's plain Thomas solve, then the
    plain stencil apply, then an f64 dot rounded to x1's dtype (as the
    kernel does)."""
    if with_combine:
        z = x1 + torch.as_tensor(c2, dtype=x1.dtype, device=x1.device) * x2
    else:
        z = x1
    out = apply_stencil(a_coeffs, tridiag_solve_plain(m_lower, m_diag, m_upper, z), topology)
    return z, out, (dot64(rhat, out).to(x1.dtype) if with_dot else None)


def _validate(a_coeffs, m_legs, x1, x2, rhat, topology, with_combine, with_dot):
    if topology.kind == UNKNOWN:
        raise ValueError("fused_krylov_step: unknown grid topology")
    if x1.dtype not in _ENTRY:
        raise TypeError(f"fused_krylov_step: no kernel for {x1.dtype}; "
                        f"supported: {sorted(map(str, _ENTRY))}")
    shape = topology.shape3d
    fields = [*zip(a_coeffs._fields, a_coeffs), *zip(("m_lower", "m_diag", "m_upper"), m_legs),
              ("x1", x1)]
    if with_combine:
        fields.append(("x2", x2))
    if with_dot:
        fields.append(("rhat", rhat))
    for name, t in fields:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fused_krylov_step: {name} is {type(t).__name__}, not a tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_krylov_step: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != x1.dtype:
            raise TypeError(f"fused_krylov_step: {name} is {t.dtype}, x1 is {x1.dtype}")
        if t.device != x1.device:
            raise ValueError(f"fused_krylov_step: {name} is on {t.device}, x1 on {x1.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_krylov_step: {name} is not contiguous")


def fused_krylov_step(a_coeffs: StencilCoeffs, m_lower: torch.Tensor, m_diag: torch.Tensor,
                      m_upper: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor | None, c2,
                      rhat: torch.Tensor | None, topology: GridTopology,
                      with_combine: bool = True, with_dot: bool = True,
                      scratch: KrylovScratch | None = None):
    """One fused Krylov half-step; returns (z, out, d) as described in the
    module docstring. `scratch`, from `krylov_scratch` on the same Thomas
    legs, carries M's factorization from step to step; without it the call
    factors M itself. The plain version ignores it."""
    global LAUNCHES
    m_legs = (m_lower, m_diag, m_upper)
    _validate(a_coeffs, m_legs, x1, x2, rhat, topology, with_combine, with_dot)
    if not x1.is_cuda:
        return fused_krylov_step_plain(a_coeffs, m_lower, m_diag, m_upper, x1, x2, c2, rhat,
                                       topology, with_combine, with_dot)
    if scratch is None:
        scratch = krylov_scratch(*m_legs)
    elif scratch.legs != _legs_key(m_legs):
        raise ValueError("fused_krylov_step: scratch was factored for other Thomas legs")
    nz, ny, nx = topology.shape3d
    c2_t = (torch.as_tensor(c2, dtype=x1.dtype, device=x1.device).reshape(())
            if with_combine else None)
    z = torch.empty_like(x1) if with_combine else x1
    out = torch.empty_like(x1)
    d = torch.empty((), dtype=x1.dtype, device=x1.device) if with_dot else None
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch(
        _ENTRY[x1.dtype], _ARGTYPES, x1.device,
        *(leg.data_ptr() for leg in a_coeffs), m_upper.data_ptr(), scratch.cp.data_ptr(),
        scratch.rden.data_ptr(), x1.data_ptr(), ptr(x2 if with_combine else None), ptr(c2_t),
        ptr(rhat if with_dot else None), ptr(z if with_combine else None), out.data_ptr(),
        scratch.dp.data_ptr(), scratch.partials.data_ptr(), ptr(d), scratch.partials.numel(),
        nz, ny, nx, int(topology.is_tripolar), int(with_combine), int(with_dot),
    )
    LAUNCHES += 1
    return z, out, d
