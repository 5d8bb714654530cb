"""K1: the 7-point stencil kernel — apply, fused Euler step, propagation.

Replaces `otmb_tpu/ops/stencil_pallas.py` (`apply_stencil_pallas`,
`euler_step_pallas`, `euler_propagate_pallas`) with one CUDA kernel,
`csrc/stencil.cu`. Coefficient and value types (C, V) are one of
(f32, f32), (bf16, f32), (f32, f64), (f64, f64); the sum runs in V.
(f32, f64) evaluates an f64 defect from an f32 operator without a wide
copy of the coefficients.

A CUDA tensor always goes to the kernel, and a failure raises. A CPU
tensor takes the plain version, `ops.apply.apply_stencil`. `dt` is a
run-time argument of the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..grid.topology import UNKNOWN, GridTopology
from .apply import apply_stencil
from .coeffs import StencilCoeffs

#: Kernel launches made by this module's wrappers.
LAUNCHES = 0

_ENTRY = {
    (torch.float32, torch.float32): "otmb_stencil_f32_f32",
    (torch.bfloat16, torch.float32): "otmb_stencil_bf16_f32",
    (torch.float32, torch.float64): "otmb_stencil_f32_f64",
    (torch.float64, torch.float64): "otmb_stencil_f64_f64",
}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_double, ctypes.c_void_p]


def _validate(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology) -> None:
    if topology.kind == UNKNOWN:
        raise ValueError("stencil: unknown grid topology")
    key = (coeffs.diag.dtype, chi.dtype)
    if key not in _ENTRY:
        raise TypeError(f"stencil: no kernel for (coefficients, values) = {key}; "
                        f"supported: {sorted(map(str, _ENTRY))}")
    shape = topology.shape3d
    for name, t in (*zip(coeffs._fields, coeffs), ("chi", chi)):
        want = chi.dtype if name == "chi" else coeffs.diag.dtype
        if tuple(t.shape) != shape:
            raise ValueError(f"stencil: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != want:
            raise TypeError(f"stencil: {name} is {t.dtype}, expected {want}")
        if t.device != chi.device:
            raise ValueError(f"stencil: {name} is on {t.device}, chi on {chi.device}")
        if not t.is_contiguous():
            raise ValueError(f"stencil: {name} is not contiguous")


def _plain(coeffs, chi, topology, dt):
    y = apply_stencil(coeffs, chi, topology)
    return y if dt is None else chi - dt * y


def _launch(coeffs, chi, topology, dt, out):
    global LAUNCHES
    nz, ny, nx = topology.shape3d
    _build.launch(
        _ENTRY[(coeffs.diag.dtype, chi.dtype)], _ARGTYPES, chi.device,
        *(leg.data_ptr() for leg in coeffs), chi.data_ptr(), out.data_ptr(),
        nz, ny, nx, int(topology.is_tripolar), int(dt is not None),
        0.0 if dt is None else float(dt),
    )
    LAUNCHES += 1
    return out


def _run(coeffs, chi, topology, dt):
    _validate(coeffs, chi, topology)
    if chi.is_cuda:
        return _launch(coeffs, chi, topology, dt, torch.empty_like(chi))
    return _plain(coeffs, chi, topology, dt)


def stencil_apply(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology):
    """y = T @ chi (the kernel of `apply_stencil_pallas`)."""
    return _run(coeffs, chi, topology, None)


def euler_step(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float, topology: GridTopology):
    """chi - dt * T @ chi in one pass (the kernel of `euler_step_pallas`)."""
    return _run(coeffs, chi, topology, dt)


def euler_propagate(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float, nsteps: int,
                    topology: GridTopology):
    """nsteps of chi - dt * T @ chi; on the card, one launch per step into
    two alternating buffers."""
    _validate(coeffs, chi, topology)
    if not chi.is_cuda:
        for _ in range(int(nsteps)):
            chi = _plain(coeffs, chi, topology, dt)
        return chi
    buffers = [torch.empty_like(chi), torch.empty_like(chi) if nsteps > 1 else None]
    for step in range(int(nsteps)):
        chi = _launch(coeffs, chi, topology, dt, buffers[step % 2])
    return chi
