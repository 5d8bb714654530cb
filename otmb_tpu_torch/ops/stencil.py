"""K1 and K5: the 7-point stencil kernels — apply, fused Euler step,
propagation — for one tracer (K1) and for a batch of tracers (K5).

K1 replaces `otmb_tpu/ops/stencil_pallas.py` (`apply_stencil_pallas`,
`euler_step_pallas`, `euler_propagate_pallas`) with one CUDA kernel; K5
replaces its batched family (`apply_stencil_pallas_multi`,
`euler_step_pallas_multi`, `euler_propagate_pallas_multi`) with another;
both are in `csrc/stencil.cu`. A batch is (B, nz, ny, nx), batch-major as
in the JAX package, and K5 reads the coefficients once for all B members
and each member's chi once (tiles of columns walk the levels down, each
member's levels staged on chip): 7 + 2B streams instead of 9B. Member b of
K5's result equals K1 on member b, bit for bit.

Coefficient and value types (C, V) are one of (f32, f32), (bf16, f32),
(f32, f64), (f64, f64); the sum runs in V. (f32, f64) evaluates an f64
defect from an f32 operator without a wide copy of the coefficients.

A CUDA tensor always goes to the kernel, for every B >= 1, and a failure
raises. A CPU tensor takes the plain version, `ops.apply.apply_stencil`,
which broadcasts over a batch. `dt` is a run-time argument of the kernels.

The propagations take the Redi operator R (`models.redi.build_redi_operator`)
as `redi=`: each step is then chi <- chi - dt T chi + dt R chi (neutral
physics: T from the GM-augmented transports, R the isoneutral diffusion).
On the card a step is one launch, for one tracer and for a batch: K6's
step mode, which takes T's 7-point sum inside its walk and rounds as K1 or
K5 and then the Redi half did (the two-launch step's bits); on the CPU,
the plain versions composed. `redi=None` stays K1/K5. For that this module
depends on `models.redi` and `models.redi_kernel` (their public
`RediOperator`, `redi_apply`, `validate`, `step_entry` and `step`), which
import nothing of `ops.stencil`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..grid.topology import UNKNOWN, GridTopology
from ..models import redi_kernel
from ..models.redi import RediOperator, redi_apply
from ..utils.tracing import span
from .apply import apply_stencil
from .coeffs import StencilCoeffs

_ENTRY = {
    (torch.float32, torch.float32): "otmb_stencil_f32_f32",
    (torch.bfloat16, torch.float32): "otmb_stencil_bf16_f32",
    (torch.float32, torch.float64): "otmb_stencil_f32_f64",
    (torch.float64, torch.float64): "otmb_stencil_f64_f64",
}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_double, ctypes.c_void_p]
_MULTI_ENTRY = {key: name.replace("otmb_stencil_", "otmb_stencil_multi_")
                for key, name in _ENTRY.items()}
_MULTI_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_double, ctypes.c_void_p]


def _validate(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology,
              batched: bool = False) -> None:
    if topology.kind == UNKNOWN:
        raise ValueError("stencil: unknown grid topology")
    key = (coeffs.diag.dtype, chi.dtype)
    if key not in _ENTRY:
        raise TypeError(f"stencil: no kernel for (coefficients, values) = {key}; "
                        f"supported: {sorted(map(str, _ENTRY))}")
    shape = topology.shape3d
    if batched and (chi.ndim != 4 or chi.shape[0] < 1 or tuple(chi.shape[1:]) != shape):
        raise ValueError(f"stencil: chis has shape {tuple(chi.shape)}, expected "
                         f"(B, {', '.join(map(str, shape))}) with B >= 1")
    for name, t in (*zip(coeffs._fields, coeffs), ("chi", chi)):
        want = chi.dtype if name == "chi" else coeffs.diag.dtype
        if tuple(t.shape) != shape and not (batched and name == "chi"):
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
    """K1 on a (nz, ny, nx) chi, K5 on a (B, nz, ny, nx) batch."""
    nz, ny, nx = topology.shape3d
    key = (coeffs.diag.dtype, chi.dtype)
    fields = (*(leg.data_ptr() for leg in coeffs), chi.data_ptr(), out.data_ptr())
    sizes = (nz, ny, nx, int(topology.is_tripolar), int(dt is not None),
             0.0 if dt is None else float(dt))
    if chi.ndim == 4:
        _build.launch(_MULTI_ENTRY[key], _MULTI_ARGTYPES, chi.device, *fields, chi.shape[0],
                      *sizes)
    else:
        _build.launch(_ENTRY[key], _ARGTYPES, chi.device, *fields, *sizes)
    return out


def _run(coeffs, chi, topology, dt, batched=False):
    _validate(coeffs, chi, topology, batched)
    if chi.is_cuda:
        return _launch(coeffs, chi, topology, dt, torch.empty_like(chi))
    return _plain(coeffs, chi, topology, dt)


def stencil_apply(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology):
    """y = T @ chi (the kernel of `apply_stencil_pallas`)."""
    return _run(coeffs, chi, topology, None)


def euler_step(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float, topology: GridTopology):
    """chi - dt * T @ chi in one pass (the kernel of `euler_step_pallas`)."""
    return _run(coeffs, chi, topology, dt)


def _propagate(coeffs, chi, dt, nsteps, topology, batched, redi=None):
    _validate(coeffs, chi, topology, batched)
    if redi is not None:
        redi_kernel.validate(redi, chi, batched, topology)
        redi_kernel.step_entry(coeffs.diag.dtype, redi.ae.dtype, chi.dtype)
    if not chi.is_cuda:
        for _ in range(int(nsteps)):
            nxt = _plain(coeffs, chi, topology, dt)
            chi = nxt if redi is None else nxt + dt * redi_apply(redi, chi)
        return chi
    buffers = [torch.empty_like(chi), torch.empty_like(chi) if nsteps > 1 else None]
    for step in range(int(nsteps)):
        out = buffers[step % 2]
        if redi is None:
            _launch(coeffs, chi, topology, dt, out)
        else:
            redi_kernel.step(coeffs, redi, chi, out, dt, batched)
        chi = out
    return chi


def euler_propagate(coeffs: StencilCoeffs, chi: torch.Tensor, dt: float, nsteps: int,
                    topology: GridTopology, redi: RediOperator | None = None):
    """nsteps of chi - dt * T @ chi; on the card, one launch per step into
    two alternating buffers. With `redi` (a RediOperator on T's grid), each
    step is chi - dt * T @ chi + dt * R chi, one launch of K6's step mode."""
    with span("euler_propagate", redi=redi is not None, steps=int(nsteps)):
        return _propagate(coeffs, chi, dt, nsteps, topology, False, redi)


def stencil_apply_multi(coeffs: StencilCoeffs, chis: torch.Tensor, topology: GridTopology):
    """y[b] = T @ chis[b] for a batch (B, nz, ny, nx) in one K5 launch (the
    kernel of `apply_stencil_pallas_multi`)."""
    return _run(coeffs, chis, topology, None, batched=True)


def euler_step_multi(coeffs: StencilCoeffs, chis: torch.Tensor, dt: float,
                     topology: GridTopology):
    """chis - dt * T @ chis for a batch in one K5 launch (the kernel of
    `euler_step_pallas_multi`)."""
    return _run(coeffs, chis, topology, dt, batched=True)


def euler_propagate_multi(coeffs: StencilCoeffs, chis: torch.Tensor, dt: float, nsteps: int,
                          topology: GridTopology, redi: RediOperator | None = None):
    """nsteps of the batched Euler step (`euler_propagate_pallas_multi`); on
    the card, one K5 launch per step into two alternating buffers. With
    `redi`, each step adds dt * R chis[b] to every member: one launch of
    K6's step mode a step, which reads T's legs and R's coefficients once
    for the batch."""
    with span("euler_propagate_multi", redi=redi is not None, steps=int(nsteps)):
        return _propagate(coeffs, chis, dt, nsteps, topology, True, redi)
