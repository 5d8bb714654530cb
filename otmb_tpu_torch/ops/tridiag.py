"""K2: per-column tridiagonal (Thomas) solve, the vertical-line
preconditioner of the Krylov solves.

Replaces `otmb_tpu/ops/tridiag_pallas.py:tridiag_solve_pallas` with the
CUDA kernel `csrc/tridiag.cu`. For every (j, i) column it solves

    upper[k] * x[k-1] + diag[k] * x[k] + lower[k] * x[k+1] = b[k]

(`lower` couples to k+1 and `upper` to k-1: the `bottom`/`top` legs of a
StencilCoeffs). Land columns must arrive with a guarded diagonal
(0 -> 1). The right-hand side is one field (nz, ny, nx) or a batch
(B, nz, ny, nx) that shares the legs, which the kernel solves in one
launch (the JAX package vmaps its kernel over the batch instead). A CUDA
tensor goes to the kernel, which equals the plain version bit for bit; a
CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: Kernel launches made by this module's wrapper.
LAUNCHES = 0

_ENTRY = {torch.float32: "otmb_thomas_f32", torch.float64: "otmb_thomas_f64"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]


def tridiag_solve_plain(lower, diag, upper, b):
    """Thomas algorithm in plain PyTorch, vectorised over (ny, nx) and over
    the batch of a (B, nz, ny, nx) b, in the operation order of
    `_tridiag_preconditioner` (otmb_tpu/models/solvers.py): cp = lower/denom,
    dp = (b - upper*dp_prev) * (1/denom), denom 0 -> 1. cp depends on the
    legs only, so a batch computes it once; every member's result is the
    unbatched one, bit for bit."""
    nz = diag.shape[0]
    cp_prev = torch.zeros_like(diag[0])
    dp_prev = torch.zeros_like(b[..., 0, :, :])
    cps, dps = [], []
    for k in range(nz):
        denom = diag[k] - upper[k] * cp_prev
        denom = torch.where(denom != 0, denom, 1.0)
        cp_prev = lower[k] / denom
        dp_prev = (b[..., k, :, :] - upper[k] * dp_prev) * torch.reciprocal(denom)
        cps.append(cp_prev)
        dps.append(dp_prev)
    x = torch.empty_like(b)
    x_next = torch.zeros_like(dp_prev)
    for k in range(nz - 1, -1, -1):
        x_next = dps[k] - cps[k] * x_next
        x[..., k, :, :] = x_next
    return x


def tridiag_solve(lower: torch.Tensor, diag: torch.Tensor, upper: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Solve every column's tridiagonal system; legs (nz, ny, nx), b
    (nz, ny, nx) or a batch (B, nz, ny, nx) with B >= 1 that shares the legs
    (one launch); all of one dtype (f32 or f64) on one device, contiguous."""
    global LAUNCHES
    if b.dtype not in _ENTRY:
        raise TypeError(f"tridiag_solve: no kernel for {b.dtype}")
    if b.ndim not in (3, 4) or b.numel() == 0:
        raise ValueError(f"tridiag_solve: expected (nz, ny, nx) or (B, nz, ny, nx), got "
                         f"{tuple(b.shape)}")
    for name, t in (("lower", lower), ("diag", diag), ("upper", upper), ("b", b)):
        shape = b.shape if name == "b" else b.shape[-3:]
        if t.shape != shape or t.dtype != b.dtype or t.device != b.device:
            raise ValueError(f"tridiag_solve: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, b is {b.dtype} {tuple(b.shape)} on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"tridiag_solve: {name} is not contiguous")
    if not b.is_cuda:
        return tridiag_solve_plain(lower, diag, upper, b)
    nz, ny, nx = diag.shape
    nmembers = b.shape[0] if b.ndim == 4 else 1
    x = torch.empty_like(b)
    cp = torch.empty_like(b)
    _build.launch(_ENTRY[b.dtype], _ARGTYPES, b.device, lower.data_ptr(), diag.data_ptr(),
                  upper.data_ptr(), b.data_ptr(), x.data_ptr(), cp.data_ptr(), nz, ny, nx,
                  nmembers, diag.numel())
    LAUNCHES += 1
    return x
