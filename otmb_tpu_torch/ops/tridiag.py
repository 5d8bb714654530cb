"""K2: per-column tridiagonal (Thomas) solve, the vertical-line
preconditioner of the Krylov solves.

Replaces `otmb_tpu/ops/tridiag_pallas.py:tridiag_solve_pallas` with the
CUDA kernels of `csrc/tridiag.cu`. For every (j, i) column it solves

    upper[k] * x[k-1] + diag[k] * x[k] + lower[k] * x[k+1] = b[k]

(`lower` couples to k+1 and `upper` to k-1: the `bottom`/`top` legs of a
StencilCoeffs). Land columns must arrive with a guarded diagonal
(0 -> 1). The legs are factored once (`tridiag_factor`: cp and rden =
1/denom of the forward sweep), and each right-hand side is then solved
against the factor (`tridiag_solve_factored`), as the solvers do;
`tridiag_solve` does both. The right-hand side is one field (nz, ny, nx)
or a batch (B, nz, ny, nx) that shares the legs, which the kernel solves
in one launch (the JAX package vmaps its kernel over the batch instead).
A CUDA tensor goes to the kernels, which equal the plain versions bit for
bit; a CPU tensor takes the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_FACTOR_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SOLVE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def tridiag_factor_plain(lower, diag, upper):
    """cp and rden of the Thomas forward sweep, in the operation order of
    `_tridiag_preconditioner` (otmb_tpu/models/solvers.py): denom = diag -
    upper*cp_prev, a denom of 0 replaced by 1, cp = lower/denom, rden =
    1/denom."""
    cps, rdens = [], []
    cp_prev = torch.zeros_like(diag[0])
    for k in range(diag.shape[0]):
        denom = diag[k] - upper[k] * cp_prev
        denom = torch.where(denom != 0, denom, 1.0)
        cp_prev = lower[k] / denom
        cps.append(cp_prev)
        rdens.append(torch.reciprocal(denom))
    return torch.stack(cps), torch.stack(rdens)


def tridiag_solve_factored_plain(cp, rden, upper, b):
    """The solve against a factor, vectorised over (ny, nx) and over the
    batch of a (B, nz, ny, nx) b: dp = (b - upper*dp_prev) * rden, then
    x = dp - cp*x_next. Every member's result is the unbatched one, bit for
    bit."""
    nz = cp.shape[0]
    dp_prev = torch.zeros_like(b[..., 0, :, :])
    dps = []
    for k in range(nz):
        dp_prev = (b[..., k, :, :] - upper[k] * dp_prev) * rden[k]
        dps.append(dp_prev)
    x = torch.empty_like(b)
    x_next = torch.zeros_like(dp_prev)
    for k in range(nz - 1, -1, -1):
        x_next = dps[k] - cp[k] * x_next
        x[..., k, :, :] = x_next
    return x


def tridiag_solve_plain(lower, diag, upper, b):
    """The Thomas algorithm in plain PyTorch: the factor, then the solve."""
    return tridiag_solve_factored_plain(*tridiag_factor_plain(lower, diag, upper), upper, b)


def _check(what: str, legs: dict, b: torch.Tensor | None = None) -> None:
    """The legs (nz, ny, nx) and b (nz, ny, nx) or (B, nz, ny, nx, B >= 1)
    share one dtype with a kernel and one device, and are contiguous."""
    fields = {**legs, **({} if b is None else {"b": b})}
    ref = next(iter(legs.values()))
    dtype = ref.dtype if b is None else b.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{what}: no kernel for {dtype}")
    if ref.ndim != 3 or ref.numel() == 0 or (b is not None and (b.ndim not in (3, 4) or b.numel() == 0)):
        raise ValueError(f"{what}: expected legs (nz, ny, nx) and b (nz, ny, nx) or "
                         f"(B, nz, ny, nx), got {tuple(ref.shape)}"
                         + ("" if b is None else f" and {tuple(b.shape)}"))
    for name, t in fields.items():
        shape = t.shape[-3:] if name == "b" else t.shape
        if shape != ref.shape or t.dtype != dtype or t.device != ref.device:
            raise ValueError(f"{what}: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {tuple(ref.shape)} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def tridiag_factor(lower: torch.Tensor, diag: torch.Tensor,
                   upper: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cp, rden) of the legs (nz, ny, nx), f32 or f64: one launch on the
    card. Factor once per system and solve each right-hand side with
    `tridiag_solve_factored` (K3 takes the same factor)."""
    _check("tridiag_factor", {"lower": lower, "diag": diag, "upper": upper})
    if not diag.is_cuda:
        return tridiag_factor_plain(lower, diag, upper)
    nz, ny, nx = diag.shape
    cp, rden = torch.empty_like(diag), torch.empty_like(diag)
    _build.launch(f"otmb_thomas_factor_{_SUFFIX[diag.dtype]}", _FACTOR_ARGTYPES, diag.device,
                  lower.data_ptr(), diag.data_ptr(), upper.data_ptr(), cp.data_ptr(),
                  rden.data_ptr(), nz, ny, nx)
    return cp, rden


def tridiag_solve_factored(cp: torch.Tensor, rden: torch.Tensor, upper: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """Solve every column against a factor from `tridiag_factor`; b is
    (nz, ny, nx) or a batch (B, nz, ny, nx) with B >= 1 (one launch, which
    reads the factor once for a group of members); all of one dtype on one
    device, contiguous."""
    _check("tridiag_solve_factored", {"cp": cp, "rden": rden, "upper": upper}, b)
    if not b.is_cuda:
        return tridiag_solve_factored_plain(cp, rden, upper, b)
    nz, ny, nx = cp.shape
    x = torch.empty_like(b)
    _build.launch(f"otmb_thomas_solve_{_SUFFIX[b.dtype]}", _SOLVE_ARGTYPES, b.device,
                  cp.data_ptr(), rden.data_ptr(), upper.data_ptr(), b.data_ptr(), x.data_ptr(),
                  nz, ny, nx, b.shape[0] if b.ndim == 4 else 1)
    return x


def tridiag_solve(lower: torch.Tensor, diag: torch.Tensor, upper: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Solve every column's tridiagonal system; legs (nz, ny, nx), b
    (nz, ny, nx) or a batch (B, nz, ny, nx) with B >= 1 that shares the legs;
    all of one dtype (f32 or f64) on one device, contiguous. Factors, then
    solves (two launches on the card)."""
    _check("tridiag_solve", {"lower": lower, "diag": diag, "upper": upper}, b)
    return tridiag_solve_factored(*tridiag_factor(lower, diag, upper), upper, b)
