"""Plain PyTorch application of the stencil operator.

    y[c] = diag[c] * x[c] + sum_d coef[d][c] * x[neighbor_d(c)]

This is the plain version of the K1 stencil kernel (`ops/stencil.py`),
which the kernel is held against, and the path every CPU tensor takes.
Missing neighbours read 0 (no clamped read), so coefficients at the
boundary need not be zero.
"""

from __future__ import annotations

import torch

from ..grid.topology import DIRECTIONS, GridTopology, neighbor_values, scatter_to_neighbor
from .coeffs import StencilCoeffs


def apply_stencil(coeffs: StencilCoeffs, chi: torch.Tensor, topology: GridTopology):
    """y = T @ chi on dense (nz, ny, nx) fields, accumulated in chi's dtype
    (coefficients are widened to it first). `chi` must be finite on land:
    a zero coefficient does not mask a NaN."""
    acc = coeffs.diag.to(chi.dtype) * chi
    for d in DIRECTIONS:
        acc = acc + coeffs[d].to(chi.dtype) * neighbor_values(chi, d, topology, fill=0.0)
    return acc


def apply_stencil_transpose(coeffs: StencilCoeffs, chi: torch.Tensor,
                            topology: GridTopology):
    """y = T' @ chi: each leg scatters instead of gathers,
    (T' x)[c] = diag[c] x[c] + sum_d sum_{j : nb_d(j) = c} coef_d[j] x[j]."""
    acc = coeffs.diag.to(chi.dtype) * chi
    for d in DIRECTIONS:
        acc = acc + scatter_to_neighbor(coeffs[d].to(chi.dtype) * chi, d, topology)
    return acc


def transpose_coeffs(coeffs: StencilCoeffs, topology: GridTopology) -> StencilCoeffs:
    """The stencil form of T', so the forward apply (and its kernel) runs
    adjoint problems: apply_stencil(transpose_coeffs(c), x) ==
    apply_stencil_transpose(c, x).

    The leg multiplying x[nb_d(c)] in T' is the opposite leg gathered from
    the d-neighbour. At the tripolar seam the fold is its own inverse, so
    the top row's north' leg gathers coeffs.north across the fold."""
    nv = lambda a, d: neighbor_values(a, d, topology, fill=0.0)
    north = nv(coeffs.south, "north")
    if topology.is_tripolar:
        north = torch.cat([north[:, :-1, :], nv(coeffs.north, "north")[:, -1:, :]], dim=1)
    return StencilCoeffs(
        diag=coeffs.diag,
        east=nv(coeffs.west, "east"),
        west=nv(coeffs.east, "west"),
        north=north,
        south=nv(coeffs.north, "south"),
        top=nv(coeffs.bottom, "top"),
        bottom=nv(coeffs.top, "bottom"),
    )


def operator_diagnostics(coeffs: StencilCoeffs, v3d: torch.Tensor, wet3d: torch.Tensor,
                         topology: GridTopology) -> dict:
    """Divergence / volume-conservation timescales in seconds
    (reference test/online.jl:106-117), over wet cells with 2-norms:
      tau_div = ||1|| / ||T 1||,  tau_vol = ||v|| / ||T' v||."""
    wet = wet3d.to(torch.bool)
    dtype = coeffs.diag.dtype
    nwet = wet.sum().to(dtype)

    ones = torch.where(wet, 1.0, 0.0).to(dtype)
    t_ones = apply_stencil(coeffs, ones, topology)
    tau_div = torch.sqrt(nwet) / torch.linalg.vector_norm(torch.where(wet, t_ones, 0.0))

    v = torch.where(wet, v3d, 0.0).to(dtype)
    tt_v = apply_stencil_transpose(coeffs, v, topology)
    tau_vol = torch.linalg.vector_norm(v) / torch.linalg.vector_norm(torch.where(wet, tt_v, 0.0))
    return {"tau_div_s": tau_div, "tau_vol_s": tau_vol}
