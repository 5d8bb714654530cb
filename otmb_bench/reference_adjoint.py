"""The plain reference of the adjoint problems: T' x from T's seven legs,
in float64, for the sequestration time's residual.

T' is T transposed as a matrix: (T' x)[c] = sum_r T[r, c] x[r]. Here each
row r's legs are scattered to the columns they multiply in T x (its
`d`-neighbour, the tripolar fold included), so T' needs no stencil form of
its own: a reference independent of the program's (`transpose_coeffs`),
built only on `reference.neighbour`'s map of neighbours.
"""

from __future__ import annotations

import torch

from .reference import DIRECTIONS, neighbour


def apply_transpose(legs: dict, x: torch.Tensor, tripolar: bool) -> torch.Tensor:
    """T' x for one field (nz, ny, nx), in float64."""
    x = x.to(torch.float64)
    n = x.numel()
    index = torch.arange(n, device=x.device).reshape(x.shape)
    out = legs["diag"].to(torch.float64) * x
    flat = out.reshape(-1)
    for d in DIRECTIONS:
        target = neighbour(index, d, tripolar, -1).reshape(-1)  # column of row r's d-leg
        value = (legs[d].to(torch.float64) * x).reshape(-1)
        has = target >= 0
        flat.index_add_(0, target[has], value[has])
    return out


def relative_residual_transpose(legs: dict, x: torch.Tensor, b: torch.Tensor,
                                extra: torch.Tensor, tripolar: bool,
                                ord: float = float("inf")) -> float:
    """||(T' + diag(extra)) x - b|| / ||b|| over the wet cells (x, b zero
    on land), in float64; by default the largest cell's."""
    x, b = x.to(torch.float64), b.to(torch.float64)
    r = apply_transpose(legs, x, tripolar) + extra.to(torch.float64) * x - b
    return float(torch.linalg.vector_norm(r, ord) / torch.linalg.vector_norm(b, ord))
