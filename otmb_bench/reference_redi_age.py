"""The plain reference of the neutral physics' steady states: (T - R + M) x
in float64, T from `reference.py`'s seven legs, R `reference_neutral.py`'s
face-by-face Redi operator, M a diagonal (the surface restoring), and the
largest cell's residual of a steady state against it.

Independent of the program: it imports nothing of it (nor JAX) and takes
nothing the program made.
"""

from __future__ import annotations

import torch

from . import reference
from .reference_neutral import Redi


def apply(legs: dict, redi: Redi, x: torch.Tensor, extra: torch.Tensor,
          tripolar: bool) -> torch.Tensor:
    """(T - R + diag(extra)) x for one field (nz, ny, nx), in float64."""
    x = x.to(torch.float64)
    return reference.apply(legs, x, tripolar) - redi(x) + extra.to(torch.float64) * x


def largest_residual(legs: dict, redi: Redi, x: torch.Tensor, b: torch.Tensor,
                     extra: torch.Tensor, tripolar: bool) -> float:
    """max |(T - R + diag(extra)) x - b| over the cells, over max |b| (x and
    b zero on land): for the ideal age (b = 1 on wet cells) the largest
    cell's residual, relative to 1."""
    r = apply(legs, redi, x, extra, tripolar) - b.to(torch.float64)
    return float(r.abs().max() / b.to(torch.float64).abs().max())
