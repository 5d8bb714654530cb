"""Numerical debugging helpers.

Counterpart of `otmb_tpu.utils.debugging`: a NaN-debugging switch and an
operator validator that encodes the reference test-suite's structural
checks (test/online.jl:97-123).
"""

from __future__ import annotations

import dataclasses

import torch

from ..grid.topology import GridTopology
from ..ops.apply import operator_diagnostics
from ..ops.coeffs import StencilCoeffs

#: When set, the Krylov engine (`models/solvers.py`) raises
#: FloatingPointError at the first non-finite value it reads to the host.
NAN_DEBUG = False


def enable_nan_debugging(enable: bool = True) -> None:
    """Make the Krylov engine raise FloatingPointError at the first
    non-finite residual (or GMRES Hessenberg entry) it reads. jax's
    `jax_debug_nans`, which the JAX package sets here, checks every jitted
    operation; torch has no such switch (`torch.autograd.detect_anomaly`
    watches backward passes only), so this flag covers the reads of the
    engine and the refinement (`models/solvers.py:_read`: residuals, norms,
    GMRES's Hessenberg matrix), and costs nothing between them."""
    global NAN_DEBUG
    NAN_DEBUG = bool(enable)


@dataclasses.dataclass(frozen=True)
class OperatorValidation:
    finite: bool
    diag_positive: bool  # diag > 0 on wet cells (upwind sign structure)
    offdiag_nonpositive: bool  # all neighbour legs <= 0
    land_zero: bool  # land cells carry exact zeros
    tau_div_s: float
    tau_vol_s: float

    @property
    def ok_upwind(self) -> bool:
        return (self.finite and self.diag_positive and self.offdiag_nonpositive
                and self.land_zero)


def validate_operator(coeffs: StencilCoeffs, v3d: torch.Tensor, wet3d: torch.Tensor,
                      topology: GridTopology) -> OperatorValidation:
    """Structural checks from the reference test-suite
    (test/online.jl:97-123), on the device of the coefficients: finiteness,
    upwind sign structure (diag > 0, off-diagonals <= 0), exact zeros on
    land, and the divergence / volume-conservation timescales."""
    wet = wet3d.to(torch.bool)
    legs = dict(zip(coeffs._fields, coeffs))
    finite = all(bool(torch.isfinite(a).all()) for a in legs.values())
    diag_positive = bool((legs["diag"][wet] > 0).all())
    offdiag_nonpositive = all(bool((a[wet] <= 0).all())
                              for name, a in legs.items() if name != "diag")
    land_zero = all(bool((a[~wet] == 0).all()) for a in legs.values())
    diags = operator_diagnostics(coeffs, v3d, wet, topology)
    return OperatorValidation(
        finite=finite,
        diag_positive=diag_positive,
        offdiag_nonpositive=offdiag_nonpositive,
        land_zero=land_zero,
        tau_div_s=float(diags["tau_div_s"]),
        tau_vol_s=float(diags["tau_vol_s"]),
    )
