"""otmb_tpu_torch — the ocean transport-operator engine on PyTorch and CUDA.

The port of `otmb_tpu` (JAX/Pallas) to one NVIDIA H100. Grid metrics,
fluxes and the seven-leg stencil operator are plain PyTorch on the device
of the input tensors; the hot kernels are hand-written CUDA for sm_90a,
built from `csrc/` at first use:

  * K1 `stencil_apply` / `euler_step` / `euler_propagate` — the 7-point
    stencil (csrc/stencil.cu);
  * K5 `stencil_apply_multi` / `euler_step_multi` / `euler_propagate_multi`
    — the same for a batch of tracers that share one read of the
    coefficients; the matvec of the batched solves `solve_shifted_multi`,
    `solve_shifted_chunked_multi` and `water_mass_fractions`
    (csrc/stencil.cu);
  * K2 `tridiag_solve` — the per-column Thomas solve that preconditions
    the Krylov solves, for one field or a batch (csrc/tridiag.cu);
  * K3 `fused_krylov_step` — the fused half-step of the BiCGStab(2)
    engine: combination, Thomas solve, stencil and dot in one pass
    (csrc/krylov.cu);
  * K4 `assemble_T` — the fused assembly of T from raw transports
    (csrc/assemble.cu);
  * K10 `dma_peak_probe` — the many-stream bandwidth probe
    (csrc/probe.cu).

A CUDA tensor always goes to the kernel; a CPU tensor takes the kernel's
plain PyTorch version. This package never imports jax or otmb_tpu.
"""

from .config import (
    EARTH_RADIUS,
    KAPPA_H_DEFAULT,
    KAPPA_VDEEP_DEFAULT,
    KAPPA_VML_DEFAULT,
    RHO_DEFAULT,
    TransportConfig,
)
from .grid.geometry import GridMetrics, PerDirection, makegridmetrics
from .grid.indices import Indices, as2d, as3d, makeindices, wet_vector
from .grid.topology import GridTopology, detect_topology
from .models.solvers import (
    explicit_euler_propagate,
    explicit_euler_step,
    ideal_age,
    sequestration_time,
    solve_shifted,
    solve_shifted_chunked,
    solve_shifted_chunked_multi,
    solve_shifted_ir,
    solve_shifted_multi,
    water_mass_fractions,
)
from .models.transport import TransportOperators, assemble_transport, transportmatrix
from .ops.apply import (
    apply_stencil,
    apply_stencil_transpose,
    operator_diagnostics,
    transpose_coeffs,
)
from .ops.assemble import assemble_T
from .ops.coeffs import StencilCoeffs, add_coeffs
from .ops.fluxes import FaceFluxes, facefluxes, facefluxesfrommasstransport
from .ops.krylov import fused_krylov_step
from .ops.stencil import (
    euler_propagate,
    euler_propagate_multi,
    euler_step,
    euler_step_multi,
    stencil_apply,
    stencil_apply_multi,
)
from .ops.tridiag import tridiag_solve
from .utils.profiling import dma_peak_probe
from .utils.sparse_export import coeffs_to_scipy
from .utils.synthetic import synthetic_dataset

__all__ = [
    "EARTH_RADIUS",
    "FaceFluxes",
    "GridMetrics",
    "GridTopology",
    "Indices",
    "KAPPA_H_DEFAULT",
    "KAPPA_VDEEP_DEFAULT",
    "KAPPA_VML_DEFAULT",
    "PerDirection",
    "RHO_DEFAULT",
    "StencilCoeffs",
    "TransportConfig",
    "TransportOperators",
    "add_coeffs",
    "apply_stencil",
    "apply_stencil_transpose",
    "as2d",
    "as3d",
    "assemble_T",
    "assemble_transport",
    "coeffs_to_scipy",
    "detect_topology",
    "dma_peak_probe",
    "euler_propagate",
    "euler_propagate_multi",
    "euler_step",
    "euler_step_multi",
    "explicit_euler_propagate",
    "explicit_euler_step",
    "facefluxes",
    "facefluxesfrommasstransport",
    "fused_krylov_step",
    "ideal_age",
    "makegridmetrics",
    "makeindices",
    "operator_diagnostics",
    "sequestration_time",
    "solve_shifted",
    "solve_shifted_chunked",
    "solve_shifted_chunked_multi",
    "solve_shifted_ir",
    "solve_shifted_multi",
    "stencil_apply",
    "stencil_apply_multi",
    "synthetic_dataset",
    "transportmatrix",
    "transpose_coeffs",
    "tridiag_solve",
    "water_mass_fractions",
    "wet_vector",
]
