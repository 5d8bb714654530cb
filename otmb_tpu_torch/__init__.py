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
  * K2 `tridiag_solve` (`tridiag_factor`, once per system, then
    `tridiag_solve_factored`) — the per-column Thomas solve that
    preconditions the Krylov solves, for one field or a batch
    (csrc/tridiag.cu);
  * K3 `fused_krylov_step` — the fused half-step of the BiCGStab(2)
    engine: combination, Thomas solve, stencil and dot in one pass
    (csrc/krylov.cu);
  * K4 `assemble_T` — the fused assembly of T from raw transports
    (csrc/assemble.cu);
  * K6 `redi_apply_fused` / `redi_apply_fused_multi` — the 19-point Redi
    isoneutral-diffusion operator for one tracer or a batch
    (csrc/redi.cu), built by `build_redi_operator` from the density
    slopes of the TEOS-10 path (`rho_teos10`, `potential_density_slopes`,
    `add_bolus_transports`);
  * K10 `dma_peak_probe` — the many-stream bandwidth probe
    (csrc/probe.cu);
  * in `otmb_tpu_torch.parallel`, the multi-device layer on
    `torch.distributed` (a process grid of ranks, each holding one shard;
    a one-cell halo exchange with the tripolar fold): K7
    `stencil_apply_halo` / `euler_propagate_halo` and their `_multi` forms
    — K1 and K5 on a shard, the edge neighbours from halo lines
    (csrc/stencil.cu); K8 `assemble_T_halo` — K4 on a shard
    (csrc/assemble.cu); K9 `redi_apply_halo` — K6 on a shard
    (csrc/redi.cu); the Krylov solves on shards (`grid=` on
    `solve_shifted`, `solve_shifted_chunked`, `solve_shifted_ir`,
    `ideal_age`, `sequestration_time`; `solve_shifted_halo`).

The Krylov engine runs BiCGStab(1), BiCGStab(2) or GMRES(30)
(`algorithm=`) on those kernels, and `implicit_euler_step` on it. The
autodiff layer (`apply_stencil_ad`, `euler_step_ad`,
`differentiable_solve`) gives the kernels and the solves their backward
passes: K1 on T' and one transpose solve. Host tools: LUMP/SPRAY
coarsening (`lump_and_spray`, `ideal_age_coarsened`, with a C++ labelling
core built by g++), checkpoints, operator validation, CMIP ingestion
(`utils.io`), profiling (`utils.profiling`) and plots (`utils.plotting`).

A CUDA tensor always goes to the kernel; a CPU tensor takes the kernel's
plain PyTorch version. Entry points that make tensors from host data
(`makegridmetrics`, `dma_peak_probe`, the `utils.convert` helpers) make
them on the current CUDA device unless `device=` says otherwise, and raise
without one: pass `device="cpu"` for the CPU. This package never imports
jax or otmb_tpu.
"""

from .config import (
    EARTH_RADIUS,
    KAPPA_GM_DEFAULT,
    KAPPA_H_DEFAULT,
    KAPPA_VDEEP_DEFAULT,
    KAPPA_VML_DEFAULT,
    MAXSLOPE_DEFAULT,
    RHO_DEFAULT,
    SLOPE_TAPER_SC,
    SLOPE_TAPER_SD,
    TransportConfig,
)
from .grid.geometry import (
    GridMetrics,
    PerDirection,
    cell_thickness_from_lev_bnds,
    makegridmetrics,
)
from .grid.indices import Indices, as2d, as3d, makeindices, wet_vector
from .grid.topology import GridTopology, detect_topology
from .models.redi import (
    RediOperator,
    build_redi_operator,
    redi_apply,
    redi_max_rate,
    redi_operator_to_bf16,
)
from .models.redi_kernel import redi_apply_fused, redi_apply_fused_multi
from .models.redigm import (
    add_bolus_transports,
    bolus_gm_velocity,
    density_slopes,
    potential_density_slope,
    potential_density_slopes,
    slope_taper,
)
from .models.solvers import (
    explicit_euler_propagate,
    explicit_euler_step,
    ideal_age,
    implicit_euler_step,
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
from .ops.autodiff import apply_stencil_ad, differentiable_solve, euler_step_ad
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
from .ops.tridiag import tridiag_factor, tridiag_solve, tridiag_solve_factored
from .ops.velocities import (
    ArakawaGrid,
    facefluxesfromvelocities,
    fluxes2velocity,
    getarakawagrid,
    interpolateontodefaultCgrid,
    velocity2fluxes,
)
from .physics.eos import linear_eos, rho_teos10, sigma0_teos10
from .utils.checkpoint import load_operator, load_state, save_operator, save_state
from .utils.coarsen import ideal_age_coarsened, lump_and_spray
from .utils.debugging import OperatorValidation, enable_nan_debugging, validate_operator
from .utils.profiling import dma_peak_probe, roofline_report
from .utils.sparse_export import coeffs_to_scipy
from .utils.convert import redi_operator_from_numpy
from .utils.synthetic import synthetic_dataset

__all__ = [
    "ArakawaGrid",
    "EARTH_RADIUS",
    "FaceFluxes",
    "GridMetrics",
    "GridTopology",
    "Indices",
    "KAPPA_GM_DEFAULT",
    "KAPPA_H_DEFAULT",
    "KAPPA_VDEEP_DEFAULT",
    "KAPPA_VML_DEFAULT",
    "MAXSLOPE_DEFAULT",
    "OperatorValidation",
    "PerDirection",
    "RHO_DEFAULT",
    "RediOperator",
    "SLOPE_TAPER_SC",
    "SLOPE_TAPER_SD",
    "StencilCoeffs",
    "TransportConfig",
    "TransportOperators",
    "add_bolus_transports",
    "add_coeffs",
    "apply_stencil",
    "apply_stencil_ad",
    "apply_stencil_transpose",
    "as2d",
    "as3d",
    "assemble_T",
    "assemble_transport",
    "bolus_gm_velocity",
    "build_redi_operator",
    "cell_thickness_from_lev_bnds",
    "coeffs_to_scipy",
    "density_slopes",
    "detect_topology",
    "differentiable_solve",
    "dma_peak_probe",
    "enable_nan_debugging",
    "euler_propagate",
    "euler_propagate_multi",
    "euler_step",
    "euler_step_ad",
    "euler_step_multi",
    "explicit_euler_propagate",
    "explicit_euler_step",
    "facefluxes",
    "facefluxesfrommasstransport",
    "facefluxesfromvelocities",
    "fluxes2velocity",
    "fused_krylov_step",
    "getarakawagrid",
    "ideal_age",
    "ideal_age_coarsened",
    "implicit_euler_step",
    "interpolateontodefaultCgrid",
    "linear_eos",
    "load_operator",
    "load_state",
    "lump_and_spray",
    "makegridmetrics",
    "makeindices",
    "operator_diagnostics",
    "potential_density_slope",
    "potential_density_slopes",
    "redi_apply",
    "redi_apply_fused",
    "redi_apply_fused_multi",
    "redi_max_rate",
    "redi_operator_from_numpy",
    "redi_operator_to_bf16",
    "rho_teos10",
    "roofline_report",
    "save_operator",
    "save_state",
    "sequestration_time",
    "sigma0_teos10",
    "slope_taper",
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
    "tridiag_factor",
    "tridiag_solve",
    "tridiag_solve_factored",
    "validate_operator",
    "velocity2fluxes",
    "water_mass_fractions",
    "wet_vector",
]
