"""Smoke run of otmb_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels K1 (stencil), K2 (Thomas solve), K3 (fused Krylov
step), K4 (fused assembly), K5 (multi-tracer stencil), K6 (Redi operator,
one tracer or a batch), K7, K8 and K9 (the stencil, the assembly and Redi
on one shard of a process grid), K10 (bandwidth probe) and K11/K12 (the
BiCGStab(2) cycle's polish sums and polish update) from
otmb_tpu_torch/csrc, one nvcc per source in parallel (and, at its first
use, the coarsening's C++ labelling core with g++), then:

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions and the kernel build time;
  2. drives the main path at the ACCESS 1-degree size (360x300x50,
     tripolar, seed 0) through the public API, with the launch counts set
     to 0 just before: grid metrics -> indices -> face fluxes ->
     transportmatrix, the fused assembly (K4), 200 explicit Euler steps
     (K1) and the refined ideal age (K1 + K2, f64 defects through K1);
  3. checks that K1, K2 and K4 each launched during that run, then runs
     the same refined age on the bf16-rounded operator (the bf16-narrow
     mode: K1 in (bf16, f32), K2 on f32 legs), launches counted;
  4. holds each kernel against its plain PyTorch version at the main
     path's shapes, on both topologies, with the tolerances stated below,
     K2 on a batch of 3 against one launch per member, and K5 in every
     type pair at B = 4 and 8 against K1 per member and plain;
  5. holds the card's slice at the 18x14x6 test size against the golden
     operator and ages in tests/data/golden_tile.npz; then makes the 1-degree
     case on the card with synthetic_device_case (seed 0) and holds it to
     the host path's grid: topology and wet mask equal, v3d and z3d within
     f32 rounding;
  6. at 1 degree, the batched-tracer path through the public API, counts
     reset before and read after each run: 200 batched Euler steps of 8
     tracers (K5; each member equal to K1's propagation bit for bit), and
     the water-mass fractions of 4 latitude bands on the f32 K4 operator
     and on the f64 one (K5 + batched K2), with their residuals, bounds
     and linearity against the single-RHS all-surface dye solve;
  7. times each kernel and its plain version with CUDA events, and K5 at
     B = 1, 2, 4, 8 beside B launches of K1 and its plain version;
  8. at 1 degree, the refined sequestration time and the refined ideal age
     with BiCGStab(2) inner solves (K3 on T' and on T), counts reset
     before and read after;
  9. drives the 0.25-degree main path (1440x1080x75, tripolar, seed 0,
     f32): grid metrics -> assemble_T (K4 and its prep entry; that call
     timed with CUDA events and its kernels under torch.profiler) -> the
     refined ideal age with BiCGStab(2) inner solves on K3, each cycle
     ending in K11 and K12, and f64 defects through K1, counts reset before
     and read after (K11 and K12 required);
 10. holds K3 against the composition of the K2 and K1 kernels and its
     plain version at 0.25 degrees (tripolar) and 720x540x75 (bipolar),
     in f32 and f64, on T and T', for each use the engine makes of it,
     and K5 at B = 1, 5 and 8 (f32 and bf16 legs) against K1 member by
     member on both grids; K11 and K12 on a field and a batch of 4 in f32
     and f64 against their plain versions (updates exact, sums within
     1e-12 of the f64 plain sums), and in f32 their times beside the plain
     versions' and the eager addcmul/torch.dot sequence they replace;
 11. at 0.25 degrees, a fixed-work batched BiCGStab(2) solve of 4
     latitude-band dyes (150 matvec pairs; K5 + batched K2, its cycles
     ending in K11 and K12, counted) beside the same work as 4 single-RHS
     solves, unfused and fused (K3), and the K5 and batched K2 timings;
     then the 0.25-degree set-up on synthetic_device_case (the case, the
     indices and assemble_T, K4 counted) beside the host path's;
 12. runs the K10 probe (its launches read around the bandwidth
     measurement), holds it against its plain version, and reports the
     measured bandwidth and the fractions of it that K1, K2, K3 and K5
     reach at 0.25 degrees;
 13. times K1, K2, K3 and one BiCGStab(2) cycle (fused and unfused) at
     0.25 degrees, and K10;
 14. drives the 1-degree density path through the public API (f64 grid
     metrics made without device=, on the current CUDA device), counts
     reset before and read after: TEOS-10 density of the synthetic
     hydrography -> potential-density slopes -> GM bolus transports ->
     transportmatrix and assemble_T (K4, held against it) -> the Redi
     operator R from the f32 density -> 200 steps of chi <- euler_step(T, chi)
     + dt R chi (K1 + K6) and the same for 8 tracers (K5 + K6 on the batch,
     each member equal to the single run bit for bit), with the tracer-mass
     drift, and the bf16 R (K6 in (bf16, f32));
 15. holds K6 against its plain version in (f64, f64), (f32, f32) and
     (bf16, f32) at 1 degree on both topologies, K6 on a batch of 4 and 8
     against K6 member by member and against plain, and R's invariants
     (conservation, constants in the null space) through the kernel; at
     0.25 degrees and 720x540x75, K6 and the batch of 2 in f32;
 16. times K6 and its plain version at 1 and 0.25 degrees, the bf16 K6, K6
     on a batch of B = 1, 2, 4, 8 beside B launches of K6, and the library
     calls of K1 and K5 (a CSR matrix of T times one vector and times 8);
     each kernel's bound (its compulsory bytes over the published 3.35 TB/s
     of the H100 SXM, or its operations over 67 TFLOP/s f32, whichever is
     larger) and its rate as a fraction of K10's measured bandwidth;
 17. drives the sharded path (otmb_tpu_torch.parallel) at 1 degree on
     process grids (2, 2) and (1, 4) of four ranks spawned on cuda:0 with
     gloo, which stages the halo lines through host memory (so the numbers
     show correctness and each shard's kernel time, not scaling). Each rank
     computes the single-device references itself, then, counts reset just
     before and read just after: K8 on the synthetic transports (f32) and
     on the TEOS-10 density in 3D-rho mode (f64), K7 apply with overlap off
     and on, 200 Euler steps of one tracer (K7) and of 8 (K7 multi), K9 in
     f32 and f64, and on (2, 2) the refined ideal age and sequestration time
     with grid= and one BiCGStab(2) solve_shifted_halo. K7, K8 and K9 are
     held to K1/K5, K4 and K6 on the rank's shard and to their plain
     versions, bit for bit (overlap to its stated bound), and so are K7's
     pack and edge entries and K4's prep entry; the sharded mean ages to
     the single-device ones; every rank must launch K7, K7 multi, K8, K9,
     the pack, edge and prep entries and none of K1, K3-K6. Rank 0 traces
     20 overlapped sharded matvecs under torch.profiler (3 kernels and at
     most one copy each way per matvec, required) and times each kernel on
     its shard while the others wait at a barrier. On (2, 2) every rank
     also takes one differentiable_solve(grid=) gradient (f64, b and the
     seven legs, K7 + K2 forward and adjoint, inside the counted window);
     rank 0 gathers it and holds it to the single-device gradient (rtol
     1e-3, atol 5e-4 of each array's largest value) and logs the gap. On
     (2, 2) every rank also solves the water-mass fractions of the 4
     latitude bands on K8's f32 T with grid= at tol 1e-6 (the batched
     sharded solve: K7 multi + batched K2, its own launches counted and
     required, no K1, K5 or K7), each band's residual held to the tol and
     the gathered fractions to the single-device batched ones (rtol 1e-2,
     atol 1e-4 of each member's largest value, the JAX package's bound);
 18. at 1 degree, f64, right after the batched path: one implicit Euler
     step of dt = 1 year (BiCGStab(1) on K1 + K2, counted), its residual
     and the tracer mass across it; then the
     autodiff layer: apply_stencil_ad and a 3-step euler_step_ad chain
     against torch's autograd through the plain apply (chi and the seven
     legs, K1 launches counted: one per forward and one per backward),
     and the kappa_h gradient through assemble_transport and
     differentiable_solve against a central difference, with the forward
     and adjoint walls;
 19. at 1 degree, after the sequestration time: the refined ideal age and
     sequestration time with GMRES(30) inner solves (K1 + K2 counted, no
     K3), held to the BiCGStab results of steps 2 and 8, and two GMRES
     cycles under torch.profiler, device time by kernel class (the Arnoldi
     projections are cuBLAS matrix-vector products);
 20. the utilities at 1 degree: the f32 T saved and loaded back onto the
     card bit for bit, validate_operator, and roofline_report of K1's
     Euler step against K10's rate measured on the card;
 21. coarsening (host scipy with the C++ labelling core built by g++):
     lump_and_spray 2x2x1 at 1 degree; at 90x75x50, the native labels
     against the Python labeller's, ideal_age_coarsened end to end (wall,
     peak host memory, and its mean age beside the refined fine age on the
     card), and a purely vertical operator's coarsened ages against its
     fine direct solve;
 22. the CLI at 1 degree through otmb_tpu_torch.__main__.main on the card:
     the synthetic fields (seed 0) written to an npz, then build, diagnose,
     idealage --refine, idealage --refine --adjoint and fractions --bands 4
     (f64, tol 1e-12), each required to exit 0, the solves' launches
     counted (K1 + K2; K5 + K2); the mean age and sequestration time held
     to the API's (steps 2 and 8) within TOL_MEAN_AGE, the band fractions
     to step 6's converged f64 fractions within FRACTION_SLACK;
 23. after step 22, `python -m otmb_tpu_torch demo` and the four examples
     (`python -m otmb_tpu_torch.examples.<name>`: end_to_end,
     water_masses, density_pipeline, calibrate_kappa) as processes on the
     card, all at once, each required to exit 0; their printed lines are
     logged.

The 0.25-degree comparison of GMRES(30) with BiCGStab(2) as the refined
age's inner solve is `scripts/gmres_study.py`: GMRES(30) stagnates there
(relative residual 0.644 from its first cycle on), so it is no check of
this script.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
device and exits non-zero, printing no result, without one, and whenever
a kernel does not build or launch, disagrees, or a check fails. The last
line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

NX, NY, NZ = 360, 300, 50  # ACCESS 1-degree grid
BIPOLAR_SHAPE = (180, 150, 50)  # (nx, ny, nz): the bipolar checks run at half the width
SEED = 0
YEAR_S = 365.25 * 24 * 3600
GOLDEN = Path(__file__).resolve().parent / "tests" / "data" / "golden_tile.npz"

# Tolerances, as max|kernel - plain| / max|plain| over the field or leg.
TOL_F64 = 1e-12
# f32: the kernel and the plain version round the same products (no FMA
# contraction on either side), so K1 agrees to a few ulps of the field's
# largest value; K4 forms masses and face areas in another order than
# assemble_transport and sums the vertical closure by carry instead of
# cumsum, so it may differ by ~100 ulps of the leg's largest value.
TOL_K1_F32 = 1e-6
TOL_K4_F32 = 2e-5
# K2 runs the plain version's operations in its order without FMA: exact.
TOL_K2 = 0.0
# 200 f32 Euler steps at dt = 0.25/max|diag|: the f32 coefficients conserve
# volume-weighted mass to ~1e-7 per unit dt*|T|, so the drift stays far
# below this bound.
TOL_MASS_F32 = 1e-4
TOL_AGE = 1e-8

QUARTER = (1440, 1080, 75)  # (nx, ny, nz): the 0.25-degree grid
HALF = (720, 540, 75)  # the bipolar K3 checks run at half the 0.25-degree width
# The 0.25-degree refined age: the best relative residual the JAX reference
# reached at this size was 3.6e-6 (BENCH_LATEST.txt:33).
TOL_QUARTER = 1e-5
# The 1-degree BiCGStab(2) age against the BiCGStab(1) age of the main path
# (volume-weighted means, both solves at residual <= 1e-8).
TOL_MEAN_AGE = 1e-6
# K3's z and out run K2's and K1's operations in their order without FMA
# contraction: exact. Its dot sums f64 products in f64 in a fixed order;
# against the f64 dot of the plain out it may differ by the rounding of the
# value type, bounded by TOL_K3_DOT * sum |rhat * out|.
TOL_K3 = 0.0
TOL_K3_DOT = {torch.float32: 1e-5, torch.float64: 1e-12}
# K10 adds the same f32 values in the same order as its plain version.
TOL_K10 = 0.0
# K5 runs K1's reads and operations for each member: member b equals K1 on
# member b bit for bit, and the plain version too.
TOL_K5 = 0.0
BATCH = 8  # tracers of the batched propagation and of the K5 checks
REGIONS = 4  # latitude bands of the water-mass fractions
# The 1-degree fractions: (operator, tol, converged in solution space). 1e-4
# on the f32 operator is the JAX bench's setting, 1e-8 on the f64 one the
# CLI's success bound of 1e-6 with margin. Neither resolves the interior:
# the relative residual is dominated by the surface restoring rows (1/s),
# beside which the interior legs (~1e-8/s) hardly weigh, so the all-surface
# dye at 1e-8 spans [0.0009, 1.92] against the converged [0.99982, 1.00019]
# (f64, on an H100). The JAX package's solve is no better at those tols:
# on a 72x60x12 grid both packages' fractions miss the converged dye by
# ~1 at 1e-4 and 1e-8 (tests/test_torch_multi.py, test_fractions_resolve_
# the_interior_only_when_converged). At 1e-12 the f64 solve is converged,
# and only there are the fractions held to [0, 1] and their sum to the
# converged dye.
FRACTION_CASES = (("f32 K4", 1e-4, False), ("f64 assemble_transport", 1e-8, False),
                  ("f64 assemble_transport", 1e-12, True))
# Converged fractions lie in [0, 1] up to the surface rows' small imbalance
# of the upwind T (the converged dye's 1.00019) and the solve's error.
FRACTION_SLACK = 1e-3
# The f32 rounding floor of a residual recomputed in f32 on the 1-degree
# operator (1.04e-5 on an H100 in the card tests): the f32 fractions'
# reported residuals may sit that far from their f64 recomputation.
FLOOR = {torch.float32: 1e-5, torch.float64: 0.0}
QUARTER_PAIRS = 150  # matvec pairs of the fixed-work 0.25-degree solves
# K6 runs the plain version's operations in its order in the value type,
# built without FMA contraction: equal to redi_apply bit for bit, in every
# type pair (bf16 coefficients widen exactly to f32).
TOL_K6 = 0.0
REDI_TYPES = (("f64", "f64"), ("f32", "f32"), ("bf16", "f32"))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
# The bf16 coefficients' rounding against the exact (f64) apply, relative
# to its largest value: the bound of tests/test_redi.py:242.
TOL_REDI_BF16 = 3e-2
DENSITY_STEPS = 200
# A CSR matrix product sums each row in another order than K1: the library
# call is only checked to compute the same function, at this bound.
TOL_LIBRARY = 1e-4
# Published rates of one H100 SXM (NVIDIA's datasheet): the bound
# of a kernel is its compulsory bytes over PEAK_BYTES or its operations
# over PEAK_F32, whichever is larger.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|), in f64."""
    got, ref = got.double(), ref.double()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    return err, err / scale if scale else err


def exact_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| where the two differ, NaN equal to NaN (inf
    where a NaN meets a number); 0 when they are equal."""
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    if bool(same.all()):
        return 0.0
    return float((got.double() - ref.double())[~same].abs().nan_to_num(nan=float("inf")).max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def build_case(P, nx, ny, nz, kind, dtype, device):
    """Synthetic dataset, grid metrics and indices on the device."""
    ds = P.synthetic_dataset(nx=nx, ny=ny, nz=nz, topology=kind, seed=SEED)
    gm = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
        dtype=dtype, device=device,
    )
    require(gm.topology.kind == kind, f"detected {gm.topology.kind}, expected {kind}")
    return ds, gm, P.makeindices(gm.v3d)


def density(ds, rng: np.random.Generator) -> np.ndarray:
    """A 3D density field about 1035 kg/m^3, NaN on land."""
    rho = 1025.0 + 20.0 * rng.random(ds.umo.shape)
    return np.where(ds.wet3d, rho, np.nan)


def cuda_ms(fn, launches: int, repeats: int = 5) -> float:
    """Per-call time (ms): the median over `repeats` of the CUDA-event time
    of `launches` back-to-back calls, divided by `launches`, so the wrapper's
    host work overlaps the device work as it does in a loop."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def phase_main_path(P, device, card):
    """The 1-degree main path, with the kernels' launch counts taken."""
    read = reset_launches()
    t0 = time.perf_counter()
    ds, gm, idx = build_case(P, NX, NY, NZ, "tripolar", torch.float32, device)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    ops = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    wet = idx.wet3d
    for leg in T._fields:
        require(bool(torch.isfinite(T[leg]).all()), f"K4 leg {leg} not finite")
    k4_rel = max(rel_err(T[leg], ops.T[leg])[1] for leg in T._fields)
    require(k4_rel <= TOL_K4_F32, f"K4 vs transportmatrix {k4_rel:.3e} > {TOL_K4_F32}")
    log(f"[slice] 1-degree {NX}x{NY}x{NZ} tripolar seed {SEED}: {idx.nwet} wet cells, "
        f"metrics+fluxes+transportmatrix+assemble_T {t_setup:.3f} s, "
        f"K4 T vs transportmatrix T max rel {k4_rel:.3e}")

    # propagation: 200 f32 Euler steps through K1
    v = torch.where(wet, gm.v3d, 0.0).double()
    rng = np.random.default_rng(SEED)
    chi0 = torch.as_tensor(
        np.where(ds.wet3d, 1.0 + 0.1 * rng.standard_normal(wet.shape), 0.0),
        dtype=torch.float32, device=device)
    dt = 0.25 / float(T.diag.abs().max())
    t0 = time.perf_counter()
    chi = P.euler_propagate(T, chi0, dt, 200, gm.topology)
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t0
    m0 = float((chi0.double() * v).sum())
    m1 = float((chi.double() * v).sum())
    drift = abs(m1 - m0) / abs(m0)
    require(bool(torch.isfinite(chi).all()), "propagated tracer not finite")
    require(bool((chi[~wet] == 0).all()), "propagated tracer nonzero on land")
    require(drift < TOL_MASS_F32, f"mass drift {drift:.3e} >= {TOL_MASS_F32}")
    log(f"[propagate] 200 f32 Euler steps at dt={dt:.6g} s: {t_prop:.3f} s wall, "
        f"relative tracer-mass drift {drift:.3e} (bound {TOL_MASS_F32})")

    # refined ideal age: f32 inner BiCGStab (K1 + K2), f64 defects (K1 f32,f64)
    stats = {}
    t0 = time.perf_counter()
    gamma, res = P.ideal_age(T, wet, gm.topology, tol=TOL_AGE, refine=True, stats=stats)
    torch.cuda.synchronize()
    t_age = time.perf_counter() - t0
    for i, p in enumerate(stats["passes"]):
        log(f"[ideal_age] pass {i}: rel_start {p['rel_start']:.3e} inner_tol "
            f"{p.get('inner_tol', float('nan')):.3e} inner_iters {p.get('inner_iters')} "
            f"wall {p.get('wall_s', float('nan')):.3f} s")
    g = gamma[wet]
    mean_age = float((g * v[wet]).sum() / v[wet].sum()) / YEAR_S
    require(bool(torch.isfinite(g).all()) and bool((g > 0).all()), "ideal age not finite and positive")
    require(res <= TOL_AGE, f"ideal age residual {res:.3e} > {TOL_AGE}")
    log(f"[ideal_age] refined, tol {TOL_AGE}: relative residual {res:.3e} after "
        f"{stats['refinements']} passes, {t_age:.3f} s wall, volume-weighted mean age "
        f"{mean_age:.3f} yr")

    launches = {name: n for name, n in read().items() if name in ("K1", "K2", "K4", "K4 prep")}
    log(f"[launches] main path: {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")
    return ds, gm, idx, T, launches, mean_age


def phase_bf16_age(P, gm, idx, T, mean_age: float) -> dict:
    """The 1-degree refined ideal age on the bf16-rounded operator (the JAX
    package's bf16-narrow mode: K1 in (bf16, f32), K2 on f32 legs, f64
    defects), beside the f32 one of the main path; launches counted."""
    wet = idx.wet3d
    read = reset_launches()
    stats = {}
    t0 = time.perf_counter()
    gamma, res = P.ideal_age(T.to(torch.bfloat16), wet, gm.topology, tol=TOL_AGE, refine=True,
                             stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in read().items() if v}
    log_passes("ideal_age bf16", stats)
    g_ok = bool(torch.isfinite(gamma[wet]).all()) and bool((gamma[wet] > 0).all())
    mean_b = mean_years(gamma, gm.v3d, wet) if g_ok else float("nan")
    log(f"[ideal_age bf16] 1-degree refined on bf16 coefficients (f32 Krylov vectors), tol "
        f"{TOL_AGE}: relative residual {res:.3e} (against the bf16-rounded operator) after "
        f"{stats['refinements']} passes, {wall:.3f} s wall, mean age {mean_b:.6f} yr vs f32 "
        f"{mean_age:.6f} yr (rel {abs(mean_b / mean_age - 1):.3e}); launches {counts}")
    require(g_ok and res < 1.0, f"bf16 refined age: residual {res:.3e}, ages finite {g_ok}")
    require(counts.get("K1", 0) > 0 and counts.get("K2", 0) > 0,
            "the bf16 refined age did not launch K1 and K2")
    return {"res": res, "passes": stats["refinements"], "wall_s": wall, "mean_yr": mean_b}


def phase_k4(P, device, cases):
    """K4 against assemble_transport(...).T on the card."""
    worst = {}
    for kind, ds, gm64, gm32 in cases:
        rng = np.random.default_rng(SEED)
        rho3d = density(ds, rng)
        wet_explicit = ds.wet3d.copy()
        wet_explicit[:, ds.wet3d.shape[1] // 2, :] = False  # a dry latitude row: new coasts
        wet_explicit[-1] = False  # and a shallower floor
        for gm, tol in ((gm64, TOL_F64), (gm32, TOL_K4_F32)):
            for upwind in (True, False):
                for rho_name, rho in (("scalar", P.RHO_DEFAULT), ("3d", rho3d)):
                    for wet_name, wet3d in (("v3d", None), ("explicit", wet_explicit)):
                        if wet_name == "explicit" and not (upwind and rho_name == "scalar"):
                            continue
                        got = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm, wet3d=wet3d,
                                           rho=rho, upwind=upwind)
                        wet_t = (torch.isfinite(gm.v3d) if wet3d is None
                                 else torch.as_tensor(wet3d, device=device) & torch.isfinite(gm.v3d))
                        rho_t = rho if rho_name == "scalar" else torch.as_tensor(
                            rho, dtype=gm.v3d.dtype, device=device)
                        ref = P.assemble_transport(ds.umo, ds.vmo, ds.mlotst, gm, wet_t,
                                                   rho=rho_t, upwind=upwind).T
                        errs = [rel_err(got[leg], ref[leg]) for leg in ref._fields]
                        abs_err, rel = max(errs, key=lambda e: e[1])
                        dtype = str(gm.v3d.dtype).replace("torch.", "")
                        tag = (f"{kind} {dtype} {'upwind' if upwind else 'centered'} "
                               f"rho={rho_name} wet={wet_name}")
                        require(rel <= tol, f"K4 {tag}: max rel {rel:.3e} > {tol}")
                        log(f"[K4] {tag}: max abs {abs_err:.3e} max rel {rel:.3e} (tol {tol})")
                        worst[(kind, dtype)] = max(worst.get((kind, dtype), 0.0), abs_err)
    return worst


def phase_k1(P, device, ops_cases):
    """K1 against ops.apply.apply_stencil on the card."""
    from otmb_tpu_torch.ops.apply import apply_stencil

    worst = {}
    for kind, T64, topo, wet in ops_cases:
        rng = np.random.default_rng(SEED + 1)
        chi64 = torch.where(wet, torch.as_tensor(rng.standard_normal(wet.shape), device=device), 0.0)
        dt = 0.25 / float(T64.diag.abs().max())
        for op_name, c in (("T", T64), ("T'", P.transpose_coeffs(T64, topo))):
            cases = (
                ("f64,f64", c, chi64, TOL_F64),
                ("f32,f64", c.to(torch.float32), chi64, TOL_F64),
                ("f32,f32", c.to(torch.float32), chi64.float(), TOL_K1_F32),
                ("bf16,f32", c.to(torch.bfloat16), chi64.float(), TOL_K1_F32),
            )
            for types, coeffs, chi, tol in cases:
                for mode in ("apply", "euler"):
                    if mode == "apply":
                        got = P.stencil_apply(coeffs, chi, topo)
                        ref = apply_stencil(coeffs, chi, topo)
                    else:
                        got = P.euler_step(coeffs, chi, dt, topo)
                        ref = chi - dt * apply_stencil(coeffs, chi, topo)
                    abs_err, rel = rel_err(got, ref)
                    tag = f"{kind} {op_name} ({types}) {mode}"
                    require(rel <= tol, f"K1 {tag}: max rel {rel:.3e} > {tol}")
                    log(f"[K1] {tag}: max abs {abs_err:.3e} max rel {rel:.3e} (tol {tol})")
                    worst[(kind, types, op_name, mode)] = abs_err
    return worst


def phase_k2(P, device, ops_cases):
    """K2 against the plain Thomas sweep on the guarded shifted diagonal of T."""
    from otmb_tpu_torch.ops.tridiag import tridiag_solve_plain

    worst = {}
    for kind, T64, topo, wet in ops_cases:
        rng = np.random.default_rng(SEED + 2)
        b64 = torch.where(wet, torch.as_tensor(rng.standard_normal(wet.shape), device=device), 0.0)
        surf = torch.zeros_like(b64)
        surf[0] = 1.0
        shifted = T64.diag + torch.where(wet, surf, 0.0)
        for dtype in (torch.float64, torch.float32):
            cast = lambda x: x.to(dtype).contiguous()
            diag = torch.where(cast(shifted) != 0, cast(shifted), 1.0)
            args = (cast(T64.bottom), diag, cast(T64.top), cast(b64))
            got = P.tridiag_solve(*args)
            ref = tridiag_solve_plain(*args)
            abs_err, rel = rel_err(got, ref)
            tag = f"{kind} {str(dtype).replace('torch.', '')}"
            require(abs_err <= TOL_K2, f"K2 {tag}: max abs {abs_err:.3e} > {TOL_K2}")
            log(f"[K2] {tag}: max abs {abs_err:.3e} (exact equality required)")
            worst[tag] = abs_err
            # A batch of 3 right-hand sides in one launch against one launch
            # per member, and against the batched plain sweep.
            bb = torch.where(wet, torch.as_tensor(rng.standard_normal((3,) + wet.shape),
                                                  device=device), 0.0).to(dtype).contiguous()
            got = P.tridiag_solve(*args[:3], bb)
            per_member = torch.stack([P.tridiag_solve(*args[:3], b) for b in bb])
            require(torch.equal(got, per_member), f"batched K2 {tag}: differs from per-member K2")
            require(torch.equal(got, tridiag_solve_plain(*args[:3], bb)),
                    f"batched K2 {tag}: differs from the batched plain sweep")
            log(f"[K2] {tag}, B = 3 in one launch: equal to per-member K2 and to the plain "
                f"sweep bit for bit")
    return worst


def phase_golden(P, device):
    """The card's slice at the 18x14x6 test size against the golden tile."""
    golden = np.load(GOLDEN)
    for kind in ("tripolar", "bipolar"):
        ds = P.synthetic_dataset(nx=18, ny=14, nz=6, topology=kind, seed=3)
        gm = P.makegridmetrics(
            areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
            lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
            dtype=torch.float64, device=device)
        idx = P.makeindices(gm.v3d)
        T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
        mat = P.coeffs_to_scipy(T, idx, gm.topology).tocoo()
        order = np.lexsort((mat.col, mat.row))
        require(np.array_equal(mat.row[order], golden[f"{kind}_rows"]), f"golden rows {kind}")
        require(np.array_equal(mat.col[order], golden[f"{kind}_cols"]), f"golden cols {kind}")
        vals = golden[f"{kind}_vals"]
        val_rel = float(np.abs(mat.data[order] - vals).max() / np.abs(vals).max())
        require(val_rel <= TOL_F64, f"golden values {kind}: {val_rel:.3e}")
        age, res = P.ideal_age(T, idx.wet3d, gm.topology, tol=1e-12)
        age_wet = age[idx.wet3d].cpu().numpy()
        ref_age = golden[f"{kind}_age_wet"]
        age_rel = float(np.abs(age_wet - ref_age).max() / np.abs(ref_age).max())
        require(res < 1e-10, f"golden age residual {kind}: {res:.3e}")
        require(bool(np.allclose(age_wet, ref_age, rtol=1e-8, atol=1e-2)), f"golden age {kind}")
        log(f"[golden] {kind} 18x14x6 on the card: operator pattern equal, values max rel "
            f"{val_rel:.3e}, ideal age residual {res:.3e}, age max rel {age_rel:.3e}")


def phase_times(P, card, T, gm, idx):
    """CUDA-event medians of each kernel and its plain version at 1-degree f32."""
    from otmb_tpu_torch.models.transport import assemble_transport
    from otmb_tpu_torch.ops import assemble
    from otmb_tpu_torch.ops.apply import apply_stencil
    from otmb_tpu_torch.ops.tridiag import tridiag_factor_plain, tridiag_solve_factored_plain

    ds = P.synthetic_dataset(nx=NX, ny=NY, nz=NZ, topology="tripolar", seed=SEED)
    dev = gm.v3d.device
    umo = torch.as_tensor(ds.umo, dtype=torch.float32, device=dev)
    vmo = torch.as_tensor(ds.vmo, dtype=torch.float32, device=dev)
    ml = torch.as_tensor(ds.mlotst, dtype=torch.float32, device=dev)
    topo = gm.topology
    wet = idx.wet3d
    chi = wet.float()
    dt = 0.25 / float(T.diag.abs().max())
    diag = torch.where(T.diag != 0, T.diag, 1.0)
    lower, upper = T.bottom.contiguous(), T.top.contiguous()
    cp, rden = P.tridiag_factor(lower, diag, upper)
    legs64 = [t.double() for t in (lower, diag, upper)]
    f64 = (*P.tridiag_factor(*legs64), legs64[2], chi.double())
    pairs = {
        "K1 apply": (lambda: P.stencil_apply(T, chi, topo),
                     lambda: apply_stencil(T, chi, topo), 50, 10),
        "K1 euler_step": (lambda: P.euler_step(T, chi, dt, topo),
                          lambda: chi - dt * apply_stencil(T, chi, topo), 50, 10),
        # K2 as the engine runs it: the solve against the factor of the system
        "K2": (lambda: P.tridiag_solve_factored(cp, rden, upper, chi),
               lambda: tridiag_solve_factored_plain(cp, rden, upper, chi), 50, 5),
        "K2 f64": (lambda: P.tridiag_solve_factored(*f64),
                   lambda: tridiag_solve_factored_plain(*f64), 50, 5),
        "K2 factor": (lambda: P.tridiag_factor(lower, diag, upper),
                      lambda: tridiag_factor_plain(lower, diag, upper), 20, 3),
        "K4": (lambda: P.assemble_T(umo, vmo, ml, gm),
               lambda: assemble_transport(umo, vmo, ml, gm, wet).T, 20, 5),
        # K4's prep entry: the resident fields and per-level rows
        "K4 prep": (lambda: assemble._prep(gm, ml, *KAPPAS(P)),
                    lambda: (assemble._residents(gm, ml, P.KAPPA_H_DEFAULT),
                             assemble._levels(gm.zt, *KAPPAS(P)[1:])), 50, 10),
    }
    times = {}
    for name, (kernel, plain, calls_k, calls_p) in pairs.items():
        times[name] = time_pair(kernel, plain, calls_k, calls_p)
        log(f"[time] {name} at {NX}x{NY}x{NZ}{'' if 'f64' in name else ' f32'}: kernel "
            f"{times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms per call (CUDA events over back-to-back calls, median "
            f"of 5; card {card})")
    return times


def KAPPAS(P) -> tuple[float, float, float]:
    """The default kappa_h, kappa_vml, kappa_vdeep."""
    return P.KAPPA_H_DEFAULT, P.KAPPA_VML_DEFAULT, P.KAPPA_VDEEP_DEFAULT


def time_pair(kernel, plain, calls_k: int, calls_p: int) -> tuple[float, float]:
    """(kernel ms, plain ms) per call, timed plain, kernel, kernel, plain; each
    time is the lower of its two runs."""
    t = time_set({"plain": plain, "kernel": kernel}, {"plain": calls_p, "kernel": calls_k})
    return t["kernel"], t["plain"]


def reset_launches():
    """Set every kernel's launch count to 0; returns a reader of the counts."""
    from otmb_tpu_torch.models import redi_kernel
    from otmb_tpu_torch.ops import assemble, krylov, krylov_algebra, stencil, tridiag
    from otmb_tpu_torch.utils import profiling

    from otmb_tpu_torch.parallel import assemble_halo, halo_kernel, redi_halo

    counters = {"K1": (stencil, "LAUNCHES"), "K2": (tridiag, "LAUNCHES"),
                "K3": (krylov, "LAUNCHES"), "K4": (assemble, "LAUNCHES"),
                "K5": (stencil, "MULTI_LAUNCHES"), "K6": (redi_kernel, "LAUNCHES"),
                "K6 multi": (redi_kernel, "MULTI_LAUNCHES"), "K10": (profiling, "LAUNCHES"),
                "K7": (halo_kernel, "LAUNCHES"), "K7 multi": (halo_kernel, "MULTI_LAUNCHES"),
                "K8": (assemble_halo, "LAUNCHES"), "K9": (redi_halo, "LAUNCHES"),
                "K4 prep": (assemble, "PREP_LAUNCHES"), "K7 pack": (halo_kernel, "PACK_LAUNCHES"),
                "K7 edge": (halo_kernel, "EDGE_LAUNCHES"),
                "K11": (krylov_algebra, "SUMS_LAUNCHES"),
                "K12": (krylov_algebra, "UPDATE_LAUNCHES")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    return lambda: {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def surface_mask(wet: torch.Tensor, dtype) -> torch.Tensor:
    surf = torch.zeros(wet.shape, dtype=dtype, device=wet.device)
    surf[0] = 1.0
    return torch.where(wet, surf, 0.0)


def mean_years(gamma: torch.Tensor, v3d: torch.Tensor, wet: torch.Tensor) -> float:
    v = v3d[wet].double()
    return float((gamma[wet].double() * v).sum() / v.sum()) / YEAR_S


def log_passes(tag: str, stats: dict) -> None:
    for i, p in enumerate(stats["passes"]):
        log(f"[{tag}] pass {i}: rel_start {p['rel_start']:.3e} reverted {p['reverted']} "
            f"inner_tol {p.get('inner_tol', float('nan')):.3e} inner_iters "
            f"{p.get('inner_iters')} inner_stop {p.get('inner_stop')} inner_end_rel "
            f"{p.get('inner_end_rel', float('nan')):.3e} wall {p.get('wall_s', float('nan')):.3f} s"
            + (" STAGNATED" if p.get("stagnated") else ""))


def phase_sequestration(P, gm, idx, T, mean_age_b1):
    """At 1 degree: the refined sequestration time (K3 on T') and the refined
    ideal age with BiCGStab(2) inner solves (K3 on T)."""
    wet = idx.wet3d
    read = reset_launches()
    stats = {}
    t0 = time.perf_counter()
    seq, res = P.sequestration_time(T, wet, gm.topology, tol=TOL_AGE, refine=True,
                                    algorithm="bicgstab2", stats=stats)
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    counts = read()
    log_passes("sequestration", stats)
    require(bool(torch.isfinite(seq[wet]).all()) and bool((seq[wet] > 0).all()),
            "sequestration time not finite and positive")
    require(res <= TOL_AGE, f"sequestration residual {res:.3e} > {TOL_AGE}")
    require(counts["K3"] > 0, "K3 was not launched by the sequestration time")
    mean_seq = mean_years(seq, gm.v3d, wet)
    log(f"[sequestration] 1-degree refined, BiCGStab(2) inner, tol {TOL_AGE}: relative "
        f"residual {res:.3e} after {stats['refinements']} passes, {t_seq:.3f} s wall, "
        f"volume-weighted mean {mean_seq:.6f} yr; launches {counts}")

    read = reset_launches()
    stats = {}
    t0 = time.perf_counter()
    gamma, res = P.ideal_age(T, wet, gm.topology, tol=TOL_AGE, refine=True,
                             algorithm="bicgstab2", stats=stats)
    torch.cuda.synchronize()
    t_age = time.perf_counter() - t0
    counts = read()
    log_passes("ideal_age b2", stats)
    mean_b2 = mean_years(gamma, gm.v3d, wet)
    rel = abs(mean_b2 - mean_age_b1) / abs(mean_age_b1)
    require(res <= TOL_AGE, f"BiCGStab(2) ideal age residual {res:.3e} > {TOL_AGE}")
    require(counts["K3"] > 0, "K3 was not launched by the BiCGStab(2) ideal age")
    require(rel <= TOL_MEAN_AGE, f"BiCGStab(2) mean age {mean_b2:.9f} yr vs BiCGStab(1) "
            f"{mean_age_b1:.9f} yr: {rel:.3e} > {TOL_MEAN_AGE}")
    log(f"[ideal_age b2] 1-degree refined, BiCGStab(2) inner, tol {TOL_AGE}: relative "
        f"residual {res:.3e} after {stats['refinements']} passes, {t_age:.3f} s wall, mean "
        f"age {mean_b2:.9f} yr vs BiCGStab(1) {mean_age_b1:.9f} yr (rel {rel:.3e}, bound "
        f"{TOL_MEAN_AGE}); launches {counts}")
    return mean_seq


def phase_quarter(P, device):
    """The 0.25-degree main path through the public API, launches counted."""
    nx, ny, nz = QUARTER
    read = reset_launches()
    t0 = time.perf_counter()
    ds, gm, idx = build_case(P, nx, ny, nz, "tripolar", torch.float32, device)
    t_grid = time.perf_counter() - t0
    umo, vmo, ml = (torch.as_tensor(a, dtype=torch.float32, device=device)
                    for a in (ds.umo, ds.vmo, ds.mlotst))
    # K4's time on this call itself: CUDA events around it (the call's host
    # work included), and its kernels' device time under torch.profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        T = P.assemble_T(umo, vmo, ml, gm)
        end.record()
        end.synchronize()
    k4_ms = start.elapsed_time(end)
    dev = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    k4_dev = sum(v for name, v in dev if "assemble_kernel" in name)
    prep_dev = sum(v for name, v in dev if "prep_kernel" in name)
    t_setup = time.perf_counter() - t0
    del ds, umo, vmo, ml
    wet = idx.wet3d
    log(f"[quarter] {nx}x{ny}x{nz} tripolar seed {SEED}: {idx.nwet} wet cells; dataset + grid "
        f"metrics + indices {t_grid:.3f} s, + assemble_T {t_setup:.3f} s")
    log(f"[time] K4 at {nx}x{ny}x{nz} f32, the main path's call: assemble_T {k4_ms:.4f} ms "
        f"(CUDA events around the call), device: K4 kernel {k4_dev:.4f} ms, prep entry "
        f"{prep_dev:.4f} ms, {len(dev)} kernels (torch.profiler; card {card_line()})")
    stats = {}
    t0 = time.perf_counter()
    gamma, res = P.ideal_age(T, wet, gm.topology, tol=TOL_AGE, refine=True,
                             algorithm="bicgstab2", stats=stats)
    torch.cuda.synchronize()
    t_age = time.perf_counter() - t0
    counts = read()
    log_passes("quarter", stats)
    inner = sum(p.get("inner_iters") or 0 for p in stats["passes"])
    g_ok = bool(torch.isfinite(gamma[wet]).all()) and bool((gamma[wet] > 0).all())
    mean_age = mean_years(gamma, gm.v3d, wet) if g_ok else float("nan")
    log(f"[quarter] refined ideal age, BiCGStab(2) inner on K3, tol {TOL_AGE}: relative "
        f"residual {res:.3e} after {stats['refinements']} passes ({inner} inner matvec pairs), "
        f"{t_age:.3f} s wall, volume-weighted mean age {mean_age:.6f} yr; launches {counts}")
    require(g_ok, "0.25-degree ideal age not finite and positive")
    require(res <= TOL_QUARTER, f"0.25-degree ideal age residual {res:.3e} > {TOL_QUARTER}")
    for name in ("K1", "K2", "K3", "K4", "K4 prep", "K11", "K12"):
        require(counts[name] > 0, f"{name} was not launched on the 0.25-degree path")
    del gamma
    counts["K4 ms"], counts["K4 device ms"] = k4_ms, k4_dev
    counts["age"] = dict(wall=t_age, passes=stats["refinements"], pairs=inner, res=res,
                         mean=mean_age)
    counts["setup s"] = t_setup
    return gm, idx, T, counts


def k3_operator(c, wet, topo, transpose: bool, dtype):
    """The ideal-age system in the engine's form (surface restoring folded
    into the diagonal of A, or of A'), and its Thomas legs."""
    from otmb_tpu_torch.models.solvers import _system

    sys_ = _system(c, dtype, topo, extra_diag=surface_mask(wet, dtype), transpose=transpose)
    return sys_.a, sys_.m_legs


def phase_k3(P, device, cases):
    """K3 against the composition of the K2 and K1 kernels and against its
    plain version: z and out exact, d within TOL_K3_DOT, d repeatable."""
    from otmb_tpu_torch.ops.krylov import fused_krylov_step_plain, krylov_scratch

    worst = {}
    for kind, T, topo, wet in cases:
        gen = torch.Generator(device=device).manual_seed(SEED + 3)
        vec = lambda: torch.where(wet, torch.randn(wet.shape, generator=gen, device=device,
                                                   dtype=torch.float64), 0.0)
        x1_64, x2_64, rhat_64 = vec(), vec(), vec()
        for transpose in (False, True):
            for dtype in (torch.float32, torch.float64):
                a, m = k3_operator(T, wet, topo, transpose, dtype)
                x1, x2, rhat = x1_64.to(dtype), x2_64.to(dtype), rhat_64.to(dtype)
                c2 = torch.tensor(-0.37, dtype=dtype, device=device)
                scratch = krylov_scratch(*m)
                for combine, dot in ((True, True), (True, False), (False, False)):
                    kw = dict(with_combine=combine, with_dot=dot)
                    z, out, d = P.fused_krylov_step(a, *m, x1, x2, c2, rhat, topo,
                                                    scratch=scratch, **kw)
                    want_z = x1 + c2 * x2 if combine else x1
                    want_out = P.stencil_apply(a, P.tridiag_solve(*m, want_z), topo)
                    _, pout, _ = fused_krylov_step_plain(a, *m, x1, x2, c2, rhat, topo, **kw)
                    err_z = rel_err(z, want_z)[0]
                    err_out = max(rel_err(out, want_out)[0], rel_err(out, pout)[0])
                    op = "T'" if transpose else "T"
                    tag = (f"{kind} {op} {str(dtype).replace('torch.', '')} combine={combine} "
                           f"dot={dot}")
                    require(err_z <= TOL_K3 and err_out <= TOL_K3,
                            f"K3 {tag}: z max abs {err_z:.3e}, out max abs {err_out:.3e}")
                    msg = f"z and out exact vs K2+K1 and plain (max abs {err_out:.1e})"
                    if dot:
                        ref = torch.dot(rhat.double().flatten(), pout.double().flatten())
                        scale = float((rhat.double() * pout.double()).abs().sum())
                        derr = abs(float(d) - float(ref))
                        bound = TOL_K3_DOT[dtype] * scale
                        _, _, d2 = P.fused_krylov_step(a, *m, x1, x2, c2, rhat, topo,
                                                       scratch=scratch, **kw)
                        require(derr <= bound, f"K3 {tag}: |d - d_ref| {derr:.3e} > {bound:.3e}")
                        require(torch.equal(d, d2), f"K3 {tag}: d differs between two calls")
                        msg += (f"; |d - d_ref| {derr:.3e} <= {bound:.3e} "
                                f"({TOL_K3_DOT[dtype]} * sum|rhat*out|), repeatable")
                    log(f"[K3] {tag}: {msg}")
                    worst[(kind, str(dtype), op)] = max(worst.get((kind, str(dtype), op), 0.0),
                                                        err_out)
                    del z, out, d, want_z, want_out, pout
                del a, m, x1, x2, rhat, scratch
                torch.cuda.empty_cache()
    return worst


def phase_probe(P, device, card, k_times):
    """K10: the bandwidth measurement (its launches counted), the check
    against the plain version, and the fractions of the measured bandwidth
    that K1, K2 and K3 reach at 0.25 degrees."""
    from otmb_tpu_torch.utils.profiling import probe_sum_plain

    read = reset_launches()
    thunk, nbytes = P.dma_peak_probe(nstreams=7, mbytes=200, device=device)
    ms = cuda_ms(thunk, 20)
    counts = read()
    require(counts["K10"] > 0, "K10 was not launched by the bandwidth measurement")
    gbps = nbytes / (ms * 1e-3) / 1e9
    gen = torch.Generator(device=device).manual_seed(0)  # the probe's own streams
    streams = [torch.randn((200, 512, 512), generator=gen, device=device) for _ in range(7)]
    got, want = thunk(), probe_sum_plain(streams)
    err = rel_err(got, want)[0]
    require(err <= TOL_K10, f"K10 vs plain: max abs {err:.3e} > {TOL_K10}")
    k_ms, p_ms = time_pair(thunk, lambda: probe_sum_plain(streams), 20, 5)
    log(f"[K10] 7 x 200 MiB f32 streams in, 1 out: max abs vs plain {err:.1e} (exact "
        f"required); {nbytes / 1e9:.3f} GB per call in {ms:.4f} ms = {gbps:.1f} GB/s measured "
        f"(card {card}); launches {counts['K10']}")
    nx, ny, nz = QUARTER
    cells = nx * ny * nz
    # compulsory traffic: every input read once, every output written once (f32)
    streams_of = {"K1 apply": 9, "K2": 5, "K3": 15}
    fractions = {}
    for name, n in streams_of.items():
        rate = n * cells * 4 / (k_times[name][0] * 1e-3) / 1e9
        fractions[name] = rate / gbps
        log(f"[roofline] {name} at {nx}x{ny}x{nz} f32: {n} compulsory streams, "
            f"{n * cells * 4 / 1e9:.3f} GB in {k_times[name][0]:.4f} ms = {rate:.1f} GB/s, "
            f"{100 * fractions[name]:.1f} % of K10's {gbps:.1f} GB/s")
    del streams, got, want
    return counts["K10"], err, (k_ms, p_ms), gbps, nbytes


def phase_times_quarter(P, card, T, gm, idx):
    """CUDA-event times at 0.25 degrees, f32: K1, K2, K3 and their plain
    versions, and one BiCGStab(2) cycle fused (K3) and unfused (K2 + K1 +
    eager vector algebra)."""
    from otmb_tpu_torch.models import solvers as S
    from otmb_tpu_torch.ops.apply import apply_stencil
    from otmb_tpu_torch.ops.krylov import fused_krylov_step_plain, krylov_scratch
    from otmb_tpu_torch.ops.tridiag import tridiag_solve_factored_plain

    topo, wet = gm.topology, idx.wet3d
    nx, ny, nz = QUARTER
    b = wet.float()
    sys_ = S._system(T, torch.float32, topo, extra_diag=surface_mask(wet, torch.float32))
    a, m = sys_.a, sys_.m_legs
    gen = torch.Generator(device=b.device).manual_seed(SEED + 4)
    x2 = torch.where(wet, torch.randn(wet.shape, generator=gen, device=b.device), 0.0)
    c2 = torch.tensor(-0.37, dtype=torch.float32, device=b.device)
    scratch = krylov_scratch(*m, factor=sys_.factor)
    cp, rden = sys_.factor
    pairs = {
        "K1 apply": (lambda: P.stencil_apply(a, b, topo), lambda: apply_stencil(a, b, topo),
                     20, 5),
        "K2": (lambda: P.tridiag_solve_factored(cp, rden, m[2], b),
               lambda: tridiag_solve_factored_plain(cp, rden, m[2], b), 20, 3),
        "K3": (lambda: P.fused_krylov_step(a, *m, b, x2, c2, x2, topo, scratch=scratch),
               lambda: fused_krylov_step_plain(a, *m, b, x2, c2, x2, topo), 20, 3),
    }
    times = {}
    for name, (kernel, plain, calls_k, calls_p) in pairs.items():
        times[name] = time_pair(kernel, plain, calls_k, calls_p)
        log(f"[time] {name} at {nx}x{ny}x{nz} f32: kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms per call (CUDA events over back-to-back calls, median "
            f"of 5; card {card})")
    legs64 = [t.double() for t in m]
    f64 = (*P.tridiag_factor(*legs64), legs64[2], b.double())
    del legs64
    times["K2 f64"] = (cuda_ms(lambda: P.tridiag_solve_factored(*f64), 10), float("nan"))
    log(f"[time] K2 at {nx}x{ny}x{nz} f64: kernel {times['K2 f64'][0]:.4f} ms per call (CUDA "
        f"events over back-to-back calls, median of 5; card {card})")
    del f64
    state = S._initial_state(sys_, "bicgstab2", b)
    fused = S._fused_step(sys_, scratch)
    unfused = S._unfused_step(sys_)
    times["cycle"] = time_pair(lambda: S._bicgstab2_cycles(sys_, fused, state, 1),
                               lambda: S._bicgstab2_cycles(sys_, unfused, state, 1), 5, 5)
    log(f"[time] one BiCGStab(2) cycle (4 applications of A o M, 2 matvec pairs) at "
        f"{nx}x{ny}x{nz} f32: fused (K3) {times['cycle'][0]:.4f} ms, unfused (K2 + K1 + eager "
        f"algebra) {times['cycle'][1]:.4f} ms (CUDA events over back-to-back cycles, median "
        f"of 5; card {card})")
    return times


# K11 and K12 (the BiCGStab(2) cycle's algebra, csrc/krylov_algebra.cu) run
# the plain version's products and sums in its order without FMA: their
# updates are exact. Their sums add the f64 products in a fixed tree, the
# plain version by f64 torch.dot: before rounding to the field's type they
# may differ by TOL_ALGEBRA_SUM * sum |a * b|; f32 sums equal the rounding of
# the plain f64 sum unless that lies so close to a rounding tie.
TOL_ALGEBRA = 0.0
TOL_ALGEBRA_SUM = 1e-12
ALGEBRA_BATCH = 4


def algebra_sum_err(got: torch.Tensor, pairs, dtype) -> float:
    """One member's sums `got` (k,) over `pairs` against the plain f64 sums,
    relative to sum |a * b|: in f64 their difference; in f32, where a sum
    is not the rounding of the plain one, how far the plain one lies from
    the tie between the two (0 where it is)."""
    from otmb_tpu_torch.ops.krylov_algebra import dot64

    want = torch.stack([dot64(a, b) for a, b in pairs])
    mag = torch.stack([dot64(a.abs(), b.abs()) for a, b in pairs])
    g = got.double()
    if dtype == torch.float64:
        return float(((g - want).abs() / mag).max())
    rounded = want.float().double()
    off = torch.where(g == rounded, 0.0, ((g + rounded) / 2 - want).abs() / mag)
    return float(off.max())


def phase_algebra_quarter(card, wet):
    """K11 and K12 at 0.25 degrees on a field and on a batch of
    ALGEBRA_BATCH, in f32 and f64, against their plain versions (a batch
    member by member): the updates exact, the sums within TOL_ALGEBRA_SUM;
    in f32, the kernels, the plain versions and the eager addcmul/torch.dot
    sequence they replace timed with CUDA events. Returns each kernel's
    worst update error and sum error, and the f32 times {(members, name):
    (kernel, plain, eager) ms}."""
    from otmb_tpu_torch.models import solvers as S
    from otmb_tpu_torch.ops import krylov_algebra as A

    nx, ny, nz = QUARTER
    gen = torch.Generator(device=wet.device).manual_seed(SEED + 11)
    worst = {"K11": 0.0, "K12": 0.0, "sums": 0.0}
    times = {}
    for dtype in (torch.float32, torch.float64):
        for members in (None, ALGEBRA_BATCH):
            lead = () if members is None else (members,)
            field = lambda: torch.where(wet, torch.randn(lead + tuple(wet.shape), generator=gen,
                                                         device=wet.device, dtype=dtype), 0.0)
            scalar = lambda: torch.rand(lead, generator=gen, device=wet.device, dtype=dtype) - 0.5
            y, u0, r0, r1, r2, u1, u2, rhat = (field() for _ in range(8))
            alpha, w1, w2 = scalar(), scalar(), scalar()
            members_of = [None] if members is None else range(members)
            pick = lambda t, m: t if m is None else t[m]
            got_r0, sums = A.polish_sums(r0, u1, r1, r2, alpha)
            for m in members_of:
                want_r0, _ = A.polish_sums_plain(*(pick(t, m) for t in (r0, u1, r1, r2, alpha)))
                worst["K11"] = max(worst["K11"], exact_err(pick(got_r0, m), want_r0))
                worst["sums"] = max(worst["sums"], algebra_sum_err(
                    pick(sums, m), ((pick(r1, m), pick(r1, m)), (pick(r1, m), pick(r2, m)),
                                    (pick(r2, m), pick(r2, m)), (want_r0, pick(r1, m)),
                                    (want_r0, pick(r2, m))), dtype))
                del want_r0
            # K12 with the next dot, then without it (one result set at a time)
            for with_dot in (True, False):
                args = (y, u0, got_r0, r1, r2, u1, u2, alpha, w1, w2, rhat if with_dot else None)
                got = A.polish_update(*args)
                for m in members_of:
                    want = A.polish_update_plain(*(None if t is None else pick(t, m)
                                                   for t in args))
                    for g, w in zip(got[:3], want[:3]):
                        worst["K12"] = max(worst["K12"], exact_err(pick(g, m), w))
                    if with_dot:
                        worst["sums"] = max(worst["sums"], algebra_sum_err(
                            pick(got[3], m).reshape(1), ((pick(rhat, m), want[1]),), dtype))
                    else:
                        require(got[3] is None, "K12 without rhat returned a dot")
                    del want
                del got
            require(worst["K11"] <= TOL_ALGEBRA and worst["K12"] <= TOL_ALGEBRA,
                    f"K11/K12 at {nx}x{ny}x{nz}, {dtype}, members {members}: updates "
                    f"differ from plain by {worst['K11']:.3e} / {worst['K12']:.3e}")
            require(worst["sums"] <= TOL_ALGEBRA_SUM,
                    f"K11/K12 sums: {worst['sums']:.3e} > {TOL_ALGEBRA_SUM} of sum |a b|")
            tag = f"{nx}x{ny}x{nz} {str(dtype).replace('torch.', '')}" + (
                "" if members is None else f", B = {members}")
            log(f"[K11/K12] {tag}: r0, y, u0 (with and without the next dot) exact vs plain; "
                f"sums within {worst['sums']:.3e} of sum |a b| of the f64 plain sums (bound "
                f"{TOL_ALGEBRA_SUM})")
            del got_r0, sums
            if dtype == torch.float32:
                pairs = lambda r: ((r1, r1), (r1, r2), (r2, r2), (r, r1), (r, r2))

                def eager_sums():
                    r = S._axpy(r0, -alpha, u1)
                    return r, [S._dot(a, b) for a, b in pairs(r)]

                def eager_update():
                    yy = S._axpy(y, alpha, u0)
                    yy = S._axpy(S._axpy(yy, w1, r0), w2, r1)
                    rr = S._axpy(S._axpy(r0, -w1, r1), -w2, r2)
                    uu = S._axpy(S._axpy(u0, -w1, u1), -w2, u2)
                    return yy, rr, uu, S._dot(rhat, rr)

                upd = (y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat)
                for name, fns in (
                        ("K11", {"kernel": lambda: A.polish_sums(r0, u1, r1, r2, alpha),
                                 "plain": lambda: A.polish_sums_plain(r0, u1, r1, r2, alpha),
                                 "eager": eager_sums}),
                        ("K12", {"kernel": lambda: A.polish_update(*upd),
                                 "plain": lambda: A.polish_update_plain(*upd),
                                 "eager": eager_update})):
                    t = time_set(fns, {"kernel": 20, "plain": 3, "eager": 10})
                    times[members, name] = (t["kernel"], t["plain"], t["eager"])
                    log(f"[time] {name} at {tag}: kernel {t['kernel']:.4f} ms, plain "
                        f"{t['plain']:.4f} ms, the eager addcmul/torch.dot sequence it "
                        f"replaces {t['eager']:.4f} ms per call (CUDA events over back-to-back "
                        f"calls, median of 5; card {card})")
            del y, u0, r0, r1, r2, u1, u2, rhat
            torch.cuda.empty_cache()
    return worst, times


# The device case at 1 degree against the host path's makegridmetrics (f32
# of f64 fields): v3d is area x thickness rounded from f32 factors (three
# roundings); z3d a cumulative f32 sum down NZ levels.
TOL_CASE_V3D = 4 * 2.0 ** -24
TOL_CASE_Z3D = NZ * 2.0 ** -24


def phase_device_case(P, device, gm, idx):
    """`synthetic_device_case` at 1 degree (seed 0) on the card against the
    host path's grid (`synthetic_dataset` + `makegridmetrics`, f32): the
    topology and wet mask equal, v3d and z3d within f32 rounding, NaN on the
    same cells."""
    t0 = time.perf_counter()
    dgm, dwet, umo, vmo, ml = P.synthetic_device_case(NX, NY, NZ, device=device)
    torch.cuda.synchronize()
    t_case = time.perf_counter() - t0
    require(dgm.topology == gm.topology, f"device case topology {dgm.topology}")
    require(torch.equal(dwet, idx.wet3d), "device case wet mask differs from the host path's")
    errs = {}
    for name, tol in (("v3d", TOL_CASE_V3D), ("z3d", TOL_CASE_Z3D)):
        got, want = getattr(dgm, name), getattr(gm, name)
        require(torch.equal(torch.isnan(got), torch.isnan(want)), f"device case {name}: NaN "
                f"on other cells than the host path's")
        errs[name] = float(((got.double() - want.double()).abs()
                            / want.double().abs())[dwet].max())
        require(errs[name] <= tol, f"device case {name}: relative {errs[name]:.3e} > {tol:.3e}")
    for name, t in (("umo", umo), ("vmo", vmo), ("mlotst", ml)):
        wet = dwet if t.ndim == 3 else dwet[0]
        require(bool(torch.isfinite(t[wet]).all()) and bool(torch.isnan(t[~wet]).all()),
                f"device case {name}: not finite on wet cells and NaN on land")
    log(f"[device case] {NX}x{NY}x{NZ} tripolar seed {SEED} on the card in {t_case:.3f} s: "
        f"topology and wet mask equal to the host path's; v3d within {errs['v3d']:.3e} "
        f"(bound {TOL_CASE_V3D:.3e}), z3d within {errs['z3d']:.3e} (bound {TOL_CASE_Z3D:.3e}) "
        f"relative")


def phase_device_case_quarter(P, card, device, host_setup_s: float):
    """The 0.25-degree set-up on the device case, launches counted: the
    case, the indices and assemble_T (K4), beside the host path's set-up."""
    nx, ny, nz = QUARTER
    read = reset_launches()
    t0 = time.perf_counter()
    gm, wet, umo, vmo, ml = P.synthetic_device_case(nx, ny, nz, device=device)
    idx = P.makeindices(gm.v3d)
    torch.cuda.synchronize()
    t_case = time.perf_counter() - t0
    T = P.assemble_T(umo, vmo, ml, gm)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    counts = read()
    require(counts["K4"] > 0 and counts["K4 prep"] > 0,
            f"assemble_T on the device case launched {counts}")
    require(torch.equal(idx.wet3d, wet), "0.25-degree device case: indices' wet mask differs")
    finite = all(bool(torch.isfinite(leg[wet]).all()) for leg in T)
    require(finite and bool((T.diag[wet] > 0).all()),
            "0.25-degree device case: T not finite, or its diagonal not positive, on wet cells")
    log(f"[device case] {nx}x{ny}x{nz} tripolar seed {SEED}: {idx.nwet} wet cells; case + "
        f"indices {t_case:.3f} s, + assemble_T {t_setup:.3f} s (the host path's set-up "
        f"{host_setup_s:.3f} s); T finite on wet cells, diagonal positive; launches "
        f"{ {k: v for k, v in counts.items() if v} } (card {card})")
    return t_setup


def latitude_bands(ny: int, nx: int, nbands: int) -> np.ndarray:
    """(nbands, ny, nx) masks of equal latitude bands of rows, as the JAX
    bench's 1-degree fractions (bench.py:646-649)."""
    masks = np.zeros((nbands, ny, nx), bool)
    for r in range(nbands):
        masks[r, r * ny // nbands:(r + 1) * ny // nbands] = True
    return masks


def phase_batched(P, device, gm, idx, T32, T64):
    """At 1 degree, the batched-tracer path through the public API: the
    batched propagation (K5) and the water-mass fractions on the f32 and
    f64 operators (K5 + batched K2), each with the launch counts reset
    just before and read just after. Returns the K5 and K2 launches, and
    the converged f64 fractions on the host under "fractions"."""
    topo, wet = gm.topology, idx.wet3d
    v = torch.where(wet, gm.v3d, 0.0).double()
    rng = np.random.default_rng(SEED + 5)
    wet_np = wet.cpu().numpy()
    chis0 = torch.as_tensor(
        np.where(wet_np[None], 1.0 + 0.1 * rng.standard_normal((BATCH,) + wet_np.shape), 0.0),
        dtype=torch.float32, device=device)
    dt = 0.25 / float(T32.diag.abs().max())
    read = reset_launches()
    t0 = time.perf_counter()
    chis = P.euler_propagate_multi(T32, chis0, dt, 200, topo)
    torch.cuda.synchronize()
    t_multi = time.perf_counter() - t0
    counts = read()
    require(counts["K5"] == 200 and counts["K1"] == 0,
            f"batched propagation launches {counts}: expected 200 K5 and no K1")
    total = {"K5": counts["K5"], "K2": 0}
    require(bool(torch.isfinite(chis).all()), "batched tracers not finite")
    drift = max(abs(float((chis[m].double() * v).sum()) / float((chis0[m].double() * v).sum())
                    - 1.0) for m in range(BATCH))
    require(drift < TOL_MASS_F32, f"batched mass drift {drift:.3e} >= {TOL_MASS_F32}")
    t0 = time.perf_counter()
    for m in range(BATCH):
        ref = P.euler_propagate(T32, chis0[m], dt, 200, topo)
        require(torch.equal(chis[m], ref), f"batched member {m} differs from K1's propagation")
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    log(f"[batched] {BATCH} f32 tracers x 200 Euler steps at dt={dt:.6g} s through K5: "
        f"{t_multi:.3f} s wall ({BATCH} x 200 K1 steps: {t_single:.3f} s); every member equal "
        f"to K1's propagation bit for bit; worst relative mass drift {drift:.3e} (bound "
        f"{TOL_MASS_F32}); launches {counts}")
    del chis, chis0, ref

    masks = latitude_bands(NY, NX, REGIONS)
    surf64 = surface_mask(wet, torch.float64)
    tol_conv = next(tol for _, tol, converged in FRACTION_CASES if converged)
    dye, res_dye = P.solve_shifted(T64, surf64, topo, extra_diag=surf64, tol=tol_conv)
    require(res_dye <= tol_conv, f"converged all-surface dye residual {res_dye:.3e} > {tol_conv}")
    dye_wet = dye[wet]
    log(f"[fractions] converged all-surface dye (f64, tol {tol_conv}): residual {res_dye:.3e}, "
        f"range [{float(dye_wet.min()):.6f}, {float(dye_wet.max()):.6f}] on wet cells")
    for name, tol, converged in FRACTION_CASES:
        T = T32 if name.startswith("f32") else T64
        dtype = T.diag.dtype
        read = reset_launches()
        stats = {}
        t0 = time.perf_counter()
        fr, res = P.water_mass_fractions(T, wet, topo, masks, tol=tol, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read()
        tag = f"[fractions] 1-degree {REGIONS} latitude bands, {name} operator, tol {tol}"
        log(f"{tag}: {wall:.3f} s wall, {stats['iters']} iterations (stop {stats['stop']}), "
            f"residuals {' '.join(f'{r:.3e}' for r in res.tolist())}; launches {counts}")
        require(counts["K5"] > 0 and counts["K2"] > 0 and counts["K1"] == 0,
                f"{tag}: launches {counts}: expected K5 and K2, and no K1")
        total["K5"] += counts["K5"]
        total["K2"] += counts["K2"]
        require(float(res.max()) <= tol, f"{tag}: residual {float(res.max()):.3e} > {tol}")
        frw = fr[:, wet]
        require(bool(torch.isfinite(frw).all()), f"{tag}: fractions not finite")
        lo, hi = float(frw.min()), float(frw.max())
        # Linearity. With b_r the bands' right-hand sides and b = sum b_r the
        # all-surface dye, ||A f_r - b_r|| <= tol ||b_r|| and ||A x - b|| <=
        # tol ||b||, so ||A (sum f_r - x)|| <= tol (sum ||b_r|| + ||b||) <=
        # (sqrt(R) + 1) tol ||b|| (the b_r are disjoint); A d is evaluated in
        # f64 from the operator's own coefficients, plus the f32 floor.
        surf = surface_mask(wet, dtype)
        x, res_x = P.solve_shifted(T, surf, topo, extra_diag=surf, tol=tol)
        require(res_x <= tol, f"{tag}: all-surface dye residual {res_x:.3e} > {tol}")
        total_fr = torch.where(wet, fr.sum(0), 0.0).double()
        d = total_fr - x.double()
        a_d = P.stencil_apply(T, d, topo) + surf64 * d
        lin = float(torch.linalg.vector_norm(a_d)) / float(torch.linalg.vector_norm(surf64))
        bound = (REGIONS ** 0.5 + 1.0) * tol + FLOOR[dtype]
        require(lin <= bound, f"{tag}: ||A (sum f_r - x)|| / ||b|| = {lin:.3e} > {bound:.3e}")
        off = float((total_fr - dye)[wet].abs().max())
        if converged:
            total["fractions"] = fr.cpu()
            require(lo >= -FRACTION_SLACK and hi <= 1.0 + FRACTION_SLACK,
                    f"{tag}: fractions in [{lo:.3e}, {hi:.6f}], outside [-{FRACTION_SLACK}, "
                    f"1 + {FRACTION_SLACK}]")
            require(off <= FRACTION_SLACK,
                    f"{tag}: max|sum f_r - converged dye| {off:.3e} > {FRACTION_SLACK}")
        log(f"{tag}: fractions in [{lo:.3e}, {hi:.6f}] on wet cells; linearity ||A (sum f_r - "
            f"x)|| / ||b|| = {lin:.3e} <= {bound:.3e} ((sqrt(R) + 1) tol + floor), all-surface "
            f"dye residual {res_x:.3e}; max|sum f_r - converged dye| {off:.3e}"
            + (f" (held to [-{FRACTION_SLACK}, 1 + {FRACTION_SLACK}] and {FRACTION_SLACK})"
               if converged else " (not converged in the interior at this tol: not held to "
                                 "[0, 1])"))
        del fr, x, d, a_d, total_fr
    return total


def phase_k5_checks(P, device, cases, types, batches, plain: bool):
    """K5 against K1 member by member, apply and Euler step, on T and T',
    for each (coefficient, value) type pair in `types` and each batch size
    in `batches`; with `plain`, the whole batch also against the plain
    version. Returns the largest error (0 when bit for bit)."""
    from otmb_tpu_torch.ops.apply import apply_stencil

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
    worst = 0.0
    for kind, T, topo, wet in cases:
        dt = 0.25 / float(T.diag.abs().max())
        size = "x".join(map(str, topo.shape3d[::-1]))
        for op, c in (("T", T), ("T'", P.transpose_coeffs(T, topo))):
            for ctype, vtype in types:
                coeffs = c.to(dtypes[ctype])
                for nb in batches:
                    gen = torch.Generator(device=device).manual_seed(SEED + 6 + nb)
                    xs = torch.where(wet, torch.randn((nb,) + tuple(wet.shape), generator=gen,
                                                      device=device, dtype=dtypes[vtype]), 0.0)
                    got = P.stencil_apply_multi(coeffs, xs, topo)
                    step = P.euler_step_multi(coeffs, xs, dt, topo)
                    err = 0.0
                    if plain:
                        ref = apply_stencil(coeffs, xs, topo)
                        err = max(rel_err(got, ref)[0], rel_err(step, xs - dt * ref)[0])
                        del ref
                    for m in range(nb):
                        err = max(err, rel_err(got[m], P.stencil_apply(coeffs, xs[m], topo))[0],
                                  rel_err(step[m], P.euler_step(coeffs, xs[m], dt, topo))[0])
                    tag = f"{kind} {size} {op} ({ctype},{vtype}), B = {nb}"
                    require(err <= TOL_K5, f"K5 {tag}: max abs {err:.3e} > {TOL_K5}")
                    worst = max(worst, err)
                    del xs, got, step
                log(f"[K5] {kind} {size} {op} ({ctype},{vtype}), B = "
                    f"{' and '.join(map(str, batches))}: apply and Euler step equal K1 on every "
                    f"member{' and the plain version' if plain else ''} bit for bit")
                del coeffs
            del c
        torch.cuda.empty_cache()
    return worst


def bands_rhs(wet: torch.Tensor, nbands: int):
    """The water-mass-fraction right-hand sides of `nbands` latitude bands
    and the surface restoring they share (f32)."""
    surf = surface_mask(wet, torch.float32)
    masks = torch.as_tensor(latitude_bands(wet.shape[1], wet.shape[2], nbands), device=wet.device)
    return torch.where(wet[None] & masks[:, None], surf[None], 0.0), surf


def phase_batched_quarter(P, card, gm, idx, T):
    """At 0.25 degrees, f32: a fixed-work batched BiCGStab(2) solve of 4
    latitude-band dyes (launches counted), then the same work as 4
    single-RHS solves, unfused and fused. Returns the K5 and K2 launches
    and the seconds per member-pair."""
    topo, wet = gm.topology, idx.wet3d
    nx, ny, nz = QUARTER
    bs, surf = bands_rhs(wet, REGIONS)
    kw = dict(extra_diag=surf, tol=1e-30, maxiter=QUARTER_PAIRS, early_stop=False,
              algorithm="bicgstab2")
    read = reset_launches()
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xs, res = P.solve_shifted_chunked_multi(T, bs, topo, stats=stats, **kw)
    torch.cuda.synchronize()
    t_multi = time.perf_counter() - t0
    counts = read()
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(counts["K5"] > 0 and counts["K2"] > 0 and counts["K1"] == 0 and counts["K3"] == 0,
            f"0.25-degree batched solve launches {counts}: expected K5 and K2 only")
    require(counts["K11"] > 0 and counts["K12"] > 0,
            f"0.25-degree batched solve launches {counts}: its cycles end in K11 and K12")
    require(bool(torch.isfinite(xs).all()) and bool(torch.isfinite(res).all()),
            "0.25-degree batched solve not finite")
    del xs
    per_multi = t_multi / (REGIONS * stats["iters"])
    log(f"[quarter batched] {nx}x{ny}x{nz} f32, R = {REGIONS} band dyes, BiCGStab(2), "
        f"{stats['iters']} matvec pairs (stop {stats['stop']}, {stats['diverge_restarts']} "
        f"jittered restarts): {t_multi:.3f} s wall, {per_multi * 1e3:.3f} ms per member-pair, "
        f"peak memory {peak:.1f} GB, residuals {' '.join(f'{r:.3e}' for r in res.tolist())}; "
        f"launches {counts} (card {card})")
    per_single = {}
    for fused in (False, True):
        wall = pairs = 0.0
        for r in range(REGIONS):
            st = {}
            t0 = time.perf_counter()
            x, _ = P.solve_shifted_chunked(T, bs[r], topo, fused=fused, stats=st, **kw)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            pairs += st["iters"]
            del x
        per_single[fused] = wall / pairs
        log(f"[quarter batched] the same as {REGIONS} single-RHS solves, "
            f"{'fused (K3)' if fused else 'unfused (K2 + K1)'}: {wall:.3f} s wall for "
            f"{pairs:.0f} pairs, {per_single[fused] * 1e3:.3f} ms per member-pair (card {card})")
    del bs, surf
    return ({name: counts[name] for name in ("K5", "K2", "K11", "K12")}, per_multi,
            per_single)


def time_set(fns: dict, calls: dict) -> dict:
    """ms per call of each function, timed forward then backward through
    `fns` (CUDA events, median of 5 each); each time is the lower of its
    two runs."""
    first = {name: cuda_ms(fn, calls[name]) for name, fn in fns.items()}
    second = {name: cuda_ms(fns[name], calls[name]) for name in reversed(list(fns))}
    return {name: min(first[name], second[name]) for name in fns}


def phase_k5_times(P, card, T, topo, wet, plain_bmax: int, k_calls: int):
    """K5 at B = 1, 2, 4, 8 beside B launches of K1 and (B <= plain_bmax)
    its plain version, and the batched K2 at B = 4 beside 4 launches of K2,
    all f32 on T. Returns {B: {name: ms}}, and K5's largest error against
    the plain version."""
    from otmb_tpu_torch.ops.apply import apply_stencil

    size = "x".join(map(str, topo.shape3d[::-1]))
    gen = torch.Generator(device=wet.device).manual_seed(SEED + 7)
    times, err = {}, 0.0
    for nb in (1, 2, 4, 8):
        xs = torch.where(wet, torch.randn((nb,) + tuple(wet.shape), generator=gen,
                                          device=wet.device), 0.0)
        fns = {"K5": lambda: P.stencil_apply_multi(T, xs, topo),
               "B x K1": lambda: [P.stencil_apply(T, x, topo) for x in xs]}
        calls = {"K5": k_calls, "B x K1": k_calls}
        if nb <= plain_bmax:
            fns["plain"] = lambda: apply_stencil(T, xs, topo)
            calls["plain"] = 3
            err = max(err, rel_err(fns["K5"](), fns["plain"]())[0])
            require(err <= TOL_K5, f"K5 vs plain at {size}, B = {nb}: max abs {err:.3e}")
        times[nb] = time_set(fns, calls)
        log(f"[time] K5 at {size} f32, B = {nb}: "
            + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times[nb].items())
            + f" per call; per tracer K5 {times[nb]['K5'] / nb:.4f} ms, K1 "
            f"{times[nb]['B x K1'] / nb:.4f} ms (CUDA events over back-to-back calls, median "
            f"of 5; card {card})")
        del xs
    diag = torch.where(T.diag != 0, T.diag, 1.0)
    fac = (*P.tridiag_factor(T.bottom.contiguous(), diag, T.top.contiguous()),
           T.top.contiguous())
    bs = torch.where(wet, torch.randn((4,) + tuple(wet.shape), generator=gen,
                                      device=wet.device), 0.0)
    require(torch.equal(P.tridiag_solve_factored(*fac, bs),
                        torch.stack([P.tridiag_solve_factored(*fac, b) for b in bs])),
            f"batched K2 at {size}, B = 4: differs from per-member K2")
    k2 = time_set({"batched K2": lambda: P.tridiag_solve_factored(*fac, bs),
                   "4 x K2": lambda: [P.tridiag_solve_factored(*fac, b) for b in bs]},
                  {"batched K2": k_calls, "4 x K2": k_calls})
    log(f"[time] K2 at {size} f32, B = 4: batched {k2['batched K2']:.4f} ms, 4 launches "
        f"{k2['4 x K2']:.4f} ms per call, equal bit for bit (card {card})")
    times["K2"] = k2
    return times, err


def log_k5_fractions(times: dict, cells: int, gbps: float, size: str) -> dict:
    """K5's rate on its 7 + 2B compulsory f32 streams, as a fraction of
    K10's measured bandwidth."""
    fractions = {}
    for nb in (1, 2, 4, 8):
        nbytes = (7 + 2 * nb) * cells * 4
        rate = nbytes / (times[nb]["K5"] * 1e-3) / 1e9
        fractions[nb] = rate / gbps
        log(f"[roofline] K5 at {size} f32, B = {nb}: {7 + 2 * nb} compulsory streams, "
            f"{nbytes / 1e9:.3f} GB in {times[nb]['K5']:.4f} ms = {rate:.1f} GB/s, "
            f"{100 * fractions[nb]:.1f} % of K10's {gbps:.1f} GB/s")
    return fractions


def hydrography(gm, wet: torch.Tensor):
    """so and ct as examples/density_pipeline.py:32-35 makes them from the
    grid (the synthetic dataset has no hydrography), NaN on land."""
    lat, lon = torch.deg2rad(gm.lat), torch.deg2rad(gm.lon)
    so = torch.where(wet, 35.0 + 0.3 * torch.cos(lat) * torch.sin(lon), torch.nan)
    ct = torch.where(wet, 20.0 - 0.004 * gm.z3d - 6.0 * torch.sin(lat) ** 2, torch.nan)
    return so, ct


def redi_of(P, gm, wet: torch.Tensor):
    """The Redi operator of the hydrography's TEOS-10 density, built on the
    f32 density as the density path builds it; its fields take the grid's
    dtype."""
    so, ct = hydrography(gm, wet)
    rho = torch.where(wet, P.rho_teos10(so, ct, gm.z3d), torch.nan)
    return P.build_redi_operator(rho.float(), gm, wet)


def redi_bytes(cells: int, plane: int, coef_bytes: int, members: int, value_bytes: int) -> int:
    """K6's compulsory traffic: 15 coefficient fields, 2 planes and the wet
    mask read once, each member's chi read and its out written once."""
    return (15 * coef_bytes + 1 + 2 * members * value_bytes) * cells + 2 * plane * coef_bytes


# Operations per cell of one member, counted from the kernels' arithmetic:
# K6 forms 5 vertical and 6 horizontal derivatives (5 each), 6 face fluxes
# (7 to 11 each) and the divergence (6).
REDI_FLOPS = 111


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time on the published rates."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tracer_mass(chi: torch.Tensor, v: torch.Tensor) -> float:
    return float((chi.double() * v).sum())


def phase_density(P, card):
    """The 1-degree density path through the public API, counts reset just
    before and read just after. Returns the f64 grid, indices, the f64 R,
    the f32 T and R of the path, and the launches."""
    read = reset_launches()
    t0 = time.perf_counter()
    ds = P.synthetic_dataset(nx=NX, ny=NY, nz=NZ, topology="tripolar", seed=SEED)
    gm = P.makegridmetrics(  # no device=: the current CUDA device
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat, lev=ds.lev,
        lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices)
    require(gm.v3d.is_cuda and gm.v3d.dtype == torch.float64,
            f"makegridmetrics without device= made {gm.v3d.dtype} on {gm.v3d.device}")
    idx = P.makeindices(gm.v3d)
    wet, topo = idx.wet3d, gm.topology
    so, ct = hydrography(gm, wet)
    rho = P.rho_teos10(so, ct, gm.z3d)
    s_i, s_j = P.potential_density_slopes(P.rho_teos10, so, ct, gm, wet)
    umo, vmo = P.add_bolus_transports(ds.umo, ds.vmo, rho, gm, wet)
    phi = P.facefluxesfrommasstransport(umo=umo, vmo=vmo, gridmetrics=gm, indices=idx)
    ops = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx)
    T = P.assemble_T(umo, vmo, ds.mlotst, gm)
    R = P.build_redi_operator(torch.where(wet, rho, torch.nan).float(), gm, wet)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    rho_w = rho[wet]
    require(bool(torch.isfinite(rho_w).all()), "density not finite on wet cells")
    bolus = float(torch.nan_to_num(umo - torch.as_tensor(ds.umo, device=umo.device)).abs().max())
    require(bolus > 0, "the GM bolus transports are zero")
    T_ref = P.assemble_transport(umo, vmo, ds.mlotst, gm, wet).T
    k4_rel = max(rel_err(T[leg], ref[leg])[1] for ref in (T_ref, ops.T) for leg in T._fields)
    require(k4_rel <= TOL_F64, f"K4 on the bolus transports vs assemble_transport and "
            f"transportmatrix: {k4_rel:.3e}")
    tau_vol = float(P.operator_diagnostics(T, gm.v3d, wet, topo)["tau_vol_s"]) / (1e6 * YEAR_S)
    for k in ("ae", "an", "at", "g_t", "inv_v"):
        require(bool(torch.isfinite(getattr(R, k)).all()), f"R.{k} not finite")
    smax = max(float(torch.nan_to_num(s).abs().max()) for s in (s_i, s_j))
    log(f"[density] 1-degree {NX}x{NY}x{NZ} tripolar seed {SEED}, f64 grid on "
        f"{gm.v3d.device} (no device= given): rho in [{float(rho_w.min()):.3f}, "
        f"{float(rho_w.max()):.3f}] kg/m^3, max |S| {smax:.3e}, max |bolus umo| {bolus:.3e} kg/s; "
        f"K4 T vs assemble_transport and transportmatrix T max rel {k4_rel:.3e} (tol "
        f"{TOL_F64}); tau_vol "
        f"{tau_vol:.3e} Myr; set-up (grid, rho, slopes, bolus, T, R) {t_setup:.3f} s")
    del so, ct, s_i, s_j, phi, ops, T_ref, umo, vmo, rho, rho_w

    # 200 f32 steps of chi <- chi - dt T chi + dt R chi: K1 + K6
    T32, R32 = T.to(torch.float32), R.to(torch.float32)
    rate_t, rate_r = float(T.diag.abs().max()), P.redi_max_rate(R)
    dt = 0.25 / (rate_t + rate_r)
    v = torch.where(wet, gm.v3d, 0.0)
    rng = np.random.default_rng(SEED + 8)
    wet_np = wet.cpu().numpy()
    chis0 = torch.as_tensor(
        np.where(wet_np[None], 1.0 + 0.1 * rng.standard_normal((BATCH,) + wet_np.shape), 0.0),
        dtype=torch.float32, device=wet.device)
    step = lambda x: P.euler_step(T32, x, dt, topo) + dt * P.redi_apply_fused(R32, x)
    t0 = time.perf_counter()
    singles = []
    for m in range(BATCH):
        chi = chis0[m]
        for _ in range(DENSITY_STEPS):
            chi = step(chi)
        singles.append(chi)
    torch.cuda.synchronize()
    t_single = (time.perf_counter() - t0) / BATCH
    chi = singles[0]
    drift = abs(tracer_mass(chi, v) / tracer_mass(chis0[0], v) - 1.0)
    moved = float((chi - P.euler_propagate(T32, chis0[0], dt, DENSITY_STEPS, topo)).abs().max())
    require(bool(torch.isfinite(chi).all()), "T + R tracer not finite")
    require(bool((chi[~wet] == 0).all()), "T + R tracer nonzero on land")
    require(drift < TOL_MASS_F32, f"T + R mass drift {drift:.3e} >= {TOL_MASS_F32}")
    require(moved > 0, "the Redi part did not change the tracer")
    log(f"[density] {DENSITY_STEPS} f32 steps of chi - dt T chi + dt R chi (K1 + K6) at dt = "
        f"0.25 / (max|diag T| {rate_t:.4e} + redi_max_rate(R) {rate_r:.4e}) = {dt:.6g} s: "
        f"{t_single:.3f} s wall, relative tracer-mass drift {drift:.3e} (bound {TOL_MASS_F32}), "
        f"max |with R - without R| {moved:.3e}")

    stepm = lambda x: (P.euler_step_multi(T32, x, dt, topo)
                       + dt * P.redi_apply_fused_multi(R32, x))
    t0 = time.perf_counter()
    chis = chis0
    for _ in range(DENSITY_STEPS):
        chis = stepm(chis)
    torch.cuda.synchronize()
    t_multi = time.perf_counter() - t0
    for m in range(BATCH):
        require(torch.equal(chis[m], singles[m]), f"batched T + R member {m} differs from the "
                f"single-tracer run")
    drift_b = max(abs(tracer_mass(chis[m], v) / tracer_mass(chis0[m], v) - 1.0)
                  for m in range(BATCH))
    require(drift_b < TOL_MASS_F32, f"batched T + R mass drift {drift_b:.3e}")
    log(f"[density] {BATCH} f32 tracers x {DENSITY_STEPS} steps on K5 + K6 (batch): "
        f"{t_multi:.3f} s wall ({BATCH} single runs: {t_single * BATCH:.3f} s); every member "
        f"equal to its single-tracer run bit for bit; worst mass drift {drift_b:.3e}")
    del chis, singles, chi

    # the bf16 operator: K6 in (bf16, f32)
    Rb = P.redi_operator_to_bf16(R32)
    x = chis0[0]
    got = P.redi_apply_fused(Rb, x)
    err = rel_err(got, P.redi_apply(Rb, x))[0]
    exact = P.redi_apply(R, x.double())
    _, rel_exact = rel_err(got, exact)
    require(err <= TOL_K6, f"bf16 K6 vs plain of the rounded operator: max abs {err:.3e}")
    require(rel_exact <= TOL_REDI_BF16, f"bf16 K6 vs exact apply: {rel_exact:.3e}")
    log(f"[density] bf16 R: K6 (bf16, f32) equals the plain apply of the rounded operator "
        f"(max abs {err:.1e}); against the exact f64 apply max rel {rel_exact:.3e} (bound "
        f"{TOL_REDI_BF16})")
    del Rb, got, exact, chis0

    launches = read()
    log(f"[launches] density path: {launches}")
    for name in ("K1", "K4", "K5", "K6", "K6 multi"):
        require(launches[name] > 0, f"{name} was not launched on the density path")
    return gm, idx, R, T32, R32, launches


def phase_k6_checks(P, device, cases):
    """K6 against its plain version in every type pair, the batches of 4
    and 8 against K6 member by member and against plain, and R's
    invariants through the kernel in f64. Returns the largest error."""
    worst = 0.0
    for kind, R, gm, wet in cases:
        size = "x".join(map(str, gm.topology.shape3d[::-1]))
        gen = torch.Generator(device=device).manual_seed(SEED + 9)
        x64 = torch.where(wet, torch.randn(wet.shape, generator=gen, device=device,
                                           dtype=torch.float64), torch.nan)  # NaN on land
        for ctype, vtype in REDI_TYPES:
            op = R.to(DTYPES[ctype])
            x = x64.to(DTYPES[vtype])
            got = P.redi_apply_fused(op, x)
            require(bool(torch.isfinite(got).all()), f"K6 {kind} ({ctype},{vtype}) not finite")
            err = rel_err(got, P.redi_apply(op, x))[0]
            for nb in (REGIONS, BATCH):
                xs = torch.where(wet, torch.randn((nb,) + tuple(wet.shape), generator=gen,
                                                  device=device, dtype=DTYPES[vtype]), 0.0)
                gotm = P.redi_apply_fused_multi(op, xs)
                err = max(err, rel_err(gotm, P.redi_apply(op, xs))[0])
                for m in range(nb):
                    require(torch.equal(gotm[m], P.redi_apply_fused(op, xs[m])),
                            f"K6 batch {kind} ({ctype},{vtype}) B = {nb}: member {m} differs "
                            f"from K6")
                del xs, gotm
            require(err <= TOL_K6, f"K6 {kind} ({ctype},{vtype}): max abs {err:.3e} > {TOL_K6}")
            worst = max(worst, err)
            log(f"[K6] {kind} {size} ({ctype},{vtype}): equal to the plain version (NaN on land "
                f"masked), and B = {REGIONS} and {BATCH} equal to K6 member by member and to "
                f"plain; max abs {err:.1e}")
            del op, x, got
        v = torch.where(wet, gm.v3d, 0.0)
        x = torch.nan_to_num(x64)
        tend = P.redi_apply_fused(R, x)
        cons = abs(float((tend * v).sum())) / float((tend * v).abs().sum())
        null = float(P.redi_apply_fused(R, torch.where(wet, 7.5, 0.0).double()).abs().max())
        require(cons < 1e-12, f"K6 {kind}: volume integral of R chi, relative {cons:.3e}")
        require(null <= 1e-12 * float(tend.abs().max()), f"K6 {kind}: R 7.5 = {null:.3e}")
        log(f"[K6] {kind} {size} f64 invariants: |sum v R chi| / sum |v R chi| = {cons:.3e} "
            f"(bound 1e-12), max |R const| = {null:.3e}")
        del x64, x, tend, v
        torch.cuda.empty_cache()
    return worst


def phase_k6_times(P, card, R32, wet):
    """CUDA-event times at the density path's shape, f32: K6 and its plain
    version, the bf16 K6 and its plain version, and K6 on a batch of B = 1,
    2, 4, 8 beside B launches of K6."""
    size = "x".join(map(str, R32.topology.shape3d[::-1]))
    gen = torch.Generator(device=wet.device).manual_seed(SEED + 10)
    x = torch.where(wet, torch.randn(wet.shape, generator=gen, device=wet.device), 0.0)
    Rb = P.redi_operator_to_bf16(R32)
    times = {
        "K6": time_pair(lambda: P.redi_apply_fused(R32, x), lambda: P.redi_apply(R32, x), 50, 5),
        "K6 bf16": time_pair(lambda: P.redi_apply_fused(Rb, x), lambda: P.redi_apply(Rb, x),
                             50, 5),
    }
    for name in ("K6", "K6 bf16"):
        log(f"[time] {name} at {size} f32 values: kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms per call (CUDA events over back-to-back calls, median "
            f"of 5; card {card})")
    for nb in (1, 2, 4, BATCH):
        xs = torch.where(wet, torch.randn((nb,) + tuple(wet.shape), generator=gen,
                                          device=wet.device), 0.0)
        fns = {"K6 batch": lambda: P.redi_apply_fused_multi(R32, xs),
               "B x K6": lambda: [P.redi_apply_fused(R32, y) for y in xs]}
        calls = {"K6 batch": 20, "B x K6": 20}
        if nb == BATCH:
            fns["plain"], calls["plain"] = lambda: P.redi_apply(R32, xs), 3
        t = times[nb] = time_set(fns, calls)
        log(f"[time] K6 at {size} f32, B = {nb}: one batched launch {t['K6 batch']:.4f} ms, "
            f"{nb} launches {t['B x K6']:.4f} ms"
            + (f", plain {t['plain']:.4f} ms" if "plain" in t else "")
            + f" per call; per tracer {t['K6 batch'] / nb:.4f} ms against "
            f"{t['B x K6'] / nb:.4f} ms (card {card})")
        del xs
    del Rb, x
    return times


def phase_library(P, card, T, idx, topo):
    """The PyTorch library call that computes K1's and K5's function: the
    CSR matrix of T on wet cells (coeffs_to_scipy -> torch.sparse_csr_tensor)
    times one vector, and times an (N, B) matrix; f32, CUDA events."""
    wet = idx.wet3d
    mat = P.coeffs_to_scipy(T, idx, topo)
    dev = wet.device
    A = torch.sparse_csr_tensor(torch.as_tensor(mat.indptr, dtype=torch.int64),
                                torch.as_tensor(mat.indices, dtype=torch.int64),
                                torch.as_tensor(mat.data, dtype=torch.float32),
                                size=mat.shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    chis = torch.where(wet, torch.randn((BATCH,) + tuple(wet.shape), generator=gen, device=dev),
                       0.0)
    x = chis[0][wet].contiguous()
    X = chis[:, wet].T.contiguous()
    err1 = rel_err(A @ x, P.stencil_apply(T, chis[0], topo)[wet])[1]
    err5 = rel_err(A @ X, P.stencil_apply_multi(T, chis, topo)[:, wet].T)[1]
    require(max(err1, err5) <= TOL_LIBRARY, f"CSR product vs K1/K5: {err1:.3e} {err5:.3e}")
    t1 = cuda_ms(lambda: A @ x, 50)
    t5 = cuda_ms(lambda: A @ X, 20)
    log(f"[library] CSR T ({mat.shape[0]} wet rows, {mat.nnz} entries, f32) @ chi at "
        f"{NX}x{NY}x{NZ}: {t1:.4f} ms (max rel vs K1 {err1:.2e}); @ (N, {BATCH}): {t5:.4f} ms "
        f"(max rel vs K5 {err5:.2e}) (CUDA events, median of 5; card {card})")
    del A, chis, x, X
    return {"K1": t1, "K5": t5}


def phase_k6_quarter(P, card, cases):
    """K6 and its batch of 2 against K6 member by member and against plain,
    f32, at 0.25 degrees and 720x540x75; K6 and plain timed on the first."""
    times = None
    for kind, gm, wet in cases:
        size = "x".join(map(str, gm.topology.shape3d[::-1]))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        R = redi_of(P, gm, wet)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        require(R.ae.dtype == torch.float32, f"0.25-degree R is {R.ae.dtype}")
        gen = torch.Generator(device=wet.device).manual_seed(SEED + 12)
        xs = torch.where(wet, torch.randn((2,) + tuple(wet.shape), generator=gen,
                                          device=wet.device), 0.0)
        got = P.redi_apply_fused(R, xs[0])
        err = rel_err(got, P.redi_apply(R, xs[0]))[0]
        gotm = P.redi_apply_fused_multi(R, xs)
        require(torch.equal(gotm[0], got) and torch.equal(gotm[1], P.redi_apply_fused(R, xs[1])),
                f"K6 batch {kind} {size}: members differ from K6")
        err = max(err, rel_err(gotm, P.redi_apply(R, xs))[0])
        require(bool(torch.isfinite(gotm).all()), f"K6 {kind} {size} not finite")
        require(err <= TOL_K6, f"K6 {kind} {size} f32: max abs {err:.3e} > {TOL_K6}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"[K6] {kind} {size} f32: R built in {t_build:.3f} s; K6 and the batch of 2 equal to "
            f"the plain version and K6 member by member (max abs {err:.1e}); peak memory "
            f"{peak:.1f} GB (torch.cuda.max_memory_allocated; card {card})")
        del got, gotm
        if times is None:
            x = xs[0]
            times = time_pair(lambda: P.redi_apply_fused(R, x), lambda: P.redi_apply(R, x), 20, 3)
            log(f"[time] K6 at {size} f32: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms per "
                f"call (CUDA events over back-to-back calls, median of 5; card {card})")
            del x
        del R, xs
        torch.cuda.empty_cache()
    return times


def log_rates(rows: list, gbps: float) -> None:
    """Each kernel's rate on its compulsory bytes, as a fraction of K10's
    measured bandwidth, beside its bound on the published rate."""
    for name, size, nbytes, ms in rows:
        rate = nbytes / (ms * 1e-3) / 1e9
        log(f"[roofline] {name} at {size}: {nbytes / 1e9:.4f} GB compulsory in {ms:.4f} ms = "
            f"{rate:.1f} GB/s, {100 * rate / gbps:.1f} % of K10's {gbps:.1f} GB/s (bound at "
            f"K10's rate {nbytes / gbps / 1e6:.4f} ms, at 3.35 TB/s {nbytes / PEAK_BYTES * 1e3:.4f} "
            f"ms)")


# ----------------------------------------------------------------------------
# The sharded phase: four ranks on one card, gloo with host-staged halos.

# (ny_dev, nx_dev): at 1 degree, shards of 150x180 and of 300x90; (1, 4)
# has the mirror pairs 0-3 and 1-2 and no y neighbours.
# --- GMRES, the implicit step, autodiff, coarsening and the utilities ---

# The implicit Euler step at 1 degree: f64, dt = 1 year, BiCGStab(1) (the
# function's default) at tol TOL_IMPLICIT (its default). BiCGStab stops on
# its recurrence residual, from which the true one drifts in f64 (2.1e-10 to
# 2.6e-10 at tol 1e-10 on an H100), so the true residual is held to
# TOL_IMPLICIT_TRUE. (GMRES(30) stagnates on this system: 0.81 after 1200
# Arnoldi steps; scripts/gmres_study.py.) The upwind T conserves
# volume-weighted tracer to rounding (v'T ~ 0), so a step keeps the tracer
# mass to the solve's residual: TOL_IMPLICIT_MASS.
TOL_IMPLICIT = 1e-10
TOL_IMPLICIT_TRUE = 1e-9
TOL_IMPLICIT_MASS = 1e-8
# The autodiff rules against torch's autograd through the plain apply (f64):
# the same products, summed in another order.
TOL_AD = 1e-12
# The kappa_h gradient against a central difference (tests/test_autodiff.py:206).
TOL_KAPPA_FD = 2e-3
# The sharded adjoint against the single-device one, after scaling by each
# array's largest value (tests/test_autodiff.py:246-255).
TOL_ADJ_RTOL, TOL_ADJ_ATOL = 1e-3, 5e-4
TOL_ADJ_SOLVE = 1e-12
COARSE = (90, 75, 50)  # (nx, ny, nz): the coarsened age's grid (1-degree depth)
# A purely vertical operator coarsened 2x2x1 reproduces the fine ages
# (tests/test_coarsen.py:223).
TOL_COARSE_VERTICAL = 1e-8


def _kernel_share(prof, classes: dict) -> tuple[dict, float, list]:
    """Device ms by class of kernel name (the first class whose words a
    name contains, case-insensitive; "other" else), the total, and the six
    longest kernels by name."""
    from torch.autograd import DeviceType

    by, names = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        names[e.name] = names.get(e.name, 0.0) + ms
        low = e.name.lower()
        cls = next((c for c, words in classes.items() if any(w in low for w in words)), "other")
        by[cls] = by.get(cls, 0.0) + ms
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return by, sum(by.values()), [(n[:70], round(ms, 4)) for n, ms in top]


def phase_gmres(P, card, gm, idx, T, mean_age_b1: float, mean_seq_b2: float) -> dict:
    """At 1 degree: the refined ideal age and sequestration time with
    GMRES(30) inner solves (K1 + K2; f64 defects through K1), counts reset
    before and read after, held to the run's BiCGStab results; then the
    device time of two GMRES cycles under torch.profiler, by kernel class
    (the Arnoldi projections are cuBLAS matrix-vector products)."""
    wet, topo = idx.wet3d, gm.topology
    out = {}
    for name, fn, ref, ref_name in (
            ("ideal_age", P.ideal_age, mean_age_b1, "BiCGStab(1)"),
            ("sequestration_time", P.sequestration_time, mean_seq_b2, "BiCGStab(2)")):
        read = reset_launches()
        stats = {}
        t0 = time.perf_counter()
        g, res = fn(T, wet, topo, tol=TOL_AGE, refine=True, algorithm="gmres", stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read()
        log_passes(f"{name} gmres", stats)
        steps = sum(p.get("inner_iters") or 0 for p in stats["passes"])
        ok = bool(torch.isfinite(g[wet]).all()) and bool((g[wet] > 0).all())
        mean = mean_years(g, gm.v3d, wet) if ok else float("nan")
        rel = abs(mean - ref) / abs(ref)
        log(f"[{name} gmres] 1-degree refined, GMRES(30) inner on K1 + K2, tol {TOL_AGE}: "
            f"relative residual {res:.3e} after {stats['refinements']} passes, {steps} Arnoldi "
            f"steps (one K1 matvec and one K2 solve each), {wall:.3f} s wall, mean "
            f"{mean:.9f} yr vs {ref_name} {ref:.9f} yr (rel {rel:.3e}, bound {TOL_MEAN_AGE}); "
            f"launches {counts} (card {card})")
        require(ok, f"GMRES {name} not finite and positive")
        require(res <= TOL_AGE, f"GMRES {name} residual {res:.3e} > {TOL_AGE}")
        require(rel <= TOL_MEAN_AGE, f"GMRES {name} mean {mean:.9f} vs {ref_name} {ref:.9f}: "
                f"{rel:.3e} > {TOL_MEAN_AGE}")
        require(counts["K1"] > 0 and counts["K2"] > 0 and counts["K3"] == 0,
                f"GMRES {name} launches {counts}: K1 and K2 expected, no K3")
        out[name] = dict(wall=wall, passes=stats["refinements"], steps=steps, res=res)
    # two cycles of an f32 inner solve: where the device time goes
    from torch.profiler import ProfilerActivity, profile

    from otmb_tpu_torch.models.solvers import GMRES_RESTART

    surf, b = surface_mask(wet, torch.float32), wet.to(torch.float32)
    run = lambda: P.solve_shifted_chunked(T, b, topo, extra_diag=surf, tol=1e-30,
                                          maxiter=2 * GMRES_RESTART, algorithm="gmres",
                                          early_stop=False)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by, total, top = _kernel_share(prof, {
        "projections (gemv/gemm)": ("gemv", "gemm"), "K1": ("stencil",), "K2": ("tridiag",),
        "dots and norms": ("dot", "reduce", "norm")})
    log(f"[gmres profile] two GMRES(30) cycles at {NX}x{NY}x{NZ} f32 (60 Arnoldi steps), "
        f"torch.profiler: {wall * 1e3:.3f} ms wall, {total:.3f} device ms: "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f} %)" for k, v in sorted(by.items()))
        + f"; longest kernels {top} (card {card})")
    out["profile"] = dict(by=by, total=total, wall=wall)
    return out


def phase_implicit(P, card, gm, idx, T64) -> None:
    """At 1 degree, f64: one implicit Euler step of dt = 1 year (K1 + K2,
    counted), its residual and the volume-weighted tracer mass across it."""
    wet, topo = idx.wet3d, gm.topology
    v = torch.where(wet, gm.v3d, 0.0).double()
    rng = np.random.default_rng(SEED + 7)
    chi = torch.as_tensor(np.where(wet.cpu().numpy(), 1.0 + 0.1 * rng.standard_normal(wet.shape),
                                   0.0), dtype=torch.float64, device=wet.device)
    m0 = float((chi * v).sum())
    read = reset_launches()
    t0 = time.perf_counter()
    x, res = P.implicit_euler_step(T64, chi, YEAR_S, topo, tol=TOL_IMPLICIT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read()
    drift = abs(float((x * v).sum()) - m0) / abs(m0)
    log(f"[implicit] 1-degree f64 implicit Euler step, dt = 1 yr, BiCGStab(1) at tol "
        f"{TOL_IMPLICIT}: true relative residual {res:.3e} (bound {TOL_IMPLICIT_TRUE}), "
        f"tracer-mass drift {drift:.3e} (bound {TOL_IMPLICIT_MASS}), {wall:.3f} s wall; "
        f"launches K1 {counts['K1']} K2 {counts['K2']} (card {card})")
    require(bool(torch.isfinite(x).all()) and bool((x[~wet] == 0).all()),
            "implicit step not finite, or nonzero on land")
    require(res <= TOL_IMPLICIT_TRUE, f"implicit step residual {res:.3e} > {TOL_IMPLICIT_TRUE}")
    require(drift <= TOL_IMPLICIT_MASS, f"implicit step mass drift {drift:.3e}")
    require(counts["K1"] > 0 and counts["K2"] > 0, f"implicit step launches {counts}")


def _grads(P, loss, T, chi):
    """The gradients of loss(coeffs, chi) for chi and the seven legs."""
    c = P.StencilCoeffs(*(leg.clone().requires_grad_(True) for leg in T))
    x = chi.clone().requires_grad_(True)
    loss(c, x).backward()
    return [x.grad, *(leg.grad for leg in c)]


def phase_autodiff(P, card, ds, gm, idx, T64) -> None:
    """At 1 degree, f64: the gradients of apply_stencil_ad and of a 3-step
    euler_step_ad chain (K1 forward, K1 on T' backward) against torch's
    autograd through the plain apply, for chi and all seven legs; then the
    kappa_h gradient of sum(w * x(kappa_h)) through the plain
    assemble_transport and differentiable_solve, against a central
    difference."""
    wet, topo = idx.wet3d, gm.topology
    rng = np.random.default_rng(SEED + 21)
    field = lambda: torch.as_tensor(np.where(wet.cpu().numpy(), rng.standard_normal(wet.shape),
                                             0.0), dtype=torch.float64, device=wet.device)
    chi, w = field(), field()
    dt = 0.25 / float(T64.diag.abs().max())

    def chain(step):
        def run(c, x):
            for _ in range(3):
                x = step(c, x)
            return x
        return run

    cases = {
        "apply_stencil_ad": (lambda c, x: P.apply_stencil_ad(c, x, topo),
                             lambda c, x: P.apply_stencil(c, x, topo), 2),
        "euler_step_ad x3": (chain(lambda c, x: P.euler_step_ad(c, x, dt, topo)),
                             chain(lambda c, x: x - dt * P.apply_stencil(c, x, topo)), 6),
    }
    for name, (ad, plain, k1) in cases.items():
        read = reset_launches()
        t0 = time.perf_counter()
        g = _grads(P, lambda c, x: (w * ad(c, x) ** 2).sum(), T64, chi)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read()
        ref = _grads(P, lambda c, x: (w * plain(c, x) ** 2).sum(), T64, chi)
        worst = max(rel_err(a, b)[1] for a, b in zip(g, ref))
        log(f"[autodiff] {name} at {NX}x{NY}x{NZ} f64: chi and 7 leg gradients vs autograd "
            f"through the plain apply, max rel {worst:.3e} (bound {TOL_AD}); forward + backward "
            f"{wall * 1e3:.3f} ms, K1 launches {counts['K1']} (card {card})")
        require(worst <= TOL_AD, f"{name} gradients differ from plain autograd by {worst:.3e}")
        require(counts["K1"] == k1, f"{name}: {counts['K1']} K1 launches, {k1} expected")

    umo, vmo = (torch.as_tensor(np.nan_to_num(a), dtype=torch.float64, device=wet.device)
                for a in (ds.umo, ds.vmo))
    b = wet.double()
    solve = P.differentiable_solve(topo, tol=1e-12)

    def loss(kappa_h):
        T = P.assemble_transport(umo, vmo, ds.mlotst, gm, wet, kappa_h=kappa_h).T
        return (w * solve(T, b, 1e-5, None)).sum()

    k = torch.tensor(500.0, dtype=torch.float64, device=wet.device, requires_grad=True)
    t0 = time.perf_counter()
    L = loss(k)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    L.backward()
    torch.cuda.synchronize()
    t_adj = time.perf_counter() - t0
    g = float(k.grad)
    with torch.no_grad():
        f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=wet.device)
        fd = float((loss(f64(505.0)) - loss(f64(495.0))) / 10.0)
    rel = abs(g - fd) / max(abs(fd), abs(g))
    log(f"[autodiff] kappa_h gradient at {NX}x{NY}x{NZ} f64 through assemble_transport and "
        f"differentiable_solve (tol 1e-12): {g:.9e} vs central difference {fd:.9e} (rel "
        f"{rel:.3e}, bound {TOL_KAPPA_FD}); forward (assembly + solve) {t_fwd:.3f} s, adjoint "
        f"(one transpose solve + cotangents + assembly backward) {t_adj:.3f} s (card {card})")
    require(rel <= TOL_KAPPA_FD, f"kappa_h gradient {g:.6e} vs FD {fd:.6e}: {rel:.3e}")


# Samples a process's resident size from /proc/<pid>/statm every 5 ms until
# its stdin closes, then prints the largest in bytes (-1 without statm).
_RSS_SAMPLER = """
import os, select, sys
path, page, peak = f"/proc/{sys.argv[1]}/statm", os.sysconf("SC_PAGE_SIZE"), 0
while True:
    try:
        with open(path) as f:
            peak = max(peak, int(f.read().split()[1]) * page)
    except (OSError, ValueError, IndexError):
        peak = -1
        break
    if select.select([sys.stdin], [], [], 0.005)[0]:
        break
print(peak)
"""


def _with_peak_rss(fn):
    """fn() while a sampler process reads this process's resident size every
    5 ms: returns (fn's result, the peak resident GB sampled, NaN where
    /proc has no statm)."""
    import os

    sampler = subprocess.Popen([sys.executable, "-c", _RSS_SAMPLER, str(os.getpid())],
                               stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        peak = int(sampler.communicate("", timeout=60)[0].strip() or -1)
    return out, (peak / 1e9 if peak >= 0 else float("nan"))


def phase_coarsen(P, card, device, gm, idx, T) -> None:
    """LUMP/SPRAY coarsening, host scipy work with the C++ labelling core:
    at 1 degree, lump_and_spray 2x2x1 of T; at 90x75x50, the native labels
    against the Python labeller's, the coarsened ideal age end to end (wall
    and peak host memory) beside the refined fine age on the card, and the
    vertical invariant."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve

    from otmb_tpu_torch.grid.indices import wet_vector
    from otmb_tpu_torch.models.transport import buildTkVdeep, buildTkVML
    from otmb_tpu_torch.utils import coarsen as C

    topo = gm.topology
    t0 = time.perf_counter()
    C.load_native()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    mat = P.coeffs_to_scipy(T, idx, topo)
    t_export = time.perf_counter() - t0
    wet = idx.wet3d.cpu().numpy()
    v = wet_vector(np.nan_to_num(gm.v3d.double().cpu().numpy()), idx)
    t0 = time.perf_counter()
    lump, spray, vol_c = C.lump_and_spray(wet, v, mat, di=2, dj=2, dk=1)
    t_lump = time.perf_counter() - t0
    log(f"[coarsen] 1-degree lump_and_spray 2x2x1 (native core, g++ build {t_build:.3f} s): "
        f"{idx.nwet} -> {lump.shape[0]} cells, {t_lump:.3f} s host (T exported in "
        f"{t_export:.3f} s); volume kept to {abs(vol_c.sum() - v.sum()) / v.sum():.1e}")
    require(0 < lump.shape[0] < idx.nwet and abs(vol_c.sum() - v.sum()) <= 1e-12 * v.sum(),
            "1-degree LUMP/SPRAY sizes or volumes wrong")
    del mat, lump, spray

    cnx, cny, cnz = COARSE
    cds, cgm, cidx = build_case(P, cnx, cny, cnz, "tripolar", torch.float64, device)
    cT = P.assemble_T(cds.umo, cds.vmo, cds.mlotst, cgm)
    cwet = cidx.wet3d.cpu().numpy()
    cv = wet_vector(np.nan_to_num(cgm.v3d.cpu().numpy()), cidx)
    cmat = P.coeffs_to_scipy(cT, cidx, cgm.topology)
    t0 = time.perf_counter()
    l_c, s_c, v_c = C.lump_and_spray(cwet, cv, cmat)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    l_p, s_p, v_p = C.lump_and_spray(cwet, cv, cmat, use_native=False)
    t_python = time.perf_counter() - t0
    same = (l_c - l_p).count_nonzero() == 0 and (s_c != s_p).nnz == 0 and np.array_equal(v_c, v_p)
    log(f"[coarsen] {cnx}x{cny}x{cnz}: native labels equal the Python labeller's: {same} "
        f"({cidx.nwet} -> {l_c.shape[0]} cells; native {t_native:.3f} s, Python "
        f"{t_python:.3f} s)")
    require(same, "native and Python LUMP/SPRAY differ")
    del l_p, s_p

    def coarsened():
        t0 = time.perf_counter()
        out = P.ideal_age_coarsened(cT, cidx, cgm.topology, cgm.v3d)
        return out, time.perf_counter() - t0

    _, before = _with_peak_rss(lambda: None)
    ((g3, g_c, _), t_coarse), peak = _with_peak_rss(coarsened)
    fine, res = P.ideal_age(cT.to(torch.float32), cidx.wet3d, cgm.topology, tol=TOL_AGE,
                            refine=True)
    mean_c = float(cv @ g3[cwet]) / cv.sum() / YEAR_S
    mean_f = mean_years(fine, cgm.v3d, cidx.wet3d)
    log(f"[coarsen] {cnx}x{cny}x{cnz} ideal_age_coarsened 2x2x1 ({len(g_c)} coarse unknowns, "
        f"scipy spsolve): {t_coarse:.3f} s host, peak resident size of this process during "
        f"the call {peak:.3f} GB ({before:.3f} GB before it; sampled every 5 ms); volume-mean "
        f"age {mean_c:.6f} yr, refined fine "
        f"age on the card {mean_f:.6f} yr (residual {res:.3e}), ratio {mean_c / mean_f:.6f}")
    require(np.isfinite(g3[cwet]).all() and (g3[cwet] > 0).all() and np.isnan(g3[~cwet]).all(),
            "coarsened age not finite and positive on wet cells")
    require(res <= TOL_AGE, f"{cnx}x{cny}x{cnz} refined age residual {res:.3e}")

    tv = P.add_coeffs(buildTkVdeep(gridmetrics=cgm, indices=cidx),
                      buildTkVML(mlotst=cds.mlotst, gridmetrics=cgm, indices=cidx))
    mat_v = P.coeffs_to_scipy(tv, cidx, cgm.topology)
    issrf = cwet.copy()
    issrf[1:] = False
    m = sp.diags(wet_vector(issrf.astype(float), cidx))
    t0 = time.perf_counter()
    gv_fine = spsolve((mat_v + m).tocsc(), np.ones(mat_v.shape[0]))
    gv_c, _, _ = P.ideal_age_coarsened(tv, cidx, cgm.topology, cgm.v3d)
    t_v = time.perf_counter() - t0
    gap = float(np.abs(gv_c[cwet] - gv_fine).max() / np.abs(gv_fine).max())
    log(f"[coarsen] vertical invariant at {cnx}x{cny}x{cnz}: the vertical operator coarsened "
        f"2x2x1 vs its fine direct solve, max rel {gap:.3e} (bound {TOL_COARSE_VERTICAL}), "
        f"{t_v:.3f} s host")
    require(gap <= TOL_COARSE_VERTICAL, f"vertical invariant broken: {gap:.3e}")


def phase_utilities(P, card, gm, idx, T) -> None:
    """At 1 degree, f32: the checkpoint round trip of T back onto the card,
    the operator validator, and a roofline report of K1's Euler step
    against K10's rate measured on this card."""
    import tempfile

    from otmb_tpu_torch.utils import profiling

    topo, wet = gm.topology, idx.wet3d
    with tempfile.TemporaryDirectory(prefix="otmb_ckpt_") as tmp:
        path = Path(tmp) / "T.npz"
        t0 = time.perf_counter()
        P.save_operator(path, T, topo)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, topo2, _ = P.load_operator(path, device=T.diag.device)
        t_load = time.perf_counter() - t0
        size = path.stat().st_size / 1e6
    same = topo2 == topo and all(a.dtype == b.dtype and torch.equal(a, b)
                                 for a, b in zip(back, T))
    log(f"[checkpoint] 1-degree f32 T saved ({size:.1f} MB npz, {t_save:.3f} s) and loaded "
        f"back onto {back.diag.device} ({t_load:.3f} s): bit for bit {same}")
    require(same, "checkpoint round trip changed T")
    val = P.validate_operator(T, gm.v3d, wet, topo)
    myr = 1e6 * YEAR_S
    log(f"[validate] 1-degree T: {val}; tau_div {val.tau_div_s / myr:.3e} Myr, tau_vol "
        f"{val.tau_vol_s / myr:.3e} Myr")
    require(val.ok_upwind, f"validate_operator: {val}")
    dt = 0.25 / float(T.diag.abs().max())
    chi = wet.to(torch.float32)
    rep = P.roofline_report(lambda c: P.euler_step(T, c, dt, topo), chi,
                            profiling.stencil_bytes(topo.shape3d, 4), nsteps=100)
    log(f"[roofline] K1 Euler step at {NX}x{NY}x{NZ} f32 (roofline_report, peak = K10 "
        f"measured now): {rep}; {rep.achieved_gbps:.1f} of {rep.peak_gbps:.1f} GB/s "
        f"(card {card})")
    require(rep.fraction_of_peak is not None and 0 < rep.fraction_of_peak,
            f"roofline report without a K10 rate: {rep}")


EXAMPLES = ("end_to_end", "water_masses", "density_pipeline", "calibrate_kappa")
EXAMPLE_TIMEOUT_S = 300


def start_examples() -> dict:
    """Start `python -m otmb_tpu_torch demo` and the four examples
    (`python -m otmb_tpu_torch.examples.<name>`) as processes on the
    current CUDA device, all together; `finish_examples` collects them."""
    root = Path(__file__).resolve().parent
    cmds = {"demo": [sys.executable, "-m", "otmb_tpu_torch", "demo"]}
    cmds.update({name: [sys.executable, "-m", f"otmb_tpu_torch.examples.{name}"]
                 for name in EXAMPLES})
    return {name: (time.perf_counter(), subprocess.Popen(
        cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, cmd in cmds.items()}


def finish_examples(procs: dict, card: str) -> None:
    """Wait for the processes of `start_examples`, each within
    EXAMPLE_TIMEOUT_S (killed past it); require exit 0 from each and log
    the lines it printed."""
    failed = []
    for name, (t0, proc) in procs.items():
        try:
            out, err = proc.communicate(timeout=max(1.0, t0 + EXAMPLE_TIMEOUT_S
                                                    - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        wall = time.perf_counter() - t0
        what = "python -m otmb_tpu_torch demo" if name == "demo" else (
            f"python -m otmb_tpu_torch.examples.{name}")
        log(f"[examples] {what}: exit {proc.returncode}, {wall:.3f} s wall from its start "
            f"(all five run at once on the card; card {card})")
        for line in out.strip().splitlines():
            log(f"[examples]   {name} | {line}")
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}): {err.strip()[-2000:]}")
    require(not failed, "examples failed: " + " | ".join(failed))


def phase_cli(P, card, ds, mean_age: float, mean_seq: float, fractions: torch.Tensor) -> None:
    """The CLI at 1 degree through `otmb_tpu_torch.__main__.main`, on the
    current CUDA device: the synthetic fields (seed 0) to an npz, then
    build, diagnose, idealage --refine (and --adjoint) and fractions
    --bands 4, each required to exit 0. The mean age and sequestration
    time are held to the API's (the main path's and the refined
    sequestration's) within TOL_MEAN_AGE, the band fractions to the
    converged f64 fractions of the batched phase within FRACTION_SLACK;
    the solves' launches are counted."""
    import tempfile

    from otmb_tpu_torch.__main__ import main as cli

    def run(*argv) -> tuple[float, dict]:
        read = reset_launches()
        t0 = time.perf_counter()
        rc = cli([str(a) for a in argv])
        torch.cuda.synchronize()
        wall, counts = time.perf_counter() - t0, {k: v for k, v in read().items() if v}
        log(f"[cli] python -m otmb_tpu_torch {' '.join(str(a) for a in argv)}: exit {rc}, "
            f"{wall:.3f} s; launches {counts}")
        require(rc == 0, f"the CLI's {argv[0]} exited {rc}")
        return wall, counts

    with tempfile.TemporaryDirectory(prefix="otmb_cli_") as tmp:
        tmp = Path(tmp)
        fields, op = tmp / "in.npz", tmp / "op.npz"
        t0 = time.perf_counter()
        np.savez(fields, areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
                 lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
                 umo=np.nan_to_num(ds.umo), vmo=np.nan_to_num(ds.vmo), mlotst=ds.mlotst)
        log(f"[cli] 1-degree synthetic fields (seed {SEED}) written to an npz "
            f"({fields.stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.3f} s")
        run("build", fields, op)
        log(f"[cli] operator file {op.stat().st_size / 1e6:.1f} MB")
        run("diagnose", op)
        _, extras = P.load_operator(op, device="cpu")[1:]
        wet = torch.as_tensor(extras["wet3d"].astype(bool))
        v3d = torch.as_tensor(extras["v3d"])
        for argv, want, what in ((("--refine",), mean_age, "ideal age"),
                                 (("--refine", "--adjoint"), mean_seq, "sequestration time")):
            out = tmp / "age.npz"
            _, counts = run("idealage", op, out, *argv)
            require(counts.get("K1", 0) > 0 and counts.get("K2", 0) > 0,
                    f"the CLI's {what} launched {counts}: expected K1 and K2")
            gamma = torch.as_tensor(P.load_state(out)["ideal_age_seconds"])
            got = mean_years(gamma, v3d, wet)
            rel = abs(got - want) / abs(want)
            log(f"[cli] {what} (f64 operator of `build`, refined): mean {got:.9f} yr vs the "
                f"API's {want:.9f} yr on the f32 K4 operator (rel {rel:.3e}, bound "
                f"{TOL_MEAN_AGE})")
            require(rel <= TOL_MEAN_AGE, f"the CLI's {what} {got:.9f} yr vs the API's "
                    f"{want:.9f}: {rel:.3e} > {TOL_MEAN_AGE}")
        out = tmp / "fr.npz"
        _, counts = run("fractions", op, out, "--bands", REGIONS)
        require(counts.get("K5", 0) > 0 and counts.get("K2", 0) > 0 and not counts.get("K1"),
                f"the CLI's fractions launched {counts}: expected K5 and K2, and no K1")
        state = P.load_state(out)
        fr = torch.as_tensor(state["fractions"])
        require(list(state["band_edges"]) == [r * NY // REGIONS for r in range(REGIONS + 1)],
                f"the CLI's band edges {state['band_edges']}")
        gap = float((fr[:, wet] - fractions[:, wet]).abs().max())
        log(f"[cli] fractions (f64, tol 1e-12) vs the batched phase's converged f64 fractions: "
            f"max abs {gap:.3e} (bound {FRACTION_SLACK}; card {card})")
        require(gap <= FRACTION_SLACK, f"the CLI's fractions vs the converged ones: {gap:.3e} > "
                f"{FRACTION_SLACK}")


SHARD_GRIDS = ((2, 2), (1, 4))
SHARD_STEPS = 200
# K7, K8 and K9 read the values K1/K5, K4 and K6 read at the same cells and
# run their operations in their order: equal bit for bit, and so are their
# plain versions.
TOL_SHARD = 0.0
# K7 with overlap: the edge cells' sums run in another order (zero halos,
# then the patch), relative to max|K1|; f64 is the JAX package's bound
# (tests/test_sharding.py:212-213). Each of 200 f32 steps may add an ulp or
# two at the edge cells (6e-8 of a tracer near 1), and a stable step does
# not amplify them: 200 steps stay below 1e-4.
TOL_K7_OVERLAP = {torch.float32: 1e-6, torch.float64: 1e-12}
TOL_PROP_OVERLAP = 1e-4
# The f32 BiCGStab(2) solve of the ideal-age system on shards: above the f32
# floor of a residual recomputed in f32 (FLOOR).
TOL_SHARD_B2 = 1e-4
SHARD_TIMEOUT_S = 600
# The batched sharded solve: the JAX package's own sharded batched check
# (__graft_entry__.py:292-327) solves its dyes at tol 1e-6 on the f32
# operator and holds the sharded fractions to the single-device ones at
# rtol 1e-2 and atol 1e-4 of each member's largest value.
TOL_SHARD_FRACTIONS = 1e-6
RTOL_SHARD_FRACTIONS, ATOL_SHARD_FRACTIONS = 1e-2, 1e-4


def _shard_csr(c, ny_l: int, nx_l: int):
    """The library form of K7's function on one shard: the CSR matrix (f32)
    of the shard's stencil with its halo lines as extra columns. Rows are
    the shard's cells in (k, j, i) order; columns the cells, then the east,
    west, north and south lines as `_halo_vector` lays them out. Zero
    entries are dropped, and k is clamped (no entry above the top or below
    the bottom level), as in K7."""
    nz = c.diag.shape[0]
    dev = c.diag.device
    n = nz * ny_l * nx_l
    cell = torch.arange(n, device=dev).reshape(nz, ny_l, nx_l)
    k = torch.arange(nz, device=dev).view(nz, 1, 1)
    col_e = n + k * ny_l + torch.arange(ny_l, device=dev).view(1, ny_l, 1)
    col_w = col_e + nz * ny_l
    row_n = n + 2 * nz * ny_l + k * nx_l + torch.arange(nx_l, device=dev).view(1, 1, nx_l)
    row_s = row_n + nz * nx_l
    none = torch.full_like(cell[:1], -1)
    cols = torch.stack([cell, torch.cat([cell[..., 1:], col_e], dim=-1),
                        torch.cat([col_w, cell[..., :-1]], dim=-1),
                        torch.cat([cell[:, 1:], row_n], dim=1),
                        torch.cat([row_s, cell[:, :-1]], dim=1),
                        torch.cat([none, cell[:-1]], dim=0),
                        torch.cat([cell[1:], none], dim=0)]).reshape(7, -1)
    vals = torch.stack([c.diag, c.east, c.west, c.north, c.south, c.top,
                        c.bottom]).float().reshape(7, -1)
    rows = cell.reshape(1, -1).expand(7, -1)
    keep = (vals != 0) & (cols >= 0)
    m = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]), vals[keep],
                                size=(n, n + 2 * nz * (ny_l + nx_l)))
    return m.coalesce().to_sparse_csr()


def _halo_vector(chi: torch.Tensor, halos) -> torch.Tensor:
    """chi (..., nz, ny_l, nx_l) and its halos (east, west, north, south)
    in `_shard_csr`'s column order: (N,) for a field, (N, B) for a batch."""
    lead = chi.shape[:-3]
    v = torch.cat([t.reshape(*lead, -1) for t in (chi, *halos)], dim=-1)
    return v.T.contiguous() if lead else v


def _adjoint(P, solve, T, b, w) -> list:
    """d sum(w * x) / d(b, the seven legs) for (1e-5 I + T) x = b through
    `solve` (a `differentiable_solve`)."""
    c = P.StencilCoeffs(*(leg.clone().requires_grad_(True) for leg in T))
    b = b.clone().requires_grad_(True)
    (w * solve(c, b, 1e-5, None)).sum().backward()
    return [b.grad, *(leg.grad for leg in c)]


def _shard_rank(grid, with_solves: bool) -> dict:
    """One rank of the sharded phase at 1 degree: whole-field references
    through the single-device kernels, then the sharded path with the
    launch counts reset just before and read just after (K8 on the
    synthetic transports and on the TEOS-10 density, K7 apply, 200 Euler
    steps of 1 and 8 tracers, K9, and with `with_solves` the refined ideal
    age and sequestration time and one BiCGStab(2) solve), its checks, and
    rank 0's kernel times (the other ranks wait at a barrier)."""
    import torch.distributed as dist

    import otmb_tpu_torch as P
    from otmb_tpu_torch import parallel as Q
    from otmb_tpu_torch.ops import assemble
    from otmb_tpu_torch.parallel import assemble_halo, halo, halo_kernel, redi_halo
    from otmb_tpu_torch.parallel.halo import _halo_exchange, _local_stencil

    device = grid.device
    t_set = time.perf_counter()
    ds, gm32, idx = build_case(P, NX, NY, NZ, "tripolar", torch.float32, device)
    topo, wet = gm32.topology, idx.wet3d
    gm64 = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat, lev=ds.lev,
        lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices, device=device)
    so, ct = hydrography(gm64, wet)
    rho = torch.where(wet, P.rho_teos10(so, ct, gm64.z3d), torch.nan)
    R64 = P.build_redi_operator(rho.float(), gm64, wet)
    R32 = R64.to(torch.float32)
    host = {name: getattr(ds, name) for name in ("umo", "vmo", "mlotst")}
    f32 = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in host.items()}
    f64 = {k: torch.as_tensor(v, dtype=torch.float64, device=device) for k, v in host.items()}
    rng = np.random.default_rng(SEED + 13)
    wet_np = wet.cpu().numpy()
    chi0 = torch.as_tensor(np.where(wet_np, 1.0 + 0.1 * rng.standard_normal(wet.shape), 0.0),
                           dtype=torch.float32, device=device)
    chis0 = torch.as_tensor(np.where(wet_np[None], 1.0 + 0.1 * rng.standard_normal(
        (BATCH,) + wet.shape), 0.0), dtype=torch.float32, device=device)
    w_adj = torch.as_tensor(np.where(wet_np, rng.standard_normal(wet.shape), 0.0),
                            dtype=torch.float64, device=device)
    # whole-field references: the single-device kernels, on this rank
    T32 = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm32)
    Tr64 = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm64, rho=rho, upwind=False)
    dt = 0.25 / float(T32.diag.abs().max())
    ref = {"apply": P.stencil_apply(T32, chi0, topo),
           "apply64": P.stencil_apply(Tr64, chi0.double(), topo),
           "prop": P.euler_propagate(T32, chi0, dt, SHARD_STEPS, topo),
           "prop_multi": P.euler_propagate_multi(T32, chis0, dt, SHARD_STEPS, topo),
           "redi": P.redi_apply_fused(R32, chi0),
           "redi64": P.redi_apply_fused(R64, chi0.double())}
    sh = lambda x: Q.shard_pytree(x, grid, topo.shape2d)
    gm32_l, gm64_l, rho_l = sh(gm32), sh(gm64), sh(rho)
    chi_l, chis_l = sh(chi0), sh(chis0)
    masks = latitude_bands(NY, NX, REGIONS)
    if with_solves:  # the single-device batched solve (K5 + batched K2)
        ref["fractions"] = P.water_mass_fractions(T32, wet, topo, masks,
                                                  tol=TOL_SHARD_FRACTIONS)[0]
    torch.cuda.synchronize()
    t_set = time.perf_counter() - t_set

    # the sharded path, launches counted
    dist.barrier()
    read = reset_launches()
    t0 = time.perf_counter()
    T_l = Q.assemble_T_halo(sh(f32["umo"]), sh(f32["vmo"]), sh(f32["mlotst"]), gm32_l, grid)
    Tr_l = Q.assemble_T_halo(sh(f64["umo"]), sh(f64["vmo"]), sh(f64["mlotst"]), gm64_l, grid,
                             rho=rho_l, upwind=False)
    y_off = Q.stencil_apply_halo(T_l, chi_l, topo, grid)
    y_on = Q.stencil_apply_halo(T_l, chi_l, topo, grid, overlap=True)
    y64_on = Q.stencil_apply_halo(Tr_l, chi_l.double(), topo, grid, overlap=True)
    t_prop = time.perf_counter()
    p_off = Q.euler_propagate_halo(T_l, chi_l, dt, SHARD_STEPS, topo, grid, overlap=False)
    p_on = Q.euler_propagate_halo(T_l, chi_l, dt, SHARD_STEPS, topo, grid)
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t_prop
    pm_off = Q.euler_propagate_halo_multi(T_l, chis_l, dt, SHARD_STEPS, topo, grid, overlap=False)
    pm_on = Q.euler_propagate_halo_multi(T_l, chis_l, dt, SHARD_STEPS, topo, grid)
    rs32, rs64 = Q.redi_shard(sh(R32), grid), Q.redi_shard(sh(R64), grid)
    r32 = Q.redi_apply_halo(rs32, chi_l, grid)
    r64 = Q.redi_apply_halo(rs64, chi_l.double(), grid)
    out = {"shape": grid.shape, "rank": grid.rank, "setup_s": t_set,
           "prop_s": t_prop / 2, "host_staged": grid.host_staged}
    if with_solves:
        stats = {}
        t_age = time.perf_counter()
        age_l, out["age_res"] = P.ideal_age(T_l, sh(wet), topo, tol=TOL_AGE, refine=True,
                                            stats=stats, grid=grid)
        torch.cuda.synchronize()
        out["age_s"], out["age_passes"] = time.perf_counter() - t_age, stats["refinements"]
        t_seq = time.perf_counter()
        seq_l, out["seq_res"] = P.sequestration_time(T_l, sh(wet), topo, tol=TOL_AGE,
                                                     refine=True, algorithm="bicgstab2",
                                                     grid=grid)
        torch.cuda.synchronize()
        out["seq_s"] = time.perf_counter() - t_seq
        surf = surface_mask(wet, torch.float32)
        st2 = {}
        _, out["b2_res"] = Q.solve_shifted_halo(T_l, sh(wet.float()), topo, grid,
                                                extra_diag=sh(surf), tol=TOL_SHARD_B2,
                                                maxiter=600, algorithm="bicgstab2", stats=st2)
        out["b2_iters"], out["b2_stop"] = st2["iters"], st2["stop"]
        # the sharded adjoint: one differentiable_solve(grid=) gradient for b
        # and the legs, in f64 on K8's legs widened
        t_adj = time.perf_counter()
        adj_l = _adjoint(P, P.differentiable_solve(topo, tol=TOL_ADJ_SOLVE, grid=grid),
                         T_l.to(torch.float64), sh(wet.double()), sh(w_adj))
        torch.cuda.synchronize()
        out["adj_s"] = time.perf_counter() - t_adj
        # the batched sharded solve: the 4 band dyes on K8's f32 T, the
        # global masks sliced on each rank (K7 multi + batched K2)
        before, st_fr = read(), {}
        t_fr = time.perf_counter()
        fr_l, res_fr = P.water_mass_fractions(T_l, sh(wet), topo, masks, tol=TOL_SHARD_FRACTIONS,
                                              stats=st_fr, grid=grid)
        torch.cuda.synchronize()
        after = read()
        out["fr"] = dict(s=time.perf_counter() - t_fr, iters=st_fr["iters"], stop=st_fr["stop"],
                         res=res_fr.tolist(), launches={k: after[k] - before[k] for k in after})
        age, seq = Q.gather_field(age_l, grid), Q.gather_field(seq_l, grid)
        for name, field in (("age", age), ("seq", seq)):
            g = field[wet]
            require(bool(torch.isfinite(g).all()) and bool((g > 0).all()),
                    f"sharded {name} not finite and positive")
            out[f"mean_{name}"] = mean_years(field, gm32.v3d, wet)
    torch.cuda.synchronize()
    out["path_s"] = time.perf_counter() - t0
    out["launches"] = read()
    if with_solves:
        # every rank holds the gathered sharded fractions to its single-device
        # ones (on wet cells, each member at its largest value) and the
        # batched solve's launches
        fr = Q.gather_field(fr_l, grid)
        gaps, ok = [], True
        for got, want in zip(fr, ref["fractions"]):
            got, want = got[wet].double(), want[wet].double()
            scale = float(want.abs().max())
            diff = (got - want).abs()
            ok = ok and bool((diff <= ATOL_SHARD_FRACTIONS * scale
                              + RTOL_SHARD_FRACTIONS * want.abs()).all())
            gaps.append(float(diff.max()) / scale)
        out["fr"]["gap"] = max(gaps)
        n = out["fr"]["launches"]
        require(max(out["fr"]["res"]) <= TOL_SHARD_FRACTIONS,
                f"rank {grid.rank}: sharded fractions' residuals {out['fr']['res']} > "
                f"{TOL_SHARD_FRACTIONS}")
        require(ok, f"rank {grid.rank}: sharded fractions vs single-device: max gap "
                f"{max(gaps):.3e} of a member's largest value, beyond rtol "
                f"{RTOL_SHARD_FRACTIONS} and atol {ATOL_SHARD_FRACTIONS}")
        require(n["K7 multi"] > 0 and n["K2"] > 0 and n["K1"] == n["K5"] == n["K7"] == 0,
                f"rank {grid.rank}: the batched sharded solve launched {n}: expected K7 multi "
                f"and K2, and no K1, K5 or K7")
        del fr, fr_l
        # rank 0 holds the gathered sharded gradients to the single-device
        # ones (K1, outside the counted window)
        adj = [Q.gather_field(g, grid) for g in adj_l]
        if grid.rank == 0:
            t_ref = time.perf_counter()
            ref_adj = _adjoint(P, P.differentiable_solve(topo, tol=TOL_ADJ_SOLVE),
                               T32.to(torch.float64), wet.double(), w_adj)
            torch.cuda.synchronize()
            out["adj_ref_s"] = time.perf_counter() - t_ref
            gaps, ok = [], True
            for got, want in zip(adj, ref_adj):
                scale = max(float(want.abs().max()), 1e-30)
                diff = (got - want).abs() / scale
                ok = ok and bool((diff <= TOL_ADJ_ATOL + TOL_ADJ_RTOL * want.abs() / scale).all())
                gaps.append(float(diff.max()))
            out["adj_gap"], out["adj_ok"] = max(gaps), ok
        del adj, adj_l
        dist.barrier()

    # checks, outside the counted window (the plain versions exchange too)
    every = (T_l, Tr_l, y_off, y_on, y64_on, p_off, p_on, pm_off, pm_on, r32, r64)
    require(all(t.device == device for t in (*T_l, *Tr_l, *every[2:])),
            f"rank {grid.rank}: a result is not on {device}")
    err = lambda a, b: rel_err(a, b)[0]
    halos = _halo_exchange(chi_l, topo, grid).wait()
    halos_b = _halo_exchange(chis_l, topo, grid).wait()
    kappas = (P.KAPPA_H_DEFAULT, P.KAPPA_VML_DEFAULT, P.KAPPA_VDEEP_DEFAULT)
    prep = assemble_halo._prepare(sh(f32["umo"]), sh(f32["vmo"]), sh(f32["mlotst"]), gm32_l,
                                  grid, None, P.RHO_DEFAULT, *kappas, True)
    prep_r = assemble_halo._prepare(sh(f64["umo"]), sh(f64["vmo"]), sh(f64["mlotst"]), gm64_l,
                                    grid, None, rho_l, *kappas, False)
    plain8, plain8r = assemble_halo._assemble_plain(*prep), assemble_halo._assemble_plain(*prep_r)
    errs = {
        "K8": max(max(err(a, sh(b)), err(a, c)) for a, b, c in zip(T_l, T32, plain8)),
        "K8 rho3d": max(max(err(a, sh(b)), err(a, c)) for a, b, c in zip(Tr_l, Tr64, plain8r)),
        "K7": max(err(y_off, sh(ref["apply"])), err(y_off, _local_stencil(T_l, chi_l, halos)),
                  err(p_off, sh(ref["prop"]))),
        "K7 multi": max(err(pm_off, sh(ref["prop_multi"])),
                        err(halo_kernel.local_apply(T_l, chis_l, halos_b),
                            _local_stencil(T_l, chis_l, halos_b))),
        "K9": max(err(r32, sh(ref["redi"])), err(r64, sh(ref["redi64"])),
                  err(r32, redi_halo._redi_plain(rs32, chi_l, halos))),
    }
    # K7's pack and edge entries and K4's prep entry against their plain
    # versions on this rank's shard (the pack's buffer, the edge on the
    # exchanged lines, the prep of the f32 and f64 shard metrics)
    entry_errs = {"K7 pack": 0.0, "K7 edge": 0.0}
    for x in (chi_l, chis_l):
        plan, plain = halo.HaloExchange(x, topo, grid), halo.HaloExchange(x, topo, grid)
        halo_kernel._pack(plan, x, topo)
        halo._pack_plain(x, topo, plain.lines)
        entry_errs["K7 pack"] = max(entry_errs["K7 pack"], err(plan.send, plain.send))
        plan.exchange(halo.ready_event(x))
        bulk = halo_kernel._bulk(T_l, x, halo_kernel._NO_HALOS, None)
        for scale in (1.0, -dt):
            entry_errs["K7 edge"] = max(entry_errs["K7 edge"], err(
                halo_kernel._edge(T_l, bulk.clone(), plan.halos, scale),
                halo._boundary_patch(T_l, bulk.clone(), plan.halos, scale)))
    ml32, ml64 = sh(f32["mlotst"]), sh(f64["mlotst"])
    entry_errs["K4 prep"] = max(
        max(exact_err(a, b) for a, b in zip(assemble._prep(g, ml, *KAPPAS(P)),
                                       (assemble._residents(g, ml, P.KAPPA_H_DEFAULT),
                                        assemble._levels(g.zt, *KAPPAS(P)[1:]))))
        for g, ml in ((gm32_l, ml32), (gm64_l, ml64)))
    errs.update(entry_errs)
    for name, e in errs.items():
        require(e <= TOL_SHARD, f"rank {grid.rank} {grid.shape}: {name} differs from its "
                f"single-device kernel or its plain version by {e:.3e}")
    rels = {"K7 overlap f32": rel_err(y_on, sh(ref["apply"]))[1],
            "K7 overlap f64": rel_err(y64_on, sh(ref["apply64"]))[1],
            "prop overlap": rel_err(p_on, sh(ref["prop"]))[1],
            "prop multi overlap": rel_err(pm_on, sh(ref["prop_multi"]))[1]}
    for name, bound_ in (("K7 overlap f32", TOL_K7_OVERLAP[torch.float32]),
                         ("K7 overlap f64", TOL_K7_OVERLAP[torch.float64]),
                         ("prop overlap", TOL_PROP_OVERLAP),
                         ("prop multi overlap", TOL_PROP_OVERLAP)):
        require(rels[name] <= bound_, f"rank {grid.rank} {grid.shape}: {name} max rel "
                f"{rels[name]:.3e} > {bound_}")
    out.update(errs=errs, rels=rels)

    # one overlapped sharded matvec (the solvers' matvec): rank 0's kernels
    # and copies per matvec under torch.profiler, its host ms without it
    out["matvec"] = _trace_matvecs(grid, lambda: Q.stencil_apply_halo(T_l, chi_l, topo, grid,
                                                                      overlap=True))

    # kernel times on one shard: rank 0 alone on the card
    dist.barrier()
    if grid.rank == 0:
        out["times"] = {
            "K7": time_pair(lambda: halo_kernel.local_apply(T_l, chi_l, halos),
                            lambda: _local_stencil(T_l, chi_l, halos), 50, 10),
            "K7 multi": time_pair(lambda: halo_kernel.local_apply(T_l, chis_l, halos_b),
                                  lambda: _local_stencil(T_l, chis_l, halos_b), 50, 5),
            "K8": time_pair(lambda: assemble_halo._launch(prep),
                            lambda: assemble_halo._assemble_plain(*prep), 20, 3),
            "K9": time_pair(lambda: redi_halo._launch(rs32, chi_l, halos),
                            lambda: redi_halo._redi_plain(rs32, chi_l, halos), 50, 5),
        }
        # K7's pack and edge entries on this shard (the edge adds in place)
        plan, plain = halo.HaloExchange(chi_l, topo, grid), halo.HaloExchange(chi_l, topo, grid)
        bulk = halo_kernel._bulk(T_l, chi_l, halo_kernel._NO_HALOS, None)
        out["times"]["K7 pack"] = time_pair(lambda: halo_kernel._pack(plan, chi_l, topo),
                                            lambda: halo._pack_plain(chi_l, topo, plain.lines),
                                            50, 10)
        out["times"]["K7 edge"] = time_pair(
            lambda: halo_kernel._edge(T_l, bulk, plan.halos, 1.0),
            lambda: halo._boundary_patch(T_l, bulk, plan.halos, 1.0), 50, 10)
        out["send_values"] = plan.send.numel()
        # the library call of K7's function: one CSR product over the shard
        # and its halo lines
        A = _shard_csr(T_l, *chi_l.shape[-2:])
        v, V = _halo_vector(chi_l, halos), _halo_vector(chis_l, halos_b)
        lib_err = max(rel_err(A @ v, y_off.reshape(-1))[1],
                      rel_err(A @ V, halo_kernel.local_apply(T_l, chis_l, halos_b)
                              .reshape(BATCH, -1).T)[1])
        require(lib_err <= TOL_LIBRARY, f"shard CSR product vs K7: {lib_err:.3e}")
        out["library"] = {"K7": cuda_ms(lambda: A @ v, 50), "K7 multi": cuda_ms(lambda: A @ V, 20),
                          "nnz": A.values().numel(), "err": lib_err}
        del A, v, V
    dist.barrier()
    return out


MATVECS = 20  # overlapped sharded matvecs in rank 0's trace


def _trace_matvecs(grid, matvec) -> dict:
    """Every rank runs MATVECS matvecs twice (collective); rank 0 times the
    first run with the host clock and traces the second under
    torch.profiler: kernels, device-to-host and host-to-device copies, host
    ms and device-busy ms per matvec (other ranks: {})."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    matvec()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MATVECS):
        matvec()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / MATVECS
    dist.barrier()
    if grid.rank != 0:
        for _ in range(MATVECS):
            matvec()
        torch.cuda.synchronize()
        return {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MATVECS):
            matvec()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    count = lambda pred: sum(1 for e in ev if pred(e.name)) / MATVECS
    return {"kernels": count(lambda n: not n.startswith(("Memcpy", "Memset"))),
            "d2h": count(lambda n: n.startswith("Memcpy DtoH")),
            "h2d": count(lambda n: n.startswith("Memcpy HtoD")),
            "copies": count(lambda n: n.startswith("Memcpy")),
            "host_ms": host_ms,
            "busy_ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3 / MATVECS}


def phase_sharded(card, mean_age: float, mean_seq: float) -> dict:
    """The sharded path at 1 degree on process grids of four ranks that
    share cuda:0 (gloo, halos staged through host memory), spawned with a
    deadline; (2, 2) with the solves, (1, 4) the kernels only. Returns each
    grid's per-rank results."""
    from otmb_tpu_torch.parallel import spawn_grid

    runs = {}
    for shape in SHARD_GRIDS:
        t0 = time.perf_counter()
        ranks = spawn_grid(_shard_rank, shape, (shape == SHARD_GRIDS[0],), backend="gloo",
                           device="cuda:0", timeout_s=SHARD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        runs[shape] = ranks
        ny_l, nx_l = NY // shape[0], NX // shape[1]
        for r in ranks:
            counts = {k: v for k, v in r["launches"].items() if v}
            for name in ("K7", "K7 multi", "K8", "K9", "K7 pack", "K7 edge", "K4 prep"):
                require(r["launches"][name] > 0, f"{name} was not launched on rank {r['rank']} "
                        f"of the {shape} grid")
            for name in ("K1", "K3", "K4", "K5", "K6", "K6 multi"):
                require(r["launches"][name] == 0, f"{name} launched on rank {r['rank']} of the "
                        f"{shape} grid's sharded path")
            log(f"[sharded {shape[0]}x{shape[1]}] rank {r['rank']}: shard {ny_l}x{nx_l}x{NZ} on "
                f"cuda:0, host-staged halos {r['host_staged']}; set-up {r['setup_s']:.3f} s, "
                f"sharded path {r['path_s']:.3f} s ({SHARD_STEPS} Euler steps "
                f"{r['prop_s']:.3f} s); launches {counts}; max abs vs single-device kernels "
                f"and plain " + ", ".join(f"{k} {v:.1e}" for k, v in r["errs"].items())
                + "; overlap max rel " + ", ".join(f"{k} {v:.3e}" for k, v in r["rels"].items()))
        r0 = ranks[0]
        mv = r0["matvec"]
        log(f"[sharded {shape[0]}x{shape[1]}] rank 0, {MATVECS} overlapped matvecs "
            f"(stencil_apply_halo, overlap=True): {mv['kernels']:.2f} kernels, "
            f"{mv['d2h']:.2f} device-to-host and {mv['h2d']:.2f} host-to-device copies, "
            f"{mv['host_ms']:.4f} host ms and {mv['busy_ms']:.4f} device-busy ms per matvec "
            f"(torch.profiler; host ms without it; card {card})")
        require(mv["kernels"] == 3 and mv["d2h"] <= 1 and mv["h2d"] <= 1,
                f"an overlapped sharded matvec on rank 0 of {shape}: {mv['kernels']} kernels, "
                f"{mv['d2h']} / {mv['h2d']} copies each way (3 and at most 1 expected)")
        if "age_res" in r0:
            for r in ranks:
                require(r["age_res"] <= TOL_AGE and r["seq_res"] <= TOL_AGE,
                        f"sharded age / sequestration residual {r['age_res']:.3e} / "
                        f"{r['seq_res']:.3e} > {TOL_AGE}")
                require(r["b2_res"] <= TOL_SHARD_B2, f"sharded BiCGStab(2) residual "
                        f"{r['b2_res']:.3e} > {TOL_SHARD_B2}")
            rel_a = abs(r0["mean_age"] - mean_age) / abs(mean_age)
            rel_s = abs(r0["mean_seq"] - mean_seq) / abs(mean_seq)
            require(rel_a <= TOL_MEAN_AGE and rel_s <= TOL_MEAN_AGE,
                    f"sharded mean age {r0['mean_age']:.9f} / sequestration {r0['mean_seq']:.9f} "
                    f"yr vs single-device {mean_age:.9f} / {mean_seq:.9f}: {rel_a:.3e} / "
                    f"{rel_s:.3e} > {TOL_MEAN_AGE}")
            log(f"[sharded {shape[0]}x{shape[1]}] refined ideal age (grid=), tol {TOL_AGE}: "
                f"residual {r0['age_res']:.3e} after {r0['age_passes']} passes, "
                f"{r0['age_s']:.3f} s wall, mean {r0['mean_age']:.9f} yr vs single-device "
                f"{mean_age:.9f} (rel {rel_a:.3e}, bound {TOL_MEAN_AGE}); refined sequestration "
                f"time (BiCGStab(2) inner): residual {r0['seq_res']:.3e}, {r0['seq_s']:.3f} s, "
                f"mean {r0['mean_seq']:.9f} yr vs {mean_seq:.9f} (rel {rel_s:.3e}); "
                f"solve_shifted_halo BiCGStab(2) f32: residual {r0['b2_res']:.3e} after "
                f"{r0['b2_iters']} pairs ({r0['b2_stop']})")
        if "fr" in r0:
            fr0 = r0["fr"]
            walls = ", ".join(f"{r['fr']['s']:.3f}" for r in ranks)
            solve_launches = {name: sum(r["fr"]["launches"][name] for r in ranks)
                              for name in ("K7 multi", "K2", "K7 pack", "K7 edge")}
            log(f"[sharded {shape[0]}x{shape[1]}] batched solve: water_mass_fractions(grid=) of "
                f"{REGIONS} latitude bands on K8's f32 T, tol {TOL_SHARD_FRACTIONS}: walls "
                f"{walls} s on ranks 0-{len(ranks) - 1}, {fr0['iters']} iterations (stop "
                f"{fr0['stop']}), residuals {' '.join(f'{x:.3e}' for x in fr0['res'])}; max gap "
                f"to the single-device batched fractions over the ranks "
                f"{max(r['fr']['gap'] for r in ranks):.3e} of a member's largest value (bounds "
                f"rtol {RTOL_SHARD_FRACTIONS}, atol {ATOL_SHARD_FRACTIONS}); launches in the "
                f"solve, all ranks: {solve_launches} (card {card})")
        if "adj_gap" in r0:
            require(r0["adj_ok"], f"sharded adjoint vs single-device gradients: max scaled gap "
                    f"{r0['adj_gap']:.3e} beyond rtol {TOL_ADJ_RTOL}, atol {TOL_ADJ_ATOL}")
            log(f"[sharded {shape[0]}x{shape[1]}] adjoint: differentiable_solve(grid=) "
                f"gradients of b and the 7 legs (f64, tol {TOL_ADJ_SOLVE}) vs the single-device "
                f"ones, max gap {r0['adj_gap']:.3e} of each array's largest value (bounds rtol "
                f"{TOL_ADJ_RTOL}, atol {TOL_ADJ_ATOL}); forward + adjoint {r0['adj_s']:.3f} s on "
                f"the grid, {r0['adj_ref_s']:.3f} s on one device (card {card})")
        for name, (k_ms, p_ms) in r0["times"].items():
            log(f"[time] {name} on rank 0's {ny_l}x{nx_l}x{NZ} shard f32 (the other ranks at a "
                f"barrier): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms per call (CUDA events over "
                f"back-to-back calls; four ranks share the card, halos host-staged; card {card})")
        lib = r0["library"]
        log(f"[library] CSR of rank 0's {ny_l}x{nx_l}x{NZ} shard with its halo lines as columns "
            f"({lib['nnz']} entries, f32) @ cat(chi, halos): {lib['K7']:.4f} ms; @ (N, {BATCH}): "
            f"{lib['K7 multi']:.4f} ms (max rel vs K7 / K7 multi {lib['err']:.2e}; CUDA events, "
            f"median of 5; card {card})")
        log(f"[sharded {shape[0]}x{shape[1]}] {wall:.3f} s wall for the spawn and all ranks")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import otmb_tpu_torch as P
    from otmb_tpu_torch import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {_build.build_seconds:.1f} s build, "
        f"{time.perf_counter() - t0:.1f} s to load")

    ds, gm32, idx, T32, launches, mean_age = phase_main_path(P, device, card)
    phase_bf16_age(P, gm32, idx, T32, mean_age)
    # the density path; its f64 grid is also the tripolar grid of the checks
    gm64, _, R64, dT32, dR32, dlaunches = phase_density(P, card)

    # kernel checks at the main path's shapes, on both topologies
    bnx, bny, bnz = BIPOLAR_SHAPE
    bds, bgm64, bidx = build_case(P, bnx, bny, bnz, "bipolar", torch.float64, device)
    _, bgm32, _ = build_case(P, bnx, bny, bnz, "bipolar", torch.float32, device)
    k4_worst = phase_k4(P, device, [("tripolar", ds, gm64, gm32),
                                    ("bipolar", bds, bgm64, bgm32)])
    T64 = P.assemble_transport(ds.umo, ds.vmo, ds.mlotst, gm64, idx.wet3d).T
    bT64 = P.assemble_transport(bds.umo, bds.vmo, bds.mlotst, bgm64, bidx.wet3d).T
    ops_cases = [("tripolar", T64, gm64.topology, idx.wet3d),
                 ("bipolar", bT64, bgm64.topology, bidx.wet3d)]
    k1_worst = phase_k1(P, device, ops_cases)
    k2_worst = phase_k2(P, device, ops_cases)
    # K5 in every type pair at the batch sizes of the 1-degree batched path
    k5_worst = phase_k5_checks(P, device, ops_cases, (("f64", "f64"), ("f32", "f64"),
                                                      ("f32", "f32"), ("bf16", "f32")),
                               (REGIONS, BATCH), plain=True)
    k6_worst = phase_k6_checks(P, device, [
        ("tripolar", R64, gm64, idx.wet3d),
        ("bipolar", redi_of(P, bgm64, bidx.wet3d), bgm64, bidx.wet3d)])
    phase_golden(P, device)
    phase_device_case(P, device, gm32, idx)
    batched = phase_batched(P, device, gm32, idx, T32, T64)
    phase_implicit(P, card, gm64, idx, T64)
    phase_autodiff(P, card, ds, gm64, idx, T64)
    del gm64, bgm64, bgm32, T64, bT64, R64, dT32
    torch.cuda.empty_cache()

    times = phase_times(P, card, T32, gm32, idx)
    k5_times, k5_err = phase_k5_times(P, card, T32, gm32.topology, idx.wet3d, plain_bmax=BATCH,
                                      k_calls=50)
    k6_times = phase_k6_times(P, card, dR32, idx.wet3d)
    library = phase_library(P, card, T32, idx, gm32.topology)
    mean_seq = phase_sequestration(P, gm32, idx, T32, mean_age)
    phase_gmres(P, card, gm32, idx, T32, mean_age, mean_seq)
    phase_utilities(P, card, gm32, idx, T32)
    phase_coarsen(P, card, device, gm32, idx, T32)
    phase_cli(P, card, ds, mean_age, mean_seq, batched.pop("fractions"))
    # the demo and the four examples as processes, after the CLI phase so
    # that its walls are taken with the card to itself
    finish_examples(start_examples(), card)
    del ds, gm32, idx, T32, dR32
    torch.cuda.empty_cache()

    qgm, qidx, qT, qlaunches = phase_quarter(P, device)
    qtimes = phase_times_quarter(P, card, qT, qgm, qidx)
    algebra_worst, algebra_times = phase_algebra_quarter(card, qidx.wet3d)
    hnx, hny, hnz = HALF
    hds, hgm, hidx = build_case(P, hnx, hny, hnz, "bipolar", torch.float32, device)
    hT = P.assemble_T(hds.umo, hds.vmo, hds.mlotst, hgm)
    del hds
    k3_worst = phase_k3(P, device, [("tripolar", qT, qgm.topology, qidx.wet3d),
                                    ("bipolar", hT, hgm.topology, hidx.wet3d)])
    # K5 where its walk's staging works hardest (the planes overflow the
    # L2): one member (the walk with a group of 1), a group of 8 holding 5,
    # and 8, with f32 and bf16 legs
    k5_worst = max(k5_worst, phase_k5_checks(
        P, device, [("tripolar", qT, qgm.topology, qidx.wet3d),
                    ("bipolar", hT, hgm.topology, hidx.wet3d)], (("f32", "f32"), ("bf16", "f32")),
        (1, 5, BATCH), plain=False))
    qk6_times = phase_k6_quarter(P, card, [("tripolar", qgm, qidx.wet3d),
                                           ("bipolar", hgm, hidx.wet3d)])
    del hgm, hidx, hT
    torch.cuda.empty_cache()
    qbatched, per_multi, per_single = phase_batched_quarter(P, card, qgm, qidx, qT)
    torch.cuda.empty_cache()
    qk5_times, _ = phase_k5_times(P, card, qT, qgm.topology, qidx.wet3d, plain_bmax=2,
                                  k_calls=10)
    log(f"[quarter batched] seconds per member-pair at 1440x1080x75 f32: batched (K5 + batched "
        f"K2) {per_multi * 1e3:.3f} ms, single-RHS unfused {per_single[False] * 1e3:.3f} ms, "
        f"fused (K3) {per_single[True] * 1e3:.3f} ms (card {card})")
    del qgm, qidx, qT
    torch.cuda.empty_cache()
    phase_device_case_quarter(P, card, device, qlaunches["setup s"])
    torch.cuda.empty_cache()
    k10_launches, k10_err, k10_times, gbps, k10_bytes = phase_probe(P, device, card, qtimes)
    log_k5_fractions(k5_times, NX * NY * NZ, gbps, f"{NX}x{NY}x{NZ}")
    log_k5_fractions(qk5_times, QUARTER[0] * QUARTER[1] * QUARTER[2], gbps,
                     "x".join(map(str, QUARTER)))
    cells, plane = NX * NY * NZ, NY * NX
    qcells, qplane = QUARTER[0] * QUARTER[1] * QUARTER[2], QUARTER[0] * QUARTER[1]
    one, quarter = f"{NX}x{NY}x{NZ}", "x".join(map(str, QUARTER))
    # K2 as the solvers run it: the solve against a factor made once per
    # system (cp, rden, upper and b read, x written)
    log_rates([*(("K2 solve", f"{size} {dt}", 5 * n * nb, ms) for size, n, t in (
                   (one, cells, times), (quarter, qcells, qtimes))
                 for dt, nb, ms in (("f32", 4, t["K2"][0]), ("f64", 8, t["K2 f64"][0]))),
               ("K6", f"{one} f32", redi_bytes(cells, plane, 4, 1, 4), k6_times["K6"][0]),
               ("K6 bf16", f"{one} (bf16, f32)", redi_bytes(cells, plane, 2, 1, 4),
                k6_times["K6 bf16"][0]),
               *((f"K6 batch B = {nb}", f"{one} f32", redi_bytes(cells, plane, 4, nb, 4),
                  k6_times[nb]["K6 batch"]) for nb in (1, 2, 4, BATCH)),
               ("K6", f"{quarter} f32", redi_bytes(qcells, qplane, 4, 1, 4), qk6_times[0]),
               ("K1's function as the CSR product (K1's bytes)", f"{one} f32", 9 * cells * 4,
                library["K1"]),
               (f"K5's function as the CSR product, B = {BATCH} (K5's bytes)", f"{one} f32",
                (7 + 2 * BATCH) * cells * 4, library["K5"])], gbps)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the sharded path: four ranks on this card
    sharded = phase_sharded(card, mean_age, mean_seq)
    ny_l, nx_l = NY // SHARD_GRIDS[0][0], NX // SHARD_GRIDS[0][1]
    s_cells, s_plane, s_edge = ny_l * nx_l * NZ, ny_l * nx_l, 2 * (ny_l + nx_l)
    ranks0 = sharded[SHARD_GRIDS[0]]
    s_times = ranks0[0]["times"]
    s_launches = lambda name: sum(r["launches"][name] for r in ranks0)
    s_worst = lambda *names: max(r["errs"][n] for runs in sharded.values() for r in runs
                                 for n in names)
    # compulsory bytes of one shard: K1's, K5's, K4's and K6's, and the halo
    # lines each reads once (f32 values, 1-byte wet flags)
    s_bytes = {
        "K7": 9 * s_cells * 4 + s_edge * NZ * 4,
        "K7 multi": (7 + 2 * BATCH) * s_cells * 4 + BATCH * s_edge * NZ * 4,
        "K8": 10 * s_cells * 4 + 2 * s_edge * NZ * 4 + 2 * s_edge * 4,
        "K9": (redi_bytes(s_cells, s_plane, 4, 1, 4) + 6 * s_edge // 2 * NZ * 4
               + s_edge // 2 * 4 + s_edge * NZ * (1 + 4)),
    }
    # K7's pack (its lines read, the send buffer written) and edge entries
    # (each edge cell read and written, and the leg and halo of each term
    # rank 0 adds: east, west and north; it has no south neighbour)
    s_perimeter = 2 * nx_l + 2 * (ny_l - 2)
    s_terms = 2 * ny_l + nx_l
    s_bytes["K7 pack"] = 2 * ranks0[0]["send_values"] * 4
    s_bytes["K7 edge"] = NZ * (s_perimeter + s_terms) * 2 * 4
    log_rates([(f"{name} on one {ny_l}x{nx_l}x{NZ} shard", "f32", s_bytes[name],
                s_times[name][0]) for name in s_bytes], gbps)
    log(f"[launches] K2 (factor and solve) {launches['K2']} on the 1-degree main path, "
        f"{batched['K2']} on the batched path, {qbatched['K2']} in the 0.25-degree batched "
        f"solve; K6 {dlaunches['K6']} and K6 batch {dlaunches['K6 multi']} on the density "
        f"path; K9 {s_launches('K9')} on the {SHARD_GRIDS[0]} sharded path")

    def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes, flops, library_ms):
        bound_ms, bound_by = bound(nbytes, flops)
        return {"name": name, "route": "cuda", "source": f"otmb_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    # Operations per cell and member, counted from each kernel's arithmetic.
    kernels = [
        entry("K1 stencil apply/euler_step", "stencil.cu", "otmb_tpu/ops/stencil_pallas.py:42",
              launches["K1"], k1_worst[("tripolar", "f32,f32", "T", "apply")],
              *times["K1 apply"], 9 * cells * 4, 15 * cells, library["K1"]),
        entry("K2 tridiag_solve", "tridiag.cu", "otmb_tpu/ops/tridiag_pallas.py:39",
              launches["K2"] + batched["K2"] + qbatched["K2"], k2_worst["tripolar float32"],
              *times["K2"], 5 * cells * 4, 8 * cells, None),
        entry("K4 assemble_T", "assemble.cu", "otmb_tpu/ops/assemble_pallas.py:60",
              launches["K4"], k4_worst[("tripolar", "float32")], *times["K4"], 10 * cells * 4,
              40 * cells, None),
        # K4's prep entry: 10 (ny, nx) fields and zt read, 11 fields and the
        # (nz, 6) rows written; 6 operations a column
        entry("K4 prep (assemble_T, assemble_T_halo)", "assemble.cu",
              "otmb_tpu/ops/assemble_pallas.py:336", launches["K4 prep"], s_worst("K4 prep"),
              *times["K4 prep"], (21 * plane + 7 * NZ) * 4, 6 * plane + 10 * NZ, None),
        entry("K3 fused_krylov_step", "krylov.cu", "otmb_tpu/ops/krylov_pallas.py:68",
              qlaunches["K3"], k3_worst[("tripolar", str(torch.float32), "T")], *qtimes["K3"],
              15 * qcells * 4, 30 * qcells, None),
        entry("K5 stencil_apply_multi/euler_step_multi", "stencil.cu",
              "otmb_tpu/ops/stencil_pallas.py:747", batched["K5"] + qbatched["K5"],
              max(k5_worst, k5_err), k5_times[BATCH]["K5"], k5_times[BATCH]["plain"],
              (7 + 2 * BATCH) * cells * 4, 15 * BATCH * cells, library["K5"]),
        entry("K6 redi_apply_fused", "redi.cu", "otmb_tpu/models/redi_pallas.py:46",
              dlaunches["K6"], k6_worst, *k6_times["K6"], redi_bytes(cells, plane, 4, 1, 4),
              REDI_FLOPS * cells, None),
        entry("K6 redi_apply_fused_multi", "redi.cu", "otmb_tpu/models/redi_pallas.py:424",
              dlaunches["K6 multi"], k6_worst, k6_times[BATCH]["K6 batch"],
              k6_times[BATCH]["plain"], redi_bytes(cells, plane, 4, BATCH, 4),
              REDI_FLOPS * BATCH * cells, None),
        entry("K10 dma_peak_probe", "probe.cu", "otmb_tpu/utils/profiling.py:214", k10_launches,
              k10_err, *k10_times, k10_bytes, 6 * k10_bytes // 32, None),
        # the sharded kernels: launches summed over the (2, 2) grid's four
        # ranks; ms on rank 0's shard; bound on that shard's bytes
        entry("K7 stencil_apply_halo/euler_propagate_halo", "stencil.cu",
              "otmb_tpu/parallel/halo_pallas.py:64", s_launches("K7"), s_worst("K7"),
              *s_times["K7"], s_bytes["K7"], 15 * s_cells, ranks0[0]["library"]["K7"]),
        entry("K7 stencil_apply_halo_multi/euler_propagate_halo_multi", "stencil.cu",
              "otmb_tpu/parallel/halo_pallas.py:263", s_launches("K7 multi"),
              s_worst("K7 multi"), *s_times["K7 multi"], s_bytes["K7 multi"],
              15 * BATCH * s_cells, ranks0[0]["library"]["K7 multi"]),
        entry("K7 halo pack", "stencil.cu", "otmb_tpu/parallel/halo_pallas.py:64",
              s_launches("K7 pack"), s_worst("K7 pack"), *s_times["K7 pack"],
              s_bytes["K7 pack"], 0, None),
        entry("K7 halo edge", "stencil.cu", "otmb_tpu/parallel/halo_pallas.py:64",
              s_launches("K7 edge"), s_worst("K7 edge"), *s_times["K7 edge"],
              s_bytes["K7 edge"], 3 * NZ * s_terms, None),
        entry("K8 assemble_T_halo", "assemble.cu", "otmb_tpu/parallel/assemble_halo.py:229",
              s_launches("K8"), s_worst("K8", "K8 rho3d"), *s_times["K8"], s_bytes["K8"],
              40 * s_cells, None),
        entry("K9 redi_apply_halo", "redi.cu", "otmb_tpu/parallel/redi_halo.py:129",
              s_launches("K9"), s_worst("K9"), *s_times["K9"], s_bytes["K9"],
              REDI_FLOPS * s_cells, None),
        # the BiCGStab(2) cycle's algebra, which the reference leaves to XLA's
        # fusion of its jitted cycle (no pallas_call): launches on the
        # 0.25-degree age and batched solve; ms on a 0.25-degree f32 field;
        # library: the eager addcmul/torch.dot sequence it replaces. K11 reads
        # 4 fields and writes 1 (12 operations a cell), K12 reads 8 and
        # writes 3 (16)
        entry("K11 polish_sums", "krylov_algebra.cu", "otmb_tpu/models/solvers.py:1268",
              qlaunches["K11"] + qbatched["K11"], max(algebra_worst["K11"],
                                                      algebra_worst["sums"]),
              *algebra_times[None, "K11"][:2], 5 * qcells * 4, 12 * qcells,
              algebra_times[None, "K11"][2]),
        entry("K12 polish_update", "krylov_algebra.cu", "otmb_tpu/models/solvers.py:1280",
              qlaunches["K12"] + qbatched["K12"], max(algebra_worst["K12"],
                                                      algebra_worst["sums"]),
              *algebra_times[None, "K12"][:2], 11 * qcells * 4, 16 * qcells,
              algebra_times[None, "K12"][2]),
    ]
    for (members, name), (k_ms, _, e_ms) in algebra_times.items():
        nbytes = (5 if name == "K11" else 11) * qcells * 4 * (members or 1)
        log(f"[roofline] {name} at {quarter} f32{'' if members is None else f', B = {members}'}: "
            f"{nbytes / 1e9:.3f} GB compulsory in {k_ms:.4f} ms = {nbytes / k_ms / 1e6:.1f} "
            f"GB/s, bound {nbytes / PEAK_BYTES * 1e3:.4f} ms at 3.35 TB/s "
            f"({100 * nbytes / PEAK_BYTES * 1e3 / k_ms:.1f} %); the eager sequence {e_ms:.4f} ms")
    log(f"[total] {time.perf_counter() - t_start:.1f} s from the start of main, the kernels' "
        f"build included (card {card})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
