"""Same-card A/B of the Krylov engine between checkouts of the repository:
at 0.25 degrees the BiCGStab(2) engine (the refined ideal age, one cycle's
device time by kernel class, and the fixed-work batched solve), or with
--bicg1 the 1-degree BiCGStab(1) workloads.

    python3 scripts/ab_cycle.py --roots OLD NEW --order 0,1,1,0 [--bicg1] [--out FILE]

Every run is a process of its own that imports `otmb_tpu_torch` from one
checkout (which builds that checkout's kernels from its `csrc/`) and
measures on the current CUDA device, at 1440x1080x75 (tripolar, seed 0, the
host-built case of `chip_smoke.py`, f32 T from K4):

  * the refined ideal age (tol 1e-8, BiCGStab(2) inner solves on K3): wall
    seconds, passes, inner matvec pairs, residual and volume-weighted mean
    age, so that runs can be seen to compute the same bits;
  * one BiCGStab(2) cycle of that system (fused, from its initial state):
    ms per cycle with CUDA events over 5 back-to-back cycles, and under
    `torch.profiler` the device ms per cycle of K3, of K11 and K12 (the
    cycle's algebra kernels, where the checkout has them), of the other
    elementwise kernels (addcmul, where, the scalar algebra), of the dots
    (cuBLAS and reductions), and in all ("busy"), with the kernel count;
  * the fixed-work batched solve of 4 latitude-band dyes (150 matvec pairs,
    K5 + batched K2): ms per member-pair, wall over pairs x members;
  * the peak device memory of the age's solve (above what was allocated
    before it), and K3 alone (chip_smoke.py's timing call; with combine and
    dot, and with each other flag pair) at 1440x1080x75 and at 360x300x50:
    ms per call (CUDA events) and its kernels' device ms per call
    (torch.profiler).

With --bicg1 a run measures instead, at 360x300x50 (tripolar, seed 0, f32
T from K4):

  * the refined ideal age (tol 1e-8, BiCGStab(1) inner solves on K2 + K1):
    AGE_RUNS walls, passes, inner iterations per pass, residual, mean age
    and the peak device memory of the solves; then one more run under `torch.profiler`, whose kernels' summed
    device time is the device-busy seconds, and the idle share 1 - busy /
    the median untraced wall;
  * one inner iteration (the age's inner system, ITERS iterations of
    `_bicgstab_steps` from a warmed state): ms per iteration with CUDA
    events, and under `torch.profiler` its device ms by kernel class (K1,
    K2, K13, the eager axpys, the dots, the scalar kernels, other) and its
    kernels;
  * the water-mass fractions of 4 latitude bands on the f64 operator
    (`assemble_transport`), tol 1e-12: wall and iterations;
  * on a (2, 2) process grid of four ranks sharing the card (gloo): the
    refined ideal age and sequestration time (BiCGStab(1) inner solves)
    with their walls, residuals and mean ages, and the all-reduces one
    BiCGStab(1) iteration makes (`all_reduce_sum` counted over ITERS
    iterations of `_bicgstab_steps` on the shard).

The order lists the roots by index; "0,1,1,0" runs OLD, NEW, NEW, OLD. Each
run prints one JSON line; the calling process prints them all and the card,
and writes them to --out.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
QUARTER = (1440, 1080, 75)
ONE = (360, 300, 50)
CYCLES = 5  # cycles per timed or traced window
PAIRS = 150  # matvec pairs of the fixed-work batched solve
BANDS = 4
AGE_RUNS = 3  # untimed-profiler refined ages per --bicg1 run
ITERS = 20  # BiCGStab(1) iterations per timed or traced window


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (its helpers)."""
    spec = importlib.util.spec_from_file_location("_ab_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_class(name: str) -> str:
    """The class of a kernel in a cycle's trace, by its name."""
    if "krylov_kernel" in name or "krylov_dot_finish" in name:
        return "K3"
    if "polish_sums" in name or ("alg_finish" in name and ", 5>" in name):
        return "K11"
    if "polish_update" in name or "alg_finish" in name:
        return "K12"
    if "dot" in name.lower() or "reduce" in name.lower() or "gemv" in name.lower():
        return "dots"
    return "elementwise"


def _bicg1_class(name: str) -> str:
    """The class of a kernel in a BiCGStab(1) iteration's trace, by name."""
    low = name.lower()
    if "stencil" in low:
        return "K1"
    if "thomas" in low:
        return "K2"
    if "bicg1" in low or "alg_finish" in low:
        return "K13"
    if "addcmul" in low:
        return "axpy"
    if "dot" in low or "reduce" in low or "gemv" in low:
        return "dots"
    if "elementwise" in low:
        return "scalar"
    return "other"


def _device_ms(prof, classify=None) -> tuple[float, dict, int, dict]:
    """The summed device ms of the kernels in a trace, by class when
    `classify` is given, the kernel count (copies and memsets apart) and
    the kernels by name."""
    from torch.autograd import DeviceType

    busy, classes, kernels, names = 0.0, {}, 0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        kernels += 1
        name = e.name.split("(")[0][-70:]
        names[name] = names.get(name, 0) + 1
        if classify is not None:
            key = classify(e.name)
            classes[key] = classes.get(key, 0.0) + ms
    return busy, classes, kernels, names


def _bicg1_rank(grid) -> dict:
    """One rank of the (2, 2) grid: the all-reduces of ITERS BiCGStab(1)
    iterations on the shard, then the sharded refined age and sequestration
    time, timed, gathered into whole-field mean ages."""
    import torch
    import torch.distributed as dist

    import otmb_tpu_torch as P
    from otmb_tpu_torch import parallel as Q
    from otmb_tpu_torch.models import solvers as S
    from otmb_tpu_torch.parallel import solve_halo

    C = _smoke()
    sync = torch.cuda.synchronize if grid.device.type == "cuda" else (lambda: None)
    nx, ny, nz = ONE
    ds, gm, idx = C.build_case(P, nx, ny, nz, "tripolar", torch.float32, grid.device)
    topo, wet = gm.topology, idx.wet3d
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    sh = lambda x: Q.shard_pytree(x, grid, topo.shape2d)
    T_l, wet_l = sh(T), sh(wet)
    sys_ = S._system(T_l, torch.float32, topo, extra_diag=sh(C.surface_mask(wet, torch.float32)),
                     grid=grid)
    state = S._bicgstab_steps(sys_, S._initial_state(sys_, "bicgstab", wet_l.float()), 2)
    calls = [0]
    reduce = solve_halo.all_reduce_sum

    def counted(t, g):
        calls[0] += 1
        return reduce(t, g)

    solve_halo.all_reduce_sum = counted
    S._bicgstab_steps(sys_, state, ITERS)
    solve_halo.all_reduce_sum = reduce
    out = {"allreduces_per_iter": calls[0] / ITERS}
    del sys_, state
    for name, solve in (("age", P.ideal_age), ("seq", P.sequestration_time)):
        dist.barrier()
        stats = {}
        t0 = time.perf_counter()
        x_l, res = solve(T_l, wet_l, topo, tol=C.TOL_AGE, refine=True, stats=stats, grid=grid)
        sync()
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_res"], out[f"{name}_passes"] = res, stats["refinements"]
        x = Q.gather_field(x_l, grid)
        out[f"{name}_mean_yr"] = C.mean_years(x, gm.v3d, wet)
    return out


def run_bicg1(root: Path, device=None) -> dict:
    """Every --bicg1 measurement of one checkout (see the module
    docstring)."""
    sys.path.insert(0, str(root))
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    import otmb_tpu_torch as P
    from otmb_tpu_torch.models import solvers as S
    from otmb_tpu_torch.parallel import spawn_grid

    assert Path(P.__file__).resolve().is_relative_to(root.resolve()), P.__file__
    C = _smoke()
    device = torch.device("cuda", 0) if device is None else device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out = {"root": str(root)}
    nx, ny, nz = ONE
    ds, gm, idx = C.build_case(P, nx, ny, nz, "tripolar", torch.float32, device)
    topo, wet = gm.topology, idx.wet3d
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    sync()

    # the refined ideal age: untraced walls (and the peak device memory of
    # its solves above what was allocated before them), then one traced run
    walls = []
    cuda = device.type == "cuda"
    if cuda:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    for _ in range(AGE_RUNS):
        stats = {}
        t0 = time.perf_counter()
        gamma, res = P.ideal_age(T, wet, topo, tol=C.TOL_AGE, refine=True, stats=stats)
        sync()
        walls.append(time.perf_counter() - t0)
    out["age_s"] = walls
    if cuda:
        out["age_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
    out["age_res"], out["age_passes"] = res, stats["refinements"]
    out["age_inner_iters"] = [p.get("inner_iters") for p in stats["passes"]]
    out["age_mean_yr"] = C.mean_years(gamma, gm.v3d, wet)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        P.ideal_age(T, wet, topo, tol=C.TOL_AGE, refine=True)
        sync()
    busy, _, kernels, _ = _device_ms(prof)
    out["age_busy_s"] = busy / 1e3
    out["age_kernels"] = kernels
    out["age_idle_share"] = 1.0 - out["age_busy_s"] / statistics.median(walls)
    del gamma

    # one inner iteration of the age's system
    sys_ = S._system(T, torch.float32, topo, extra_diag=C.surface_mask(wet, torch.float32))
    state = S._bicgstab_steps(sys_, S._initial_state(sys_, "bicgstab", wet.float()), 2)
    out["iter_ms"] = C.cuda_ms(lambda: S._bicgstab_steps(sys_, state, ITERS), 1) / ITERS
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        S._bicgstab_steps(sys_, state, ITERS)
        sync()
    busy, classes, kernels, names = _device_ms(prof, _bicg1_class)
    out["iter_busy_ms"] = busy / ITERS
    out["iter_device_ms"] = {k: v / ITERS for k, v in sorted(classes.items())}
    out["iter_kernels"] = kernels / ITERS
    out["iter_kernel_names"] = {k: v / ITERS for k, v in names.items()}
    del sys_, state

    # the batched f64 fractions
    gm64 = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat, lev=ds.lev,
        lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices, dtype=torch.float64,
        device=device)
    T64 = P.assemble_transport(ds.umo, ds.vmo, ds.mlotst, gm64, wet).T
    masks = C.latitude_bands(ny, nx, BANDS)
    stats = {}
    sync()
    t0 = time.perf_counter()
    _, res = P.water_mass_fractions(T64, wet, topo, masks, tol=1e-12, stats=stats)
    sync()
    out["fractions_s"] = time.perf_counter() - t0
    out["fractions_iters"], out["fractions_res"] = stats["iters"], res.tolist()
    del T64, gm64, T, gm, idx, ds
    torch.cuda.empty_cache()

    # the sharded solves on (2, 2)
    ranks = spawn_grid(_bicg1_rank, (2, 2), (), backend="gloo", device=str(device),
                       timeout_s=600)
    out["sharded"] = {k: [r[k] for r in ranks] if k.endswith("_s") else ranks[0][k]
                      for k in ranks[0]}
    return out


def run_one(root: Path, device=None) -> dict:
    """Every measurement of one checkout (see the module docstring)."""
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import otmb_tpu_torch as P
    from otmb_tpu_torch.models import solvers as S

    assert Path(P.__file__).resolve().is_relative_to(root.resolve()), P.__file__
    C = _smoke()
    device = torch.device("cuda", 0) if device is None else device
    out = {"root": str(root)}
    nx, ny, nz = QUARTER
    t0 = time.perf_counter()
    ds, gm, idx = C.build_case(P, nx, ny, nz, "tripolar", torch.float32, device)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    del ds
    topo, wet = gm.topology, idx.wet3d

    # the refined ideal age, with the peak device memory of its solve
    stats = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gamma, res = P.ideal_age(T, wet, topo, tol=C.TOL_AGE, refine=True, algorithm="bicgstab2",
                             stats=stats)
    torch.cuda.synchronize()
    out["age_s"] = time.perf_counter() - t0
    out["age_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    out["age_res"] = res
    out["age_passes"] = stats["refinements"]
    out["age_pairs"] = sum(p.get("inner_iters") or 0 for p in stats["passes"])
    out["age_mean_yr"] = C.mean_years(gamma, gm.v3d, wet)
    del gamma
    torch.cuda.empty_cache()

    # one cycle: CUDA events, then its kernels by class under torch.profiler
    sys_ = S._system(T, torch.float32, topo, extra_diag=C.surface_mask(wet, torch.float32))
    from otmb_tpu_torch.ops.krylov import krylov_scratch

    step = S._fused_step(sys_, krylov_scratch(*sys_.m_legs, factor=sys_.factor))
    state = S._initial_state(sys_, "bicgstab2", wet.float())
    state = S._bicgstab2_cycles(sys_, step, state, 2)  # past the first cycle's zeros
    out["cycle_ms"] = C.cuda_ms(lambda: S._bicgstab2_cycles(sys_, step, state, CYCLES),
                                1) / CYCLES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        S._bicgstab2_cycles(sys_, step, state, CYCLES)
        torch.cuda.synchronize()
    _, classes, kernels, _ = _device_ms(prof, _kernel_class)
    classes = {k: v / CYCLES for k, v in classes.items()}
    out["cycle_device_ms"] = classes
    out["cycle_busy_ms"] = sum(classes.values())
    out["cycle_algebra_ms"] = out["cycle_busy_ms"] - classes.get("K3", 0.0)
    out["cycle_kernels"] = kernels / CYCLES
    del sys_, step, state
    torch.cuda.empty_cache()
    out["k3"] = {"quarter": _k3_times(C, P, T, topo, wet)}

    # the fixed-work batched solve
    bs, surf = C.bands_rhs(wet, BANDS)
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, res = P.solve_shifted_chunked_multi(T, bs, topo, extra_diag=surf, tol=1e-30,
                                            maxiter=PAIRS, early_stop=False,
                                            algorithm="bicgstab2", stats=st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["batched_ms_per_member_pair"] = wall * 1e3 / (BANDS * st["iters"])
    out["batched_res"] = res.tolist()
    del xs, bs, surf, T, gm, idx
    torch.cuda.empty_cache()

    # K3 at 1 degree, where a column walk is latency-bound
    nx, ny, nz = ONE
    ds, gm, idx = C.build_case(P, nx, ny, nz, "tripolar", torch.float32, device)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    out["k3"]["one"] = _k3_times(C, P, T, gm.topology, idx.wet3d)
    return out


def _k3_times(C, P, T, topo, wet) -> dict:
    """K3 on the ideal-age system of T (chip_smoke.py's timing call), with
    combine and dot ("ms", "device_ms") and with each other flag pair
    ("combine=0,dot=1", ...): ms per call over back-to-back calls (CUDA
    events, wrapper included) and its kernels' device ms per call
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for combine, dot in ((True, True), (True, False), (False, True), (False, False)):
        kernel = C.k3_timing_pair(P, T, topo, wet, 20, 0, combine, dot)[0]
        ms = C.cuda_ms(kernel, 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kernel()
            torch.cuda.synchronize()
        device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA and "krylov" in e.name) / 1e3 / 10
        times = {"ms": ms, "device_ms": device_ms}
        if combine and dot:
            out.update(times)
        else:
            out[f"combine={int(combine)},dot={int(dot)}"] = times
        del kernel
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", type=Path)
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--bicg1", action="store_true")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps((run_bicg1 if args.bicg1 else run_one)(args.one)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[ab] card {card}", flush=True)
    runs = []
    for i in map(int, args.order.split(",")):
        root = args.roots[i].resolve()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)]
                              + ["--bicg1"] * args.bicg1, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["wall_s"] = time.perf_counter() - t0
        runs.append(run)
        print(f"[ab] {json.dumps(run)}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
