"""Same-card A/B of the K2, K6 and K9 kernels and the 1-degree refined
ideal age between checkouts of the repository.

    python3 scripts/ab_redesign.py --roots OLD NEW --order 0,1,1,0 [--out FILE]

Every run is a process of its own that imports `otmb_tpu_torch` from one
checkout (which builds that checkout's kernels from its `csrc/` at first
use) and measures on the current CUDA device, with CUDA events over
back-to-back calls (median of 5):

  * K2 as the solvers call it (`tridiag_solve_factored` against a factor
    made once, where the checkout has it, else `tridiag_solve`) at 1 degree
    (360x300x50) on the guarded diagonal of the ideal-age system, f32 and
    f64, and on a batch of 4; and at 0.25 degrees (1440x1080x75) on random
    legs of the same structure, f32;
  * K6 at 1 degree on the density path's Redi operator (f32, bf16
    coefficients, a batch of 8) and at 0.25 degrees on random coefficient
    fields, f32; one T + R step (K1 + K6);
  * K9 on rank 0's 150x180x50 shard of a (2, 2) grid, its halo lines cut
    from the whole field in one process;
  * the refined ideal age at 1 degree (f32 T from K4, tol 1e-8): wall
    seconds, median of 3 after one warm-up, with its residual and mean age
    so that the runs can be seen to compute the same bits, and the device's
    busy seconds in one more solve (its kernels' durations under
    torch.profiler);
  * with --sharded, the refined ideal age and sequestration time at 1
    degree on a (2, 2) process grid of four ranks that share the card
    (gloo, halos staged through host memory): rank 0's wall seconds.

The order lists the roots by index; "0,1,1,0" runs OLD, NEW, NEW, OLD. Each
run prints one JSON line; the calling process prints them all and the card, and
writes them to --out.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
NX, NY, NZ = 360, 300, 50
QUARTER = (1440, 1080, 75)
SEED = 0
YEAR_S = 365.25 * 24 * 3600


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (its helpers)."""
    spec = importlib.util.spec_from_file_location("_ab_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cut(f, g, topo, side):
    """The line of (..., ny, nx) field `f` beyond shard `g`'s `side`, as the
    halo exchange delivers it (periodic in x, the i-reversed top row across
    the tripolar fold, zeros where the grid ends)."""
    import torch

    ny, nx = topo.ny, topo.nx
    (j0, i0), (ny_l, nx_l) = g.offset(ny, nx), g.local_shape(ny, nx)
    j1, i1 = j0 + ny_l, i0 + nx_l
    if side == "east":
        return f[..., j0:j1, i1 % nx].contiguous()
    if side == "west":
        return f[..., j0:j1, (i0 - 1) % nx].contiguous()
    if side == "south":
        return f[..., j0 - 1, i0:i1].contiguous() if j0 > 0 else torch.zeros_like(f[..., 0, i0:i1])
    if j1 < ny:
        return f[..., j1, i0:i1].contiguous()
    if topo.is_tripolar:
        return torch.flip(f[..., ny - 1, nx - i1:nx - i0], dims=(-1,)).contiguous()
    return torch.zeros_like(f[..., 0, i0:i1])


def _k9_rank0(R, x, topo, device):
    """K9's call on rank 0 of a (2, 2) grid, its lines cut from the field."""
    import torch
    from otmb_tpu_torch.parallel import redi_halo
    from otmb_tpu_torch.parallel.mesh import ProcessGrid

    g = ProcessGrid((2, 2), 0, device, "gloo")
    (j0, i0), (ny_l, nx_l) = g.offset(topo.ny, topo.nx), g.local_shape(topo.ny, topo.nx)
    sl = lambda f: f[..., j0:j0 + ny_l, i0:i0 + nx_l].contiguous()
    cut = lambda f, side: _cut(f, g, topo, side)
    sides = ("east", "west", "north", "south")
    fields = lambda names, side: torch.stack([cut(getattr(R, n), side) for n in names])
    dz = ("cz_u", "cz_d")
    op_l = dataclasses.replace(R, wet=sl(R.wet), **{n: sl(getattr(R, n))
                                                    for n in redi_halo._COEF_FIELDS})
    rs = redi_halo.RediShard(
        op_l, (fields(dz, "east"), fields(dz + ("ae", "s_e"), "west"), fields(dz, "north"),
               fields(dz + ("an", "s_n"), "south")),
        (cut(R.inv_de, "west"), cut(R.inv_dn, "south")), tuple(cut(R.wet, s) for s in sides),
        j0 > 0, j0 + ny_l < topo.ny or topo.is_tripolar)
    h = tuple(cut(x, s) for s in sides)
    x_l = sl(x)
    return lambda: redi_halo._launch(rs, x_l, h), (ny_l, nx_l)


def _random_redi(P, shape, device):
    """A Redi operator of random f32 coefficient fields at `shape` (nx, ny,
    nz), tripolar, 80 % wet: K6's work does not depend on the values."""
    import torch
    from otmb_tpu_torch.grid.topology import GridTopology
    from otmb_tpu_torch.models.redi import _COEF_FIELDS, RediOperator

    nx, ny, nz = shape
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    dims = lambda n: (ny, nx) if n in ("inv_de", "inv_dn") else (nz, ny, nx)
    f = {n: torch.randn(dims(n), generator=gen, device=device) for n in _COEF_FIELDS}
    wet = torch.rand((nz, ny, nx), generator=gen, device=device) < 0.8
    return RediOperator(**f, wet=wet, topology=GridTopology(kind="tripolar", nx=nx, ny=ny, nz=nz))


def _sharded_rank(grid) -> dict:
    """One rank of the (2, 2) grid: the sharded refined solves, timed."""
    import torch
    import torch.distributed as dist

    import otmb_tpu_torch as P
    from otmb_tpu_torch import parallel as Q

    S = _smoke()
    ds, gm, idx = S.build_case(P, NX, NY, NZ, "tripolar", torch.float32, grid.device)
    topo = gm.topology
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    sh = lambda x: Q.shard_pytree(x, grid, topo.shape2d)
    T_l, wet_l = sh(T), sh(idx.wet3d)
    out = {}
    for name, solve, kw in (("age", P.ideal_age, {}),
                            ("seq", P.sequestration_time, {"algorithm": "bicgstab2"})):
        dist.barrier()
        t0 = time.perf_counter()
        _, res = solve(T_l, wet_l, topo, tol=S.TOL_AGE, refine=True, grid=grid, **kw)
        if grid.device.type == "cuda":
            torch.cuda.synchronize()
        out[f"sharded_{name}_s"], out[f"sharded_{name}_res"] = time.perf_counter() - t0, res
    return out


def run_one(root: Path, device=None, sharded: bool = False) -> dict:
    """Every measurement of one checkout (see the module docstring)."""
    sys.path.insert(0, str(root))
    import torch

    import otmb_tpu_torch as P

    assert Path(P.__file__).resolve().is_relative_to(root.resolve()), P.__file__
    S = _smoke()
    device = torch.device("cuda", 0) if device is None else device
    factored = hasattr(P, "tridiag_solve_factored")
    out = {"root": str(root), "factored": factored, "ms": {}}
    ms = out["ms"]

    def k2_call(lower, diag, upper, b):
        if factored:
            cp, rden = P.tridiag_factor(lower, diag, upper)
            return lambda: P.tridiag_solve_factored(cp, rden, upper, b)
        return lambda: P.tridiag_solve(lower, diag, upper, b)

    # 1 degree: T, the ideal-age system's legs, R
    ds, gm, idx = S.build_case(P, NX, NY, NZ, "tripolar", torch.float32, device)
    topo, wet = gm.topology, idx.wet3d
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    shifted = T.diag + torch.where(wet, S.surface_mask(wet, torch.float32), 0.0)
    legs = (T.bottom.contiguous(), torch.where(shifted != 0, shifted, 1.0), T.top.contiguous())
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    b = torch.where(wet, torch.randn(wet.shape, generator=gen, device=device), 0.0)
    bs = torch.where(wet, torch.randn((4,) + tuple(wet.shape), generator=gen, device=device), 0.0)
    ms["K2 1deg f32"] = S.cuda_ms(k2_call(*legs, b), 50)
    ms["K2 1deg f32 B=4"] = S.cuda_ms(k2_call(*legs, bs), 20)
    legs64 = tuple(t.double() for t in legs)
    ms["K2 1deg f64"] = S.cuda_ms(k2_call(*legs64, b.double()), 50)
    del bs, legs64

    gm64 = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat, lev=ds.lev,
        lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices, device=device)
    R = S.redi_of(P, gm64, wet).to(torch.float32)
    Rb = P.redi_operator_to_bf16(R)
    x = b
    xs = torch.where(wet, torch.randn((8,) + tuple(wet.shape), generator=gen, device=device), 0.0)
    ms["K6 1deg f32"] = S.cuda_ms(lambda: P.redi_apply_fused(R, x), 50)
    ms["K6 1deg bf16"] = S.cuda_ms(lambda: P.redi_apply_fused(Rb, x), 50)
    ms["K6 1deg f32 B=8"] = S.cuda_ms(lambda: P.redi_apply_fused_multi(R, xs), 20)
    out["K6 sum"] = float(P.redi_apply_fused(R, x).double().sum())
    dt = 0.25 / (float(T.diag.abs().max()) + P.redi_max_rate(R))
    ms["T + R step 1deg"] = S.cuda_ms(
        lambda: P.euler_step(T, x, dt, topo) + dt * P.redi_apply_fused(R, x), 50)
    k9, shard = _k9_rank0(R, torch.where(wet, x, torch.nan), topo, device)
    ms[f"K9 {shard[0]}x{shard[1]}x{NZ}"] = S.cuda_ms(k9, 50)
    out["K9 sum"] = float(torch.nan_to_num(k9()).double().sum())
    del Rb, xs, gm64

    # the refined ideal age at 1 degree
    v = torch.where(wet, gm.v3d, 0.0).double()
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gamma, res = P.ideal_age(T, wet, topo, tol=S.TOL_AGE, refine=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["age_s"] = statistics.median(walls[1:])
    out["age_walls_s"] = walls
    # the device's busy time in one more solve: the sum of its kernels'
    # durations under torch.profiler, against the solve's wall time
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        P.ideal_age(T, wet, topo, tol=S.TOL_AGE, refine=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) * 1e-6
    out["age_profiled_wall_s"], out["age_device_busy_s"] = wall, busy
    out["age_res"] = res
    out["age_mean_yr"] = float((gamma[wet] * v[wet]).sum() / v[wet].sum()) / YEAR_S
    del ds, gm, idx, T, R, gamma, legs, b, x, v
    torch.cuda.empty_cache()

    # 0.25 degrees, random fields of the same structure
    nx, ny, nz = QUARTER
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    lower = -torch.rand((nz, ny, nx), generator=gen, device=device)
    upper = -torch.rand((nz, ny, nx), generator=gen, device=device)
    diag = 1.0 + (lower.abs() + upper.abs())
    bq = torch.randn((nz, ny, nx), generator=gen, device=device)
    ms["K2 quarter f32"] = S.cuda_ms(k2_call(lower, diag, upper, bq), 20)
    del lower, upper, diag
    torch.cuda.empty_cache()
    Rq = _random_redi(P, QUARTER, device)
    ms["K6 quarter f32"] = S.cuda_ms(lambda: P.redi_apply_fused(Rq, bq), 20)
    del Rq, bq
    torch.cuda.empty_cache()
    if sharded:
        from otmb_tpu_torch.parallel import spawn_grid

        out.update(spawn_grid(_sharded_rank, (2, 2), (), backend="gloo", device="cuda:0",
                              timeout_s=600)[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", type=Path)
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(run_one(args.one, sharded=args.sharded)), flush=True)
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
                              + ["--sharded"] * args.sharded, capture_output=True, text=True)
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
