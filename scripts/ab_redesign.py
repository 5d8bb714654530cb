"""Same-card A/B of the port's kernels and the 1-degree refined ideal age
between checkouts of the repository, with each kernel's device time.

    python3 scripts/ab_redesign.py --roots OLD NEW --order 0,1,1,0 [--sharded] [--out FILE]

Every run is a process of its own that imports `otmb_tpu_torch` from one
checkout (which builds that checkout's kernels from its `csrc/` at first
use) and measures on the current CUDA device. "ms" is the time per call
with CUDA events over back-to-back calls (median of 5), wrapper included;
"device" is what `torch.profiler` records on the card over the same calls:
the named kernel's duration per call, every kernel's and copy's duration
per call ("busy"), and the kernels and copies per call.

  * K2 as the solvers call it (`tridiag_solve_factored` against a factor
    made once, where the checkout has it, else `tridiag_solve`) at 1 degree
    (360x300x50) on the guarded diagonal of the ideal-age system, f32 and
    f64, and on a batch of 4; and at 0.25 degrees (1440x1080x75) on random
    legs of the same structure, f32;
  * K6 at 1 degree on the density path's Redi operator (f32, bf16
    coefficients, a batch of 8) and at 0.25 degrees on random coefficient
    fields, f32; one T + R step (K1 + K6);
  * K4 (`assemble_T` on device tensors) at 1 degree in f32 and f64 and at
    0.25 degrees in f32, per call and on the device;
  * K5 (`stencil_apply_multi`) at 1 degree on T at B = 1, 2, 4, 8 with f32
    and bf16 legs, and at 0.25 degrees on random f32 legs at B = 1, 4 and 8,
    per call and on the device, with K1 on one tracer at both sizes as the
    control; the batched propagation at 1 degree (8 tracers x 200 Euler
    steps, one K5 launch a step): wall seconds, median of 3 after a warm-up;
  * K7 (one tracer and batches of 8 and 4), K8 and K9 on rank 0's 150x180x50
    shard of a (2, 2) grid, their halo lines cut from the whole field in
    one process, per call and on the device;
  * the refined ideal age at 1 degree (f32 T from K4, tol 1e-8): wall
    seconds, median of 3 after one warm-up, with its residual and mean age
    so that the runs can be seen to compute the same bits, and the device's
    busy seconds in one more solve (its kernels' durations under
    torch.profiler);
  * with --sharded, on a (2, 2) process grid of four ranks that share the
    card (gloo, halos staged through host memory): rank 0's trace of 20
    overlapped sharded matvecs (`stencil_apply_halo(overlap=True)`, the
    solvers' matvec) and of the first 20 BiCGStab(1) iterations of the
    refined age's inner solve, each per matvec: kernels, copies, host ms
    (wall clock without the profiler) and device-busy ms; then the refined
    ideal age and sequestration time: rank 0's wall seconds.

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
MATVECS = 20  # sharded matvecs (and inner iterations) per traced window
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


def _device(fn, calls: int, match: str | None = None) -> dict:
    """`torch.profiler` over `calls` back-to-back calls of `fn` (after one
    warm-up): per call, the duration of the kernels whose name contains
    `match` ("kernel_ms"), of everything on the card ("busy_ms"), and the
    number of kernels and of copies."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = lambda es: sum(e.time_range.elapsed_us() for e in es)
    copies = [e for e in ev if e.name.startswith("Memcpy")]
    kernels = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
    out = {"busy_ms": us(ev) / 1e3 / calls, "kernels": len(kernels) / calls,
           "copies": len(copies) / calls}
    if match is not None:
        out["kernel_ms"] = us(e for e in kernels if match in e.name) / 1e3 / calls
    return out


def _timed(out: dict, name: str, fn, calls: int, match: str | None) -> None:
    """out["ms"][name]: CUDA-event ms per call; out["device"][name]: `_device`."""
    S = _smoke()
    out["ms"][name] = S.cuda_ms(fn, calls)
    out["device"][name] = _device(fn, calls, match)


def _shard0(topo, device):
    """Rank 0 of a (2, 2) grid on `device` and a slicer of its shard."""
    from otmb_tpu_torch.parallel.mesh import ProcessGrid

    g = ProcessGrid((2, 2), 0, device, "gloo")
    (j0, i0), (ny_l, nx_l) = g.offset(topo.ny, topo.nx), g.local_shape(topo.ny, topo.nx)
    return g, (lambda f: f[..., j0:j0 + ny_l, i0:i0 + nx_l].contiguous()), (ny_l, nx_l)


def _k7_rank0(T, x, xs, topo, device):
    """K7's calls (one tracer, a batch) on rank 0 of a (2, 2) grid, their
    halo lines cut from the whole fields."""
    from otmb_tpu_torch.ops.coeffs import StencilCoeffs
    from otmb_tpu_torch.parallel import halo_kernel

    g, sl, _ = _shard0(topo, device)
    sides = ("east", "west", "north", "south")
    T_l = StencilCoeffs(*(sl(leg) for leg in T))
    h = tuple(_cut(x, g, topo, s) for s in sides)
    hb = tuple(_cut(xs, g, topo, s) for s in sides)
    x_l, xs_l = sl(x), sl(xs)
    return (lambda: halo_kernel.local_apply(T_l, x_l, h),
            lambda: halo_kernel.local_apply(T_l, xs_l, hb))


def _k8_rank0(P, ds, gm, topo, device):
    """K8's call on rank 0 of a (2, 2) grid (f32, scalar rho, upwind), its
    lines cut from the whole field as `parallel/assemble_halo.py:_lines`
    exchanges them."""
    import torch
    from otmb_tpu_torch.ops.assemble import _levels, _residents
    from otmb_tpu_torch.parallel import assemble_halo

    g, sl, (ny_l, _) = _shard0(topo, device)
    dtype = gm.v3d.dtype
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    umo, vmo, ml = t(ds.umo), t(ds.vmo), t(ds.mlotst)
    res = _residents(gm, ml, P.KAPPA_H_DEFAULT)
    cut = lambda f, side: _cut(f, g, topo, side)
    top = ny_l == topo.ny
    sides = ("east", "west", "north", "south")
    flux = {"east": umo, "west": umo, "north": vmo, "south": vmo}
    edge = {"east": res[1], "west": res[0], "north": res[2] if top else res[3],
            "south": res[2]}
    level = tuple(torch.stack([cut(gm.v3d, s), cut(flux[s], s)]) for s in sides)
    static = tuple(torch.stack([cut(res[9], s), cut(edge[s], s)]) for s in sides)
    a = assemble_halo._Shard(
        sl(umo), sl(vmo), sl(gm.v3d), None, sl(res),
        _levels(gm.zt, P.KAPPA_VML_DEFAULT, P.KAPPA_VDEEP_DEFAULT), (level, static), False,
        not top, topo.is_tripolar, True, 1.0 / P.RHO_DEFAULT)
    return lambda: assemble_halo._launch(a)


def _k4_call(P, ds, gm):
    """`assemble_T` on device tensors of the grid's dtype (the main path's call)."""
    import torch

    t = lambda a: torch.as_tensor(a, dtype=gm.v3d.dtype, device=gm.v3d.device)
    umo, vmo, ml = t(ds.umo), t(ds.vmo), t(ds.mlotst)
    return lambda: P.assemble_T(umo, vmo, ml, gm)


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
    """One rank of the (2, 2) grid: rank 0's trace of the sharded matvec
    and of 20 inner iterations, then the sharded refined solves, timed."""
    import contextlib

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import otmb_tpu_torch as P
    from otmb_tpu_torch import _build
    from otmb_tpu_torch import parallel as Q

    S = _smoke()
    ds, gm, idx = S.build_case(P, NX, NY, NZ, "tripolar", torch.float32, grid.device)
    topo = gm.topology
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    sh = lambda x: Q.shard_pytree(x, grid, topo.shape2d)
    T_l, wet_l = sh(T), sh(idx.wet3d)
    surf_l = sh(S.surface_mask(idx.wet3d, torch.float32))
    b_l = wet_l.float()
    out = {}

    def matvecs():
        y = b_l
        for _ in range(MATVECS):
            y = Q.stencil_apply_halo(T_l, b_l, topo, grid, overlap=True)
        return y

    def inner():
        st = {}
        Q.solve_shifted_halo(T_l, b_l, topo, grid, extra_diag=surf_l, tol=1e-30,
                             maxiter=MATVECS, algorithm="bicgstab", stats=st)
        return st

    for name, fn in (("matvec", matvecs), ("inner", inner)):
        fn()  # warm-up
        dist.barrier()
        torch.cuda.synchronize()
        n7 = _build.calls(_build.KERNELS["K7"])
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nmv = _build.calls(_build.KERNELS["K7"]) - n7
        dist.barrier()
        prof_ctx = (profile(activities=[ProfilerActivity.CUDA]) if grid.rank == 0
                    else contextlib.nullcontext())
        with prof_ctx as prof:
            fn()
            torch.cuda.synchronize()
        if grid.rank == 0:
            ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            kernels = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
            names = {}
            for e in kernels:
                key = e.name.split("(")[0][-60:]
                names[key] = names.get(key, 0) + 1
            out[f"trace_{name}"] = {
                "matvecs": nmv, "host_ms_per_matvec": wall * 1e3 / nmv,
                "kernels_per_matvec": len(kernels) / nmv,
                "copies_per_matvec": sum(e.name.startswith("Memcpy") for e in ev) / nmv,
                "busy_ms_per_matvec": sum(e.time_range.elapsed_us() for e in ev) / 1e3 / nmv,
                "kernel_names": names}
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
    out = {"root": str(root), "factored": factored, "ms": {}, "device": {}}
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

    # K5 at 1 degree beside K1, and the batched propagation
    _timed(out, "K1 1deg f32", lambda: P.stencil_apply(T, b, topo), 50, "stencil_kernel")
    Tb = T.to(torch.bfloat16)
    for nb in (1, 2, 4, 8):
        xk = torch.where(wet, torch.randn((nb,) + tuple(wet.shape), generator=gen,
                                          device=device), 0.0)
        for name, c in (("f32", T), ("bf16", Tb)):
            _timed(out, f"K5 1deg {name} B={nb}",
                   lambda c=c, xk=xk: P.stencil_apply_multi(c, xk, topo), 50, "stencil")
        out[f"K5 sum B={nb}"] = float(P.stencil_apply_multi(T, xk, topo).double().sum())
    dt = 0.25 / float(T.diag.abs().max())
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prop = P.euler_propagate_multi(T, xk, dt, 200, topo)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["K5 propagation 8x200 1deg s"] = statistics.median(walls[1:])
    out["K5 propagation sum"] = float(prop.double().sum())
    del Tb, xk, prop

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
    sname = f"{shard[0]}x{shard[1]}x{NZ}"
    _timed(out, f"K9 {sname}", k9, 50, "redi")
    out["K9 sum"] = float(torch.nan_to_num(k9()).double().sum())
    # K4 at 1 degree, f32 and f64; K7 (one tracer, 8) and K8 on rank 0's shard
    _timed(out, "K4 1deg f32", _k4_call(P, ds, gm), 20, "assemble_kernel")
    _timed(out, "K4 1deg f64", _k4_call(P, ds, gm64), 20, "assemble_kernel")
    out["K4 sum"] = float(sum(leg.double().sum() for leg in _k4_call(P, ds, gm)()))
    k7, k7m = _k7_rank0(T, x, xs, topo, device)
    _timed(out, f"K7 {sname}", k7, 50, "stencil")
    _timed(out, f"K7 multi B=8 {sname}", k7m, 20, "stencil")
    _timed(out, f"K7 multi B=4 {sname}", _k7_rank0(T, x, xs[:4].contiguous(), topo, device)[1],
           20, "stencil")
    out["K7 sum"] = float(k7().double().sum())
    k8 = _k8_rank0(P, ds, gm, topo, device)
    _timed(out, f"K8 {sname}", k8, 20, "assemble_kernel")
    out["K8 sum"] = float(sum(leg.double().sum() for leg in k8()))
    del Rb, xs, gm64, k7, k7m, k8

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
    # K5 at 0.25 degrees beside K1, on random f32 legs (its work does not
    # depend on the values)
    from otmb_tpu_torch.grid.topology import GridTopology
    from otmb_tpu_torch.ops.coeffs import StencilCoeffs

    qtopo = GridTopology(kind="tripolar", nx=nx, ny=ny, nz=nz)
    qlegs = StencilCoeffs(*(torch.randn((nz, ny, nx), generator=gen, device=device)
                            for _ in StencilCoeffs._fields))
    xq = torch.randn((nz, ny, nx), generator=gen, device=device)
    _timed(out, "K1 quarter f32", lambda: P.stencil_apply(qlegs, xq, qtopo), 20, "stencil_kernel")
    for nb in (1, 4, 8):
        xk = torch.randn((nb, nz, ny, nx), generator=gen, device=device)
        _timed(out, f"K5 quarter f32 B={nb}", lambda xk=xk: P.stencil_apply_multi(qlegs, xk, qtopo),
               10, "stencil")
        out[f"K5 quarter sum B={nb}"] = float(P.stencil_apply_multi(qlegs, xk, qtopo).double().sum())
        del xk
    del qlegs, xq
    torch.cuda.empty_cache()
    # K4 at 0.25 degrees, f32, on the synthetic grid of the main path
    qds, qgm, _ = S.build_case(P, nx, ny, nz, "tripolar", torch.float32, device)
    _timed(out, "K4 quarter f32", _k4_call(P, qds, qgm), 5, "assemble_kernel")
    del qds, qgm
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
