"""GMRES(30) on the card: how it converges on the 1-degree systems, and
against BiCGStab(2) as the inner solve of the 0.25-degree refined ideal
age, on one CUDA device.

    python3 scripts/gmres_study.py [--restarts 30,60,120] [--skip-quarter]

At 1 degree (360x300x50 tripolar, seed 0; T from K4 in f32, and in f64 for
the implicit step):

  * one GMRES cycle of the ideal-age system checked as an Arnoldi process:
    the basis' orthonormality max |V'V - I| and the relation
    max |A M V_m - V_{m+1} H| / max |A M V_m|;
  * for each restart length (30 is the port's; the others only here, by
    setting `models.solvers.GMRES_RESTART`): the f32 ideal-age system (tol
    1e-8, no refinement) and the f64 implicit Euler step of dt = 1 year (tol
    1e-10), each for at most 1200 Arnoldi steps without the stall stop,
    with the true residual at the start of each cycle on stderr
    (`verbose=True`) and the residual, steps and wall at the end;
  * BiCGStab(1) on the same two systems, for comparison.

At 0.25 degrees (unless --skip-quarter): `chip_smoke.py`'s 0.25-degree main
path (1440x1080x75, f32 T from K4; the refined ideal age at tol 1e-8 with
BiCGStab(2) inner solves on K3), the first refinement pass's system alone
under GMRES(30) for 1200 Arnoldi steps without the stall stop (true
residual per cycle on stderr), and the refined age with GMRES(30) inner
solves on K1 + K2 (`gmres_quarter`): wall, passes,
matvecs, final residual, mean age. Every line carries the card's name and
power limit. Exits non-zero if the 0.25-degree GMRES age misses
chip_smoke's limit (residual <= 1e-5, finite positive ages).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def one_degree(P, card, restarts) -> None:
    from otmb_tpu_torch.models import solvers as S

    device = torch.device("cuda", 0)
    ds, gm, idx = CS.build_case(P, CS.NX, CS.NY, CS.NZ, "tripolar", torch.float32, device)
    wet, topo = idx.wet3d, gm.topology
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    gm64 = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                             lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                             lat_vertices=ds.lat_vertices, device=device)
    T64 = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm64)
    surf = CS.surface_mask(wet, torch.float32)
    b = wet.to(torch.float32)

    sys_ = S._system(T, torch.float32, topo, extra_diag=surf)
    v0 = b / torch.linalg.vector_norm(b)
    V, H = S._arnoldi(sys_, v0, S.GMRES_RESTART)
    flat = V.reshape(V.shape[0], -1).double()
    ortho = float((flat @ flat.T - torch.eye(flat.shape[0], dtype=torch.float64,
                                              device=device)).abs().max())
    AMV = torch.stack([sys_.apply(sys_.M(v)) for v in V[:-1]]).reshape(V.shape[0] - 1, -1)
    rel = float((AMV.double().T - flat.T @ H.double()).abs().max() / AMV.abs().max())
    CS.log(f"[arnoldi] one cycle of the 1-degree f32 ideal-age system: max |V'V - I| "
           f"{ortho:.3e}, max |A M V - V H| / max |A M V| {rel:.3e} (card {card})")
    del V, H, flat, AMV

    rng = CS.np.random.default_rng(CS.SEED + 7)
    chi = torch.as_tensor(CS.np.where(wet.cpu().numpy(), 1.0 + 0.1 * rng.standard_normal(
        wet.shape), 0.0), dtype=torch.float64, device=device)
    dt = CS.YEAR_S
    systems = {
        "ideal-age system f32": lambda **kw: P.solve_shifted_chunked(
            T, b, topo, extra_diag=surf, tol=CS.TOL_AGE, maxiter=1200, early_stop=False, **kw),
        "implicit step f64": lambda **kw: P.solve_shifted_chunked(
            T64, chi / dt, topo, shift=1.0 / dt, tol=1e-10, maxiter=1200, early_stop=False,
            **kw),
    }
    for name, solve in systems.items():
        stats = {}
        (_, res), wall = _timed(lambda: solve(algorithm="bicgstab", stats=stats))
        CS.log(f"[gmres study] 1 degree, {name}, BiCGStab(1): residual {res:.3e} after "
               f"{stats['iters']} iterations ({2 * stats['iters']} matvecs, {stats['stop']}), "
               f"{wall:.3f} s (card {card})")
        for m in restarts:
            S.GMRES_RESTART = m
            stats = {}
            print(f"# {name}, GMRES({m}):", file=sys.stderr, flush=True)
            (_, res), wall = _timed(lambda: solve(algorithm="gmres", stats=stats, verbose=True))
            CS.log(f"[gmres study] 1 degree, {name}, GMRES({m}): residual {res:.3e} after "
                   f"{stats['iters']} Arnoldi steps ({stats['cycles']} cycles, {stats['stop']}), "
                   f"{wall:.3f} s (card {card})")
        S.GMRES_RESTART = 30


def gmres_quarter(P, card, gm, idx, T, b2: dict) -> dict:
    """At 0.25 degrees (f32 T from K4): the refined ideal age with GMRES(30)
    inner solves (K1 + K2, f64 defects through K1), counts reset before and
    read after, beside the BiCGStab(2) one of the main path (`b2`, from
    `chip_smoke.phase_quarter`: K3), under chip_smoke's limit: residual <=
    1e-5, finite positive ages. The GMRES basis takes 31 fields of the
    grid."""
    wet = idx.wet3d
    torch.cuda.reset_peak_memory_stats()
    read = CS.reset_launches()
    stats = {}
    t0 = time.perf_counter()
    gamma, res = P.ideal_age(T, wet, gm.topology, tol=CS.TOL_AGE, refine=True, algorithm="gmres",
                             stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read()
    peak = torch.cuda.max_memory_allocated() / 1e9
    CS.log_passes("quarter gmres", stats)
    steps = sum(p.get("inner_iters") or 0 for p in stats["passes"])
    ok = bool(torch.isfinite(gamma[wet]).all()) and bool((gamma[wet] > 0).all())
    mean = CS.mean_years(gamma, gm.v3d, wet) if ok else float("nan")
    del gamma
    CS.log(f"[quarter gmres] 0.25-degree refined ideal age, GMRES(30) inner on K1 + K2, "
           f"tol {CS.TOL_AGE}: relative residual {res:.3e} after {stats['refinements']} "
           f"passes, {steps} Arnoldi steps ({steps} K1 matvecs and K2 solves), {wall:.3f} s "
           f"wall, mean age {mean:.6f} yr, peak device memory {peak:.3f} GB; BiCGStab(2) on "
           f"K3: residual {b2['res']:.3e} after {b2['passes']} passes, {b2['pairs']} matvec "
           f"pairs ({2 * b2['pairs']} matvecs), {b2['wall']:.3f} s wall, mean age "
           f"{b2['mean']:.6f} yr; launches K1 {counts['K1']} K2 {counts['K2']} K3 "
           f"{counts['K3']} (card {card})")
    CS.require(ok, "0.25-degree GMRES ideal age not finite and positive")
    CS.require(res <= CS.TOL_QUARTER,
               f"0.25-degree GMRES ideal age residual {res:.3e} > {CS.TOL_QUARTER}")
    CS.require(counts["K1"] > 0 and counts["K2"] > 0 and counts["K3"] == 0,
               f"0.25-degree GMRES launches {counts}")
    return dict(wall=wall, passes=stats["refinements"], steps=steps, res=res, mean=mean,
                peak_gb=peak)


def quarter(P, card) -> None:
    gm, idx, T, counts = CS.phase_quarter(P, torch.device("cuda", 0))
    wet = idx.wet3d
    stats = {}
    (_, res), wall = _timed(lambda: P.solve_shifted_chunked(
        T, wet.to(torch.float32), gm.topology, extra_diag=CS.surface_mask(wet, torch.float32),
        tol=1e-4, maxiter=1200, algorithm="gmres", early_stop=False, verbose=True,
        stats=stats))
    CS.log(f"[quarter gmres pass 0 alone] GMRES(30), no stall stop: relative residual "
           f"{res:.3e} after {stats['iters']} Arnoldi steps ({stats['stop']}), {wall:.3f} s "
           f"wall (card {card})")
    gmres_quarter(P, card, gm, idx, T, counts["age"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--restarts", default="30", help="GMRES restart lengths at 1 degree")
    ap.add_argument("--skip-quarter", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gmres_study: no CUDA device", file=sys.stderr)
        return 2
    import otmb_tpu_torch as P
    from otmb_tpu_torch import _build

    card = CS.card_line()
    CS.log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.library()
    one_degree(P, card, [int(m) for m in args.restarts.split(",")])
    if not args.skip_quarter:
        torch.cuda.empty_cache()
        quarter(P, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
