"""Command-line interface: build, validate, and use transport operators.

    python -m otmb_tpu_torch demo                      # synthetic end-to-end run
    python -m otmb_tpu_torch build  in.npz  op.npz     # raw fields -> operator
    python -m otmb_tpu_torch diagnose op.npz           # conservation/sign report
    python -m otmb_tpu_torch idealage op.npz age.npz   # steady ideal-age solve
    python -m otmb_tpu_torch fractions op.npz f.npz --bands 3
                                                       # water-mass fractions

Every subcommand takes `--device` (default: the current CUDA device; it
fails without one, and `--device cpu` runs on the CPU). `in.npz` carries
the canonical-layout arrays: areacello (ny,nx), volcello (nz,ny,nx), lon,
lat (ny,nx), lev (nz,), lon_vertices, lat_vertices (4,ny,nx), umo, vmo
(nz,ny,nx), mlotst (ny,nx) — see utils/io.py for conversion from CMIP
xarray datasets. Operator and result files use the JAX package's npz
keys, so a file written by either package's CLI loads in the other's.
`idealage` and `fractions` exit non-zero when a returned residual misses
its tol.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

MYR = 1e6 * 365.25 * 24 * 3600
YR = 365.25 * 24 * 3600


def _load_fields(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def cmd_demo(args) -> int:
    from .examples import end_to_end

    end_to_end.main(device=args.device)
    return 0


def _build(fields, device):
    import otmb_tpu_torch as P

    gm = P.makegridmetrics(
        areacello=fields["areacello"], volcello=fields["volcello"],
        lon=fields["lon"], lat=fields["lat"], lev=fields["lev"],
        lon_vertices=fields["lon_vertices"], lat_vertices=fields["lat_vertices"],
        device=device)
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=fields["umo"], vmo=fields["vmo"], gridmetrics=gm,
                                        indices=idx)
    ops = P.transportmatrix(phi=phi, mlotst=fields["mlotst"], gridmetrics=gm, indices=idx)
    return gm, idx, ops


def cmd_build(args) -> int:
    from .utils.checkpoint import save_operator
    from .utils.debugging import validate_operator

    gm, idx, ops = _build(_load_fields(args.input), args.device)
    save_operator(args.output, ops.T, gm.topology, v3d=gm.v3d, wet3d=idx.wet3d)
    print(f"built operator: {gm.topology.kind} grid {gm.shape}, "
          f"{idx.nwet} wet cells -> {args.output}")
    val = validate_operator(ops.T, gm.v3d, idx.wet3d, gm.topology)
    print(f"validation: upwind_ok={val.ok_upwind} "
          f"tau_vol={val.tau_vol_s/3.156e13:.3g} Myr")
    return 0 if val.ok_upwind else 1


def _load_op(path, device):
    """(coeffs, topology, v3d, wet3d) from an operator file of either
    package, the arrays on `device`."""
    from .utils.checkpoint import load_operator

    coeffs, topo, extras = load_operator(path, device=device)
    if "v3d" not in extras or "wet3d" not in extras:
        raise SystemExit("operator file lacks v3d/wet3d (rebuild with `build`)")
    dev = coeffs.diag.device
    return (coeffs, topo, torch.as_tensor(extras["v3d"], device=dev),
            torch.as_tensor(extras["wet3d"].astype(bool), device=dev))


def cmd_diagnose(args) -> int:
    from .utils.debugging import validate_operator

    coeffs, topo, v3d, wet = _load_op(args.operator, args.device)
    val = validate_operator(coeffs, v3d, wet, topo)
    print(f"grid: {topo.kind} {topo.shape3d}, wet cells {int(wet.sum())}")
    print(f"finite={val.finite} diag>0={val.diag_positive} "
          f"offdiag<=0={val.offdiag_nonpositive} land_zero={val.land_zero}")
    print(f"tau_div={val.tau_div_s/MYR:.3g} Myr  tau_vol={val.tau_vol_s/MYR:.3g} Myr")
    return 0 if val.finite and val.land_zero else 1


def cmd_idealage(args) -> int:
    from .models.solvers import ideal_age, sequestration_time
    from .utils.checkpoint import save_state

    coeffs, topo, v3d, wet = _load_op(args.operator, args.device)
    solve = sequestration_time if args.adjoint else ideal_age
    gamma, res = solve(coeffs, wet, topo, tol=args.tol, refine=args.refine)
    v = v3d[wet].double()
    mean_age = float((gamma[wet].double() * v).sum() / v.sum()) / YR
    print(f"ideal age solved: residual {float(res):.2e}, "
          f"volume-weighted mean {mean_age:.1f} yr")
    save_state(args.output, ideal_age_seconds=gamma)
    print(f"saved -> {args.output}")
    # The reference exits 0 below a fixed 1e-6, whatever --tol asked for.
    return 0 if float(res) <= args.tol else 1


def cmd_fractions(args) -> int:
    """Surface-origin water-mass fractions for latitude bands, solved as
    one batched lockstep Krylov (models/solvers.water_mass_fractions), in
    float64."""
    from .models.solvers import water_mass_fractions
    from .utils.checkpoint import save_state

    coeffs, topo, v3d, wet = _load_op(args.operator, args.device)
    coeffs = coeffs.to(torch.float64)  # widened if narrower: f32 never converges these systems
    print(f"note: tol {args.tol:g} (default 1e-12): the dye systems' relative residual is "
          f"that of the surface rows, so a looser tol leaves the interior unresolved (the dye "
          f"stopping rule, water_mass_fractions' docstring)")
    ny, nx = topo.shape3d[1:]
    edges = np.linspace(0, ny, args.bands + 1).astype(int)
    j = np.arange(ny)[:, None]
    masks = np.stack([
        np.broadcast_to((j >= lo) & (j < hi), (ny, nx))
        for lo, hi in zip(edges[:-1], edges[1:])
    ])
    fr, res = water_mass_fractions(coeffs, wet, topo, masks, tol=args.tol)
    v = torch.nan_to_num(v3d.double())
    for r in range(args.bands):
        share = float((torch.nan_to_num(fr[r]) * v).sum() / v.sum())
        print(f"band {r} (rows {edges[r]}..{edges[r+1]-1}): "
              f"{100*share:5.1f} % of ocean volume, "
              f"residual {float(res[r]):.1e}")
    save_state(args.output, fractions=fr, band_edges=np.asarray(edges))
    print(f"saved -> {args.output}")
    # The reference exits 0 below a fixed 1e-6 at a default tol of 1e-8.
    return 0 if float(res.max()) <= args.tol else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="otmb_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name, fn, help_):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--device", default=None,
                       help='torch device, e.g. "cuda:0" or "cpu" (default: the current '
                            'CUDA device)')
        p.set_defaults(fn=fn)
        return p

    command("demo", cmd_demo, "synthetic end-to-end run")

    p = command("build", cmd_build, "raw fields npz -> operator npz")
    p.add_argument("input")
    p.add_argument("output")

    p = command("diagnose", cmd_diagnose, "validate a saved operator")
    p.add_argument("operator")

    p = command("idealage", cmd_idealage, "steady ideal-age solve")
    p.add_argument("operator")
    p.add_argument("output")
    p.add_argument("--tol", type=float, default=1e-8,
                   help="relative residual to reach; the exit code is 0 only if the solve "
                        "reaches it")
    p.add_argument("--refine", action="store_true",
                   help="mixed-precision iterative refinement (Krylov solves in the "
                        "operator's precision, f64 defect correction)")
    p.add_argument("--adjoint", action="store_true",
                   help="solve sequestration time (T' + M) instead")

    p = command("fractions", cmd_fractions,
                "surface-origin water-mass fractions (batched solve, float64)")
    p.add_argument("operator")
    p.add_argument("output")
    p.add_argument("--bands", type=int, default=3,
                   help="number of equal latitude bands partitioning the surface")
    p.add_argument("--tol", type=float, default=1e-12,
                   help="relative residual of every band's solve (default 1e-12: only a "
                        "tight tol resolves the interior)")

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
