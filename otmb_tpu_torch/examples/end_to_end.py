"""End-to-end demo: CMIP-style fields -> transport operator -> workloads.

The steps of the JAX package's `examples/end_to_end.py` on the port, at
its size and seed (48x32x12 tripolar, seed 0), in float64:

    python -m otmb_tpu_torch.examples.end_to_end [--device cpu] [--grid 2x2]

Step 7, the sharded propagation, runs where the JAX example's does: when
more than one CUDA device is present (one rank per card, NCCL), or on the
process grid that `--grid` (`grid_shape=`) asks for (ranks on `device`
with gloo). On one card, unasked, it is skipped, and the run says so.
"""

from __future__ import annotations

import numpy as np
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.utils.device import default_device

from . import parser

YR = 365.25 * 24 * 3600
MYR = 1e6 * YR
STEPS = 100


def _sharded_rank(grid, T, chi, dt, topology):
    """One rank of step 7: its shard of 100 Euler steps (K7 on the card),
    gathered; rank 0 returns the whole field on the host."""
    from otmb_tpu_torch import parallel as Q

    sh = lambda x: Q.shard_pytree(x.to(grid.device), grid, topology.shape2d)
    out = Q.euler_propagate_halo(sh(T), sh(chi), dt, STEPS, topology, grid)
    whole = Q.gather_field(out, grid)
    return whole.cpu() if grid.rank == 0 else None


def _sharded(T, chi, dt, topology, device: torch.device, grid_shape):
    """Step 7 on a process grid: `grid_shape` ranks on `device` with gloo,
    or (None, several CUDA devices) one rank per card with NCCL. Returns
    (the grid's shape, rank 0's gathered result), or None when skipped."""
    from otmb_tpu_torch.parallel import spawn_grid
    from otmb_tpu_torch.parallel.mesh import _factor2d

    if grid_shape is None:
        if device.type != "cuda" or torch.cuda.device_count() < 2:
            return None
        shape, backend, rank_device = _factor2d(torch.cuda.device_count()), "nccl", None
    else:
        shape, backend, rank_device = tuple(grid_shape), "gloo", str(device)
    # the rank function by its module's name, so that spawned ranks import
    # it also when this file runs as __main__
    from otmb_tpu_torch.examples.end_to_end import _sharded_rank as rank_fn

    host = lambda x: x.detach().cpu()
    ranks = spawn_grid(rank_fn, shape, (P.StencilCoeffs(*map(host, T)), host(chi), dt,
                                        topology), backend=backend, device=rank_device)
    return shape, ranks[0]


def main(device=None, grid_shape=None) -> dict:
    """Run the demo on `device` (None: the current CUDA device); returns
    the printed numbers. `grid_shape` (ny_dev, nx_dev) runs step 7 on a
    gloo process grid of that shape."""
    device = default_device(device)
    out = {}
    # 1. Data. Real use: otmb_tpu_torch.utils.io's xarray readers over CMIP
    # NetCDF/Zarr; here, synthetic.
    ds = P.synthetic_dataset(nx=48, ny=32, nz=12, topology="tripolar", seed=0)

    # 2. Grid metrics, wet indices, six-face fluxes, operator.
    gm = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
        device=device)
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    ops = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx)
    topo = gm.topology
    print(f"grid {topo.kind} {gm.shape}, wet cells {idx.nwet}")
    out["grid"] = (topo.kind, tuple(gm.shape), int(idx.nwet))

    # 3. Conservation diagnostics (the reference's de-facto spec).
    out["diagnostics"] = {}
    for name in ("Tadv", "TkH", "TkVML", "TkVdeep"):
        d = P.operator_diagnostics(getattr(ops, name), gm.v3d, idx.wet3d, topo)
        tau_div, tau_vol = float(d["tau_div_s"]) / MYR, float(d["tau_vol_s"]) / MYR
        print(f"  {name:8s} tau_div {tau_div:10.3g} Myr   tau_vol {tau_vol:10.3g} Myr")
        out["diagnostics"][name] = (tau_div, tau_vol)

    # 4. Tracer propagation (explicit, CFL-stable step): K1 on the card.
    wet = idx.wet3d
    dt = 0.25 / float(ops.T.diag.abs().max())
    chi0 = torch.where(wet, 1.0, 0.0).to(ops.T.diag.dtype)
    chi = P.explicit_euler_propagate(ops.T, chi0, dt, STEPS, topo)
    lo, hi = float(chi[wet].min()), float(chi[wet].max())
    print(f"{STEPS} explicit steps (dt={dt:.0f}s): tracer range [{lo:.3f}, {hi:.3f}]")
    out.update(dt=dt, range=(lo, hi))

    # 5. Ideal age and sequestration time, matrix-free (K1 + K2 on the card).
    age, _ = P.ideal_age(ops.T, wet, topo)
    seq, _ = P.sequestration_time(ops.T, wet, topo)
    vw = gm.v3d[wet]
    mean = lambda g: float((g[wet] * vw).sum() / vw.sum()) / YR
    out.update(ideal_age_yr=mean(age), sequestration_yr=mean(seq))
    print(f"ideal age {out['ideal_age_yr']:.2f} yr, "
          f"sequestration {out['sequestration_yr']:.2f} yr")

    # 6. Coarsen and export for host tools.
    mat = P.coeffs_to_scipy(ops.T, idx, topo)
    lump, _, _ = P.lump_and_spray(wet.cpu().numpy(), P.wet_vector(gm.v3d, idx), mat,
                                  di=2, dj=2)
    print(f"coarsened {lump.shape[1]} -> {lump.shape[0]} cells")
    out["coarsened"] = (lump.shape[1], lump.shape[0])

    # 7. Multi-device: the halo exchange and K7 on a process grid.
    run = _sharded(ops.T, chi0, dt, topo, device, grid_shape)
    if run is None:
        print("sharded propagation skipped: one device (the JAX example runs it only on "
              "several; pass --grid, e.g. 2x2, to run it on a gloo process grid)")
        out["sharded"] = None
    else:
        shape, whole = run
        delta = float((whole.to(chi.device) - chi).abs().max())
        print(f"sharded propagation over {{'y': {shape[0]}, 'x': {shape[1]}}}: "
              f"max|delta| vs single-device = {delta:.3e}")
        out["sharded"] = (shape, delta)
    return out


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("--grid", default=None,
                   help="run step 7 on a gloo process grid of this shape, e.g. 2x2")
    a = p.parse_args()
    main(a.device, None if a.grid is None else tuple(int(n) for n in a.grid.split("x")))
