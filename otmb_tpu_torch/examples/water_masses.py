"""Surface-origin water-mass fractions via ONE batched steady-state solve.

The JAX package's `examples/water_masses.py` on the port, at its size and
seed (48x32x12 tripolar, seed 0), in float64. Partition the surface into
regions; for each region r the dye steady state (T + M) f_r = M 1_r gives
the fraction of water at every cell that last touched the surface inside
region r. All regions solve together in one lockstep batched BiCGStab
(`water_mass_fractions`): the matvec is the multi-tracer kernel K5, so
the operator's coefficients are read once per iteration for the whole
batch, and the preconditioner one batched K2 launch. Its tol is 1e-12:
the dye systems' relative residual is the surface rows', so only a tight
tol resolves the interior (`water_mass_fractions`' docstring).

    python -m otmb_tpu_torch.examples.water_masses [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.utils.device import default_device

from . import parser

NAMES = ("southern band", "tropical band", "northern band")


def main(device=None) -> dict:
    """Run the example on `device` (None: the current CUDA device); returns
    the printed numbers."""
    device = default_device(device)
    ds = P.synthetic_dataset(nx=48, ny=32, nz=12, topology="tripolar", seed=0)
    gm = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
        device=device)
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    ops = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx)

    # three latitude bands: "southern", "tropical", "northern" surface
    ny, nx = gm.shape[1:]
    j = np.arange(ny)[:, None]
    masks = np.stack([
        np.broadcast_to(j < ny // 3, (ny, nx)),
        np.broadcast_to((j >= ny // 3) & (j < 2 * ny // 3), (ny, nx)),
        np.broadcast_to(j >= 2 * ny // 3, (ny, nx)),
    ])

    fr, res = P.water_mass_fractions(ops.T, idx.wet3d, gm.topology, masks, tol=1e-12)
    wet = idx.wet3d
    v = torch.nan_to_num(gm.v3d)

    print("volume fraction of the ocean ventilated from each band:")
    shares = []
    for r, name in enumerate(NAMES):
        share = float((torch.nan_to_num(fr[r]) * v).sum() / v.sum())
        shares.append(share)
        print(f"  {name:14s}  {100 * share:5.1f} %   "
              f"(solve residual {float(res[r]):.1e})")

    s = fr.sum(dim=0)[wet]
    lo, hi = float(s.min()), float(s.max())
    print(f"partition-of-unity check: fractions sum to "
          f"[{lo:.4f}, {hi:.4f}] over wet cells")
    assert 0.98 < lo and hi < 1.02
    return {"shares": shares, "residuals": [float(x) for x in res], "sum_range": (lo, hi)}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
