"""Gradient-based calibration of the horizontal mixing coefficient.

The JAX package's `examples/calibrate_kappa.py` on the port, at its size
and seed (24x16x8 tripolar, seed 4), in float64. The pipeline — raw
transports -> assembly (`assemble_transport`, plain torch) -> implicit
steady-state solve (`differentiable_solve`) — is differentiable, so
recovering kappa_h from observations is a plain `torch.autograd` descent:

  1. build a synthetic "truth" steady state with kappa_h = 800 m^2/s;
  2. start from the reference default kappa_h = 500;
  3. minimise the misfit of the steady tracer field with vanilla gradient
     steps (the problem is smooth and 1-D).

The backward pass through the solve is ONE transpose solve (the
implicit-function adjoint; K1 + K2 on the card).

    python -m otmb_tpu_torch.examples.calibrate_kappa [--device cpu]
"""

from __future__ import annotations

import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.utils.device import default_device

from . import parser

ITERS = 30


def main(device=None) -> dict:
    """Run the example on `device` (None: the current CUDA device); returns
    the printed numbers."""
    device = default_device(device)
    ds = P.synthetic_dataset(nx=24, ny=16, nz=8, topology="tripolar", seed=4)
    gm = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
        lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices,
        device=device)
    idx = P.makeindices(gm.v3d)
    wet = idx.wet3d
    f64 = lambda x: torch.nan_to_num(torch.as_tensor(x, dtype=torch.float64, device=device))
    umo, vmo = f64(ds.umo), f64(ds.vmo)
    b = torch.where(wet, 1.0, 0.0).to(torch.float64)

    solve = P.differentiable_solve(gm.topology, tol=1e-12)

    def steady_state(kappa_h):
        T = P.assemble_transport(umo, vmo, ds.mlotst, gm, wet, kappa_h=kappa_h).T
        return solve(T, b, 1e-5, None)

    with torch.no_grad():
        truth = steady_state(torch.tensor(800.0, dtype=torch.float64, device=device))

    def misfit(kappa_h):
        d = steady_state(kappa_h) - truth
        return torch.where(wet, d * d, 0.0).sum()

    k = torch.tensor(500.0, dtype=torch.float64, device=device)  # reference default
    trace = []
    for it in range(ITERS):
        kv = k.clone().requires_grad_(True)
        loss = misfit(kv)
        (g,) = torch.autograd.grad(loss, kv)
        loss = loss.detach()
        # Newton-ish scalar step via a parabolic line search on g
        step = torch.clamp(loss / (g.abs() + 1e-30), 0.0, 200.0)
        k = k + torch.where(g < 0, step, -step)
        if it % 5 == 0:
            print(f"iter {it:3d}  kappa_h = {float(k):8.2f}  "
                  f"misfit = {float(loss):.3e}")
            trace.append((it, float(k), float(loss)))
        if float(loss) < 1e-16:
            break

    print(f"recovered kappa_h = {float(k):.2f} (truth 800.00)")
    assert abs(float(k) - 800.0) < 20.0, "calibration failed to converge"
    return {"trace": trace, "kappa_h": float(k)}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
