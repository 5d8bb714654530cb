"""The sharded stencil's overlap mode on the CPU: gloo ranks, spawned once
per process-grid shape in a module fixture, run the apply and the
propagation with overlap on and off, and the edge patch and the order of
the overlapped step are checked in one process.

Overlap packs the halo lines, launches the bulk K7 on null halos before
they are staged, then adds the edge terms in place when they land
(`parallel/halo_kernel.py:_step`, `parallel/halo.py:_boundary_patch`).
Only the order of the edge cells' sums differs from overlap off, so the
results agree to the bounds `chip_smoke.py` holds on the card: 1e-12 (f64)
and 1e-6 (f32) of the field's largest value, 1e-4 after 200 f32 steps.
"""

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.parallel import (
    euler_propagate_halo,
    euler_propagate_halo_multi,
    shard_pytree,
    spawn_grid,
    stencil_apply_halo,
    stencil_apply_halo_multi,
)
from otmb_tpu_torch.parallel import halo, halo_kernel
from otmb_tpu_torch.parallel.mesh import ProcessGrid

torch.set_num_threads(1)

KINDS = ("tripolar", "bipolar")
SHAPES = ((2, 2), (1, 4))
NX, NY, NZ, BATCH = 16, 8, 6, 3
STEPS = 200
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
TOL_STEPS = 1e-4


def _case(kind):
    ds = P.synthetic_dataset(nx=NX, ny=NY, nz=NZ, topology=kind, seed=3)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    T = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx).T
    rng = np.random.default_rng(17)
    wet = idx.wet3d
    noise = torch.from_numpy(rng.standard_normal((BATCH,) + wet.shape))
    chis = torch.where(wet, 1.0 + 0.1 * noise, 0.0)
    return gm.topology, T, chis


def _rank(grid):
    """Each case with overlap on and off on this rank's shard: the largest
    difference and the largest value of the overlap-off result."""
    out = {}
    for kind in KINDS:
        topo, T, chis = _case(kind)
        sh = lambda x: shard_pytree(x, grid, topo.shape2d)
        dt = 0.25 / float(T.diag.abs().max())
        for dtype in (torch.float64, torch.float32):
            c, xs = sh(T.to(dtype)), sh(chis.to(dtype))
            runs = {
                "apply": lambda ov: stencil_apply_halo(c, xs[0], topo, grid, overlap=ov),
                "apply_multi": lambda ov: stencil_apply_halo_multi(c, xs, topo, grid, overlap=ov),
                "step": lambda ov: euler_propagate_halo(c, xs[0], dt, 1, topo, grid, overlap=ov),
                "prop": lambda ov: euler_propagate_halo(c, xs[0], dt, STEPS, topo, grid,
                                                        overlap=ov),
                "prop_multi": lambda ov: euler_propagate_halo_multi(c, xs, dt, STEPS, topo, grid,
                                                                    overlap=ov),
            }
            for name, run in runs.items():
                on, off = run(True), run(False)
                out[kind, str(dtype), name] = (float((on - off).abs().max()),
                                               float(off.abs().max()))
    return out


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    return spawn_grid(_rank, request.param, device="cpu", timeout_s=600)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["apply", "apply_multi", "step", "prop", "prop_multi"])
def test_overlap_equals_no_overlap(ranks, kind, dtype, name):
    tol = TOL_STEPS if name.startswith("prop") and dtype == torch.float32 else TOL[dtype]
    for out in ranks:
        diff, scale = out[kind, str(dtype), name]
        assert diff <= tol * scale, (kind, dtype, name, diff, scale)


def test_boundary_patch_is_in_place():
    topo, T, chis = _case("tripolar")
    x = chis[0]
    bulk = P.apply_stencil(T, x, topo)
    before = bulk.clone()
    halos = (x[..., 0], x[..., -1], x[..., 0, :], x[..., -1, :])
    out = halo._boundary_patch(T, bulk, halos, 1.0)
    assert out is bulk
    assert not torch.equal(bulk, before)
    assert torch.equal(bulk[:, 1:-1, 1:-1], before[:, 1:-1, 1:-1])


def test_overlap_launches_bulk_before_staging(monkeypatch):
    """The overlapped step packs the lines it sends (the fold's flip
    included), records that they are written, runs the bulk launch on null
    halos, then stages and exchanges the lines (the staging waits only on
    the pack), then adds the edge terms."""
    topo, T, chis = _case("tripolar")
    x = chis[0]
    calls = []
    pack, ready, bulk, edge = (halo_kernel._pack, halo_kernel.ready_event, halo_kernel._bulk,
                               halo_kernel._edge)
    exchange = halo.HaloExchange.exchange

    def record_pack(plan, chi, topology):
        calls.append("pack")
        return pack(plan, chi, topology)

    def record_ready(chi):
        calls.append("ready")
        return ready(chi)

    def record_bulk(c, chi, halos, dt=None):
        calls.append("bulk" if all(h is None for h in halos) else "apply")
        return bulk(c, chi, halos, dt)

    def record_exchange(plan, ready_=None):
        calls.append("stage")
        return exchange(plan, ready_)

    def record_edge(c, y, halos, scale):
        calls.append("edge")
        return edge(c, y, halos, scale)

    monkeypatch.setattr(halo_kernel, "_pack", record_pack)
    monkeypatch.setattr(halo_kernel, "ready_event", record_ready)
    monkeypatch.setattr(halo_kernel, "_bulk", record_bulk)
    monkeypatch.setattr(halo.HaloExchange, "exchange", record_exchange)
    monkeypatch.setattr(halo_kernel, "_edge", record_edge)
    # one rank: its own lines are its halos (periodic x, its own fold), no messages
    grid = ProcessGrid((1, 1), 0, torch.device("cpu"), "gloo")
    plan = halo.HaloExchange(x, topo, grid)
    y = halo_kernel._step(T, x, topo, plan, None, overlap=True)
    assert calls == ["pack", "ready", "bulk", "stage", "edge"]
    torch.testing.assert_close(y, P.apply_stencil(T, x, topo), rtol=1e-12, atol=0)
