"""The sharded adjoint and GMRES on a process grid, on the CPU: gloo ranks,
spawned once for the module on a (2, 2) grid, run `differentiable_solve(grid=)`
and the solves with `algorithm="gmres"` on their shards of the 16x8x6
sharding grid (both topologies), and each computes the single-device
results itself; the main process holds every shard to them.

Mirrors tests/test_autodiff.py:209 (the gradients of b and of the seven
legs, to its bound: rtol 1e-3 and atol 5e-4 after scaling by each array's
largest value) and adds the shift's gradient, which the sharded backward
all-reduces. The port's f64 solves converge to 1e-13 on both sides, so the
shards also sit within TOL_TIGHT of the single-device results.
"""

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.parallel import gather_field, shard_pytree, spawn_grid

torch.set_num_threads(1)

KINDS = ("tripolar", "bipolar")
NX, NY, NZ = 16, 8, 6
SHAPE = (2, 2)
SHIFT = 1e-5
# Both sides stop at a residual below 1e-13 of systems whose inverse
# spans ~1e9 s: the gradients agree to ~1e-13 x conditioning of the
# array's scale, and the GMRES solutions alike.
TOL_TIGHT = 1e-8


def _case(kind):
    ds = P.synthetic_dataset(nx=NX, ny=NY, nz=NZ, topology=kind, seed=3)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    T = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx).T
    wet = idx.wet3d
    rng = np.random.default_rng(3)
    w = torch.where(wet, torch.from_numpy(rng.standard_normal(wet.shape)), 0.0)
    return gm.topology, T, wet, w


def _grads(solve, T, b, w):
    """d sum(w * x(T, b, shift)) / d(legs, b, shift)."""
    c = P.StencilCoeffs(*(leg.clone().requires_grad_(True) for leg in T))
    b = b.clone().requires_grad_(True)
    s = torch.tensor(SHIFT, dtype=torch.float64, requires_grad=True)
    (w * solve(c, b, s, None)).sum().backward()
    return [leg.grad for leg in c], b.grad, s.grad


def _rank(grid):
    out = {}
    for kind in KINDS:
        topo, T, wet, w = _case(kind)
        sh = lambda x: shard_pytree(x, grid, topo.shape2d)
        b = wet.double()
        legs, gb, gs = _grads(P.differentiable_solve(topo, tol=1e-13), T, b, w)
        legs_l, gb_l, gs_l = _grads(P.differentiable_solve(topo, tol=1e-13, grid=grid),
                                    sh(T), sh(b), sh(w))
        out[kind, "adjoint"] = dict(
            legs=[gather_field(g, grid) for g in legs_l], b=gather_field(gb_l, grid),
            shift=float(gs_l), ref_legs=legs, ref_b=gb, ref_shift=float(gs))
        surf = torch.where(wet & (torch.arange(NZ).view(-1, 1, 1) == 0), 1.0, 0.0).double()
        rhs = torch.where(wet, torch.from_numpy(np.random.default_rng(5).standard_normal(
            wet.shape)), 0.0)
        for transpose in (False, True):
            kw = dict(extra_diag=surf, tol=1e-12, transpose=transpose, algorithm="gmres")
            x, res = P.solve_shifted(T, rhs, topo, **kw)
            stats = {}
            x_l, res_l = P.solve_shifted(sh(T), sh(rhs), topo, grid=grid, stats=stats,
                                         **{**kw, "extra_diag": sh(surf)})
            out[kind, "gmres", transpose] = dict(x=gather_field(x_l, grid), res=res_l, ref=x,
                                                 ref_res=res, stats=stats)
        age, res = P.ideal_age(T.to(torch.float32), wet, topo, tol=1e-10, refine=True,
                               algorithm="gmres")
        age_l, res_l = P.ideal_age(sh(T.to(torch.float32)), sh(wet), topo, tol=1e-10,
                                   refine=True, algorithm="gmres", grid=grid)
        out[kind, "age"] = dict(x=gather_field(age_l, grid), res=res_l, ref=age, ref_res=res)
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_grid(_rank, SHAPE, device="cpu", timeout_s=600)


def _scaled_gap(got, ref):
    scale = max(float(ref.abs().max()), 1e-30)
    return (got - ref) / scale, ref / scale


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_adjoint_matches_single_device(ranks, kind):
    for out in ranks:
        r = out[kind, "adjoint"]
        for name, got, ref in [("b", r["b"], r["ref_b"])] + [
                (leg, g, rg) for leg, g, rg in zip(P.StencilCoeffs._fields, r["legs"],
                                                   r["ref_legs"])]:
            gap, ref_s = _scaled_gap(got, ref)
            np.testing.assert_allclose((gap + ref_s).numpy(), ref_s.numpy(), rtol=1e-3,
                                       atol=5e-4, err_msg=f"{kind} {name}")
            assert float(gap.abs().max()) <= TOL_TIGHT, (kind, name)
        assert r["shift"] == pytest.approx(r["ref_shift"], rel=TOL_TIGHT)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("transpose", [False, True])
def test_sharded_gmres_matches_single_device(ranks, kind, transpose):
    for out in ranks:
        r = out[kind, "gmres", transpose]
        assert r["res"] <= 1e-12 and r["ref_res"] <= 1e-12
        assert r["stats"]["stop"] == "converged"
        gap, _ = _scaled_gap(r["x"], r["ref"])
        assert float(gap.abs().max()) <= TOL_TIGHT


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_refined_gmres_age_matches_single_device(ranks, kind):
    for out in ranks:
        r = out[kind, "age"]
        assert r["res"] <= 1e-10 and r["ref_res"] <= 1e-10
        wet = torch.isfinite(r["ref"])
        assert torch.equal(torch.isfinite(r["x"]), wet)
        gap, _ = _scaled_gap(r["x"][wet], r["ref"][wet])
        assert float(gap.abs().max()) <= TOL_TIGHT
