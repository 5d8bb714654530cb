"""BiCGStab(1) on a process grid, on the CPU: gloo ranks, spawned once for
the module on a (2, 2) grid, run the port's BiCGStab(1) iteration on their
shards of the 16x8x6 sharding grid (both topologies). Each iteration's sums
(K13's, plain here) are all-reduced three times: <rhat, v>, then <t, s>
with <t, t>, then <rhat, r>. Each rank counts `all_reduce_sum`'s calls
over a few iterations of a field and of a batch, and runs the sharded
solves beside the single-device ones; the main process holds the counts,
and the shards to the single-device results.
"""

import math

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.parallel import gather_field, shard_pytree, solve_halo, spawn_grid

torch.set_num_threads(1)

KINDS = ("tripolar", "bipolar")
NX, NY, NZ = 16, 8, 6
SHAPE = (2, 2)
SHIFT = 1e-5
ITERS = 4
MEMBERS = 2
#: The sharded solve against the single-device one: the bound
#: tests/test_torch_parallel.py::test_solve holds the sharded engine to
#: (tests/test_sharding.py:726-744).
RTOL_SOLVE, ATOL_SOLVE = 1e-5, 1e-7
#: The sharded refined age's volume-weighted mean against the single-device
#: one (chip_smoke.py's TOL_MEAN_AGE).
TOL_MEAN_AGE = 1e-6


def _case(kind):
    ds = P.synthetic_dataset(nx=NX, ny=NY, nz=NZ, topology=kind, seed=3)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    T = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx).T
    wet = idx.wet3d
    surf = torch.where(wet & (torch.arange(NZ).view(-1, 1, 1) == 0), 1.0, 0.0).double()
    rng = np.random.default_rng(9)
    b = torch.where(wet, torch.from_numpy(rng.standard_normal((MEMBERS,) + tuple(wet.shape))),
                    0.0)
    return gm, T, wet, surf, b


def _mean(field, v3d, wet):
    v = v3d[wet].double()
    return float((field[wet].double() * v).sum() / v.sum())


def _count_reduces(sys_, b):
    """The all_reduce_sum calls of ITERS iterations from the state at b, and
    the field dots made in them."""
    state = S._initial_state(sys_, "bicgstab", b)
    calls = {"reduce": 0, "dot": 0}
    reduce = solve_halo.all_reduce_sum
    dot = sys_.field.dot

    def counted(t, grid):
        calls["reduce"] += 1
        return reduce(t, grid)

    def dots(a, c):
        calls["dot"] += 1
        return dot(a, c)

    solve_halo.all_reduce_sum = counted
    try:
        S._bicgstab_steps(sys_._replace(field=sys_.field._replace(dot=dots)), state, ITERS)
    finally:
        solve_halo.all_reduce_sum = reduce
    return calls


def _rank(grid):
    out = {}
    for kind in KINDS:
        gm, T, wet, surf, b = _case(kind)
        topo = gm.topology
        sh = lambda x: shard_pytree(x, grid, topo.shape2d)
        sys_ = S._system(sh(T), torch.float64, topo, shift=SHIFT, extra_diag=sh(surf),
                         grid=grid)
        out[kind, "field"] = _count_reduces(sys_, sh(b[0]))
        out[kind, "batch"] = _count_reduces(sys_, sh(b))
        for transpose in (False, True):
            kw = dict(shift=SHIFT, extra_diag=surf, tol=1e-10, transpose=transpose)
            ref, ref_res = P.solve_shifted_chunked(T, b[0], topo, **kw)
            x_l, res = P.solve_shifted_chunked(sh(T), sh(b[0]), topo, grid=grid,
                                               **{**kw, "extra_diag": sh(surf)})
            out[kind, "solve", transpose] = (gather_field(x_l, grid), res, ref, ref_res)
        T32 = T.to(torch.float32)
        age, res = P.ideal_age(T32, wet, topo, tol=1e-9, refine=True)
        age_l, res_l = P.ideal_age(sh(T32), sh(wet), topo, tol=1e-9, refine=True, grid=grid)
        out[kind, "age"] = (_mean(gather_field(age_l, grid), gm.v3d, wet), res_l,
                            _mean(age, gm.v3d, wet), res)
    return out if grid.rank == 0 else None


@pytest.fixture(scope="module")
def ranks():
    return spawn_grid(_rank, SHAPE, device="cpu", timeout_s=600)[0]


@pytest.mark.parametrize("what", ["field", "batch"])
@pytest.mark.parametrize("kind", KINDS)
def test_three_all_reduces_an_iteration(ranks, kind, what):
    """<rhat, v>, (<t, s>, <t, t>) and <rhat, r>: three all-reduces an
    iteration, a batch's (B,) sums in each, and no field dot."""
    assert ranks[kind, what] == {"reduce": 3 * ITERS, "dot": 0}


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_solve_against_single_device(ranks, kind, transpose):
    x, res, ref, ref_res = ranks[kind, "solve", transpose]
    assert res < 1e-8 and ref_res < 1e-8
    np.testing.assert_allclose(x.numpy(), ref.numpy(), rtol=RTOL_SOLVE, atol=ATOL_SOLVE)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_refined_age_against_single_device(ranks, kind):
    mean, res, ref_mean, ref_res = ranks[kind, "age"]
    assert res < 1e-9 and ref_res < 1e-9 and math.isfinite(mean)
    assert abs(mean - ref_mean) <= TOL_MEAN_AGE * abs(ref_mean)
