"""The plain reference against otmb_tpu_torch's plain path, on the CPU at
18x14x6 on both topologies, from the same raw case. The test imports both;
the reference imports nothing of the program."""

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_bench import case as cases
from otmb_bench import check as C
from otmb_bench import reference as R

RTOL = 1e-12  # float64 on both sides: rounding only


@pytest.fixture(scope="module", params=["tripolar", "bipolar"])
def both(request):
    torch.set_num_threads(1)
    case = cases.raw_case(18, 14, 6, request.param, 2024, "cpu")
    gm = P.makegridmetrics(areacello=case.areacello, volcello=case.volcello.numpy(),
                           lon=case.lon, lat=case.lat, lev=case.lev,
                           lon_vertices=case.lon_vertices, lat_vertices=case.lat_vertices,
                           dtype=torch.float64, device="cpu")
    idx = P.makeindices(gm.v3d)
    return case, gm, idx


def test_topology_is_the_case_s(both):
    case, gm, _ = both
    assert gm.topology.kind == case.topology


def test_grid_metrics_match(both):
    case, gm, _ = both
    ref = R.grid_metrics(case)
    assert C.gap(gm.v3d, ref["v3d"]) <= RTOL
    for name in ("area2d", "thkcello", "z3d"):
        assert C.gap(getattr(gm, name), ref[name]) <= RTOL, name
    for group in ("edge_length", "distance_to_edge", "distance_to_neighbour"):
        for d in ("east", "west", "north", "south"):
            assert C.gap(getattr(gm, group)[d], ref[f"{group}.{d}"]) <= RTOL, (group, d)


def test_face_fluxes_match(both):
    case, gm, idx = both
    phi = P.facefluxesfrommasstransport(umo=case.umo, vmo=case.vmo, gridmetrics=gm, indices=idx)
    ref = R.face_fluxes(case.umo, case.vmo, idx.wet3d, case.topology == "tripolar")
    assert C.worst_gap(phi._asdict(), ref) <= RTOL


def test_operator_apply_and_euler_match(both):
    case, gm, idx = both
    tripolar = case.topology == "tripolar"
    ops = P.assemble_transport(case.umo, case.vmo, case.mlotst, gm, idx.wet3d)
    ref_grid = R.grid_metrics(case)
    legs = R.operator(ref_grid, R.face_fluxes(case.umo, case.vmo, idx.wet3d, tripolar),
                      case.mlotst, case.lev, tripolar)
    assert C.worst_gap(ops.T._asdict(), legs) <= 1e-12
    # every leg has work to compare, the vertical ones too
    assert all(float(leg.abs().max()) > 0 for leg in legs.values())
    x = torch.where(idx.wet3d, torch.rand(idx.wet3d.shape, dtype=torch.float64,
                                          generator=torch.Generator().manual_seed(3)), 0.0)
    y = P.ops.apply.apply_stencil(ops.T, x, gm.topology)
    assert C.gap(y, R.apply(legs, x, tripolar)) <= 1e-12
    dt = 0.25 / float(ops.T.diag.abs().max())
    want = R.euler(legs, x, dt, 5, tripolar)
    got = P.explicit_euler_propagate(ops.T, x, dt, 5, gm.topology)
    assert C.gap(got, want) <= 1e-12


def test_the_residual_of_a_solve(both):
    case, gm, idx = both
    tripolar = case.topology == "tripolar"
    T = P.assemble_transport(case.umo, case.vmo, case.mlotst, gm, idx.wet3d).T
    age, res = P.ideal_age(T, idx.wet3d, gm.topology, tol=1e-10, refine=True)
    legs = R.operator(R.grid_metrics(case), R.face_fluxes(case.umo, case.vmo, idx.wet3d,
                                                         tripolar), case.mlotst, case.lev,
                      tripolar)
    wet = idx.wet3d
    extra = torch.where(wet & (torch.arange(wet.shape[0]) == 0).reshape(-1, 1, 1), 1.0, 0.0)
    b = wet.double()
    assert R.relative_residual(legs, C.zero_land(age, wet), b, extra, tripolar) < 1e-9
    # a wrong answer shows
    assert R.relative_residual(legs, 1.001 * C.zero_land(age, wet), b, extra, tripolar) > 1e-4


def test_the_seasons_keep_the_fold_antisymmetric():
    case = cases.raw_case(24, 16, 8, "tripolar", 5, "cpu")
    for umo, vmo, ml in cases.seasons(case, 4):
        top = vmo[:, -1, :].double()
        both = torch.isfinite(top) & torch.isfinite(top.flip(-1))  # islands break pairs
        assert torch.allclose(top[both], -top.flip(-1)[both], rtol=1e-6)
        lo, hi = 15.0, 0.8 * float(case.lev[-1])
        finite = ml[torch.isfinite(ml)]
        assert float(finite.min()) >= lo - 1e-3 and float(finite.max()) <= hi + 1e-3
    a = cases.seasons(cases.raw_case(24, 16, 8, "tripolar", 5, "cpu"), 4)
    b = cases.seasons(cases.raw_case(24, 16, 8, "tripolar", 5, "cpu"), 4)
    for x, y in zip(a, b):
        assert all(torch.equal(torch.nan_to_num(u), torch.nan_to_num(v)) for u, v in zip(x, y))


def test_the_case_is_the_device_case_s():
    """The frozen copy draws what `synthetic_device_case` draws."""
    case = cases.raw_case(24, 16, 8, "tripolar", 7, "cpu")
    gm, wet, umo, vmo, ml = P.synthetic_device_case(24, 16, 8, dtype=torch.float64, seed=7,
                                                    device="cpu")
    assert torch.equal(wet, case.wet)
    assert C.gap(umo, case.umo) < 1e-6 and C.gap(vmo, case.vmo) < 1e-6
    assert C.gap(ml, case.mlotst) < 1e-6 and C.gap(gm.v3d, case.volcello) < 1e-6
    np.testing.assert_array_equal(gm.lon_vertices.numpy(), case.lon_vertices)
