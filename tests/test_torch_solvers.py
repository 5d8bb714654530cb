"""otmb_tpu_torch solvers against otmb_tpu and against host direct solves:
explicit propagation, the preconditioners, BiCGStab, mixed-precision
refinement and the ideal age, on the CPU."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import otmb_tpu_torch as P
from otmb_tpu.models.solvers import explicit_euler_propagate as jax_propagate
from otmb_tpu.models.solvers import ideal_age as jax_ideal_age
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu_torch.models.solvers import _tridiag_preconditioner, solve_shifted_ir
from otmb_tpu_torch.models.transport import buildTkVdeep, buildTkVML
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

YEAR_S = 365.25 * 24 * 3600


@pytest.fixture(scope="module")
def jax_T(dataset, gridmetrics, indices):
    phi = jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                       indices=indices)
    return jax_transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                               indices=indices).T


@pytest.fixture(scope="module")
def port(dataset):
    gm = P.makegridmetrics(
        areacello=dataset.areacello, volcello=dataset.volcello, lon=dataset.lon,
        lat=dataset.lat, lev=dataset.lev, lon_vertices=dataset.lon_vertices,
        lat_vertices=dataset.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gm,
                                        indices=idx)
    T = P.transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gm, indices=idx).T
    return gm, idx, T


def _system(T, idx, topo, transpose=False):
    """The host sparse matrix of (T + M) (or its transpose), M the surface mask."""
    mat = P.coeffs_to_scipy(T, idx, topo)
    surf = np.zeros(idx.shape)
    surf[0] = 1.0
    m_diag = P.wet_vector(np.where(idx.wet3d.numpy(), surf, 0.0), idx)
    a = mat.T if transpose else mat
    return (a + sp.diags(m_diag)).tocsc()


def test_explicit_propagate_conserves_mass(port):
    gm, idx, T = port
    wet = idx.wet3d
    rng = np.random.default_rng(1)
    chi = torch.where(wet, 1.0 + 0.1 * torch.from_numpy(rng.standard_normal(gm.shape)), 0.0)
    v = torch.where(wet, gm.v3d, 0.0)
    dt = 0.25 / float(T.diag.abs().max())
    out = P.explicit_euler_propagate(T, chi, dt, 200, gm.topology)
    m0, m1 = float((chi * v).sum()), float((out * v).sum())
    assert abs(m1 - m0) / abs(m0) < 1e-12
    assert bool((out[~wet] == 0).all())
    assert bool(torch.isfinite(out[wet]).all())


def test_explicit_propagate_matches_jax(port, jax_T, gridmetrics):
    gm, idx, T = port
    rng = np.random.default_rng(2)
    chi = np.where(idx.wet3d.numpy(), rng.standard_normal(gm.shape), 0.0)
    dt = 0.25 / float(T.diag.abs().max())
    want = np.asarray(jax_propagate(jax_T, chi, dt, 20, gridmetrics.topology))
    got = P.explicit_euler_propagate(T, torch.from_numpy(chi), dt, 20, gm.topology)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    step = P.explicit_euler_step(T, torch.from_numpy(chi), dt, gm.topology)
    np.testing.assert_allclose(
        step.numpy(), chi - dt * P.apply_stencil(T, torch.from_numpy(chi), gm.topology).numpy())


def test_ideal_age_matches_jax_and_direct_solve(port, jax_T, gridmetrics, indices):
    gm, idx, T = port
    wet = idx.wet3d.numpy()
    gamma, res = P.ideal_age(T, idx.wet3d, gm.topology, tol=1e-10)
    assert res < 1e-6
    assert bool(torch.isnan(gamma[~idx.wet3d]).all())
    ref, _ = jax_ideal_age(jax_T, indices.wet3d, gridmetrics.topology, tol=1e-10)
    np.testing.assert_allclose(gamma.numpy()[wet], np.asarray(ref)[wet], rtol=1e-6, atol=1e-4)
    direct = spla.spsolve(_system(T, idx, gm.topology), np.ones(idx.nwet))
    np.testing.assert_allclose(gamma.numpy()[wet], direct, rtol=1e-5, atol=1e-3)
    v = gm.v3d.numpy()[wet]
    mean_age_yr = float((gamma.numpy()[wet] * v).sum() / v.sum()) / YEAR_S
    assert 0.0 < mean_age_yr < 2000.0  # reference test/local_full.jl:165-188


def test_refined_float32_ideal_age(port, jax_T, gridmetrics, indices):
    """f32 coefficients + f64 defects reach residuals far below the f32
    Krylov floor, and match the f64 solve up to the f32 rounding of T."""
    gm, idx, T = port
    wet = idx.wet3d.numpy()
    stats = {}
    gamma, res = P.ideal_age(T.to(torch.float32), idx.wet3d, gm.topology, tol=1e-9,
                             refine=True, stats=stats)
    assert gamma.dtype == torch.float64
    assert res < 1e-9
    assert stats["rel_final"] == res and stats["refinements"] == len(stats["passes"])
    assert stats["passes"][0]["rel_start"] == 1.0
    assert all(p["inner_iters"] > 0 for p in stats["passes"])
    ref, _ = jax_ideal_age(jax_T, indices.wet3d, gridmetrics.topology, tol=1e-10)
    np.testing.assert_allclose(gamma.numpy()[wet], np.asarray(ref)[wet], rtol=1e-3, atol=1.0)


def test_refined_ideal_age_matches_jax_refined(port, jax_T, gridmetrics, indices):
    import jax

    gm, idx, T = port
    wet = idx.wet3d.numpy()
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), jax_T)
    ref, jres = jax_ideal_age(c32, indices.wet3d, gridmetrics.topology, tol=1e-9, refine=True)
    got, res = P.ideal_age(T.to(torch.float32), idx.wet3d, gm.topology, tol=1e-9, refine=True)
    assert res < 1e-9 and float(jres) < 1e-9
    np.testing.assert_allclose(got.numpy()[wet], np.asarray(ref)[wet], rtol=1e-6, atol=1e-4)


def test_tridiag_preconditioner_exact_on_vertical_operator(dataset, port):
    """M^-1 of the purely vertical operator is its exact inverse."""
    gm, idx, _ = port
    tkv = P.add_coeffs(
        buildTkVML(mlotst=dataset.mlotst, gridmetrics=gm, indices=idx),
        buildTkVdeep(gridmetrics=gm, indices=idx),
    )
    rng = np.random.default_rng(0)
    b = torch.where(idx.wet3d, torch.from_numpy(rng.standard_normal(gm.shape)), 0.0)
    shift = 1e-7
    x = _tridiag_preconditioner(tkv, shift + tkv.diag)(b)
    resid = shift * x + P.apply_stencil(tkv, x, gm.topology) - b
    assert float(resid[idx.wet3d].abs().max()) < 1e-8 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("preconditioner", ["jacobi", "tridiag"])
def test_solve_shifted_converges(port, preconditioner):
    gm, idx, T = port
    wet = idx.wet3d
    ones = wet.double()
    surf = torch.zeros(gm.shape, dtype=torch.float64)
    surf[0] = 1.0
    surf = torch.where(wet, surf, 0.0)
    stats = {}
    _, res = P.solve_shifted(T, ones, gm.topology, extra_diag=surf, tol=1e-12, maxiter=200,
                             preconditioner=preconditioner, stats=stats)
    assert res < 1e-8
    assert 0 < stats["iters"] <= 200
    if preconditioner == "tridiag":
        # stiff implicit step, tight budget: the line preconditioner still converges
        _, res_t = P.solve_shifted(T, ones, gm.topology, shift=1e-9, tol=1e-12, maxiter=60)
        assert res_t < 1e-6


def test_solve_shifted_transpose_matches_direct(port):
    """The adjoint system (T' + M) x = 1, through transpose_coeffs."""
    gm, idx, T = port
    wet = idx.wet3d
    surf = torch.zeros(gm.shape, dtype=torch.float64)
    surf[0] = 1.0
    surf = torch.where(wet, surf, 0.0)
    x, res = P.solve_shifted(T, wet.double(), gm.topology, extra_diag=surf, tol=1e-12,
                             transpose=True)
    assert res < 1e-9
    direct = spla.spsolve(_system(T, idx, gm.topology, transpose=True), np.ones(idx.nwet))
    np.testing.assert_allclose(x.numpy()[wet.numpy()], direct, rtol=1e-6, atol=1e-3)


def test_solve_shifted_ir_stagnation_warns(port):
    """Inner solves that do nothing (no iteration budget) leave the defect
    unchanged; the first such stalled pass stops the refinement with a
    warning."""
    gm, idx, T = port
    b = idx.wet3d.to(torch.float32)
    stats = {}
    with pytest.warns(UserWarning, match="stagnated"):
        x, res = solve_shifted_ir(T.to(torch.float32), b, gm.topology, shift=1e-3, tol=1e-9,
                                  maxiter=0, stats=stats)
    assert stats["passes"][-1].get("stagnated") is True
    assert stats["refinements"] == 2
    assert res == pytest.approx(1.0) and bool((x == 0).all())


def test_solve_shifted_ir_reaches_tol_without_warning(port):
    gm, idx, T = port
    b = idx.wet3d.to(torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, res = solve_shifted_ir(T.to(torch.float32), b, gm.topology, shift=1e-6, tol=1e-10)
    assert res <= 1e-10 and x.dtype == torch.float64


@pytest.mark.parametrize("topology", ["bipolar", "tripolar"])
def test_degenerate_grid_ideal_age(topology):
    """Every degenerate feature (test_degenerate_grids.py) gets a finite
    age, in f64 and through the refined f32 path."""
    from test_degenerate_grids import _degenerate_case

    ds = _degenerate_case(topology)
    gm = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat, lev=ds.lev,
        lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    wet = idx.wet3d
    gamma, res = P.ideal_age(T, wet, gm.topology, tol=1e-9)
    assert res < 1e-7
    assert bool(torch.isfinite(gamma[wet]).all()) and bool((gamma[wet] >= -1e-6).all())
    # the isolated basin has only surface restoring: age = 1/surface_rate = 1 s
    assert float(gamma[0, 3, 5]) == pytest.approx(1.0, rel=1e-9)
    g32, res32 = P.ideal_age(T.to(torch.float32), wet, gm.topology, tol=1e-9, refine=True)
    assert res32 < 1e-9
    np.testing.assert_allclose(g32[wet].numpy(), gamma[wet].numpy(), rtol=1e-3, atol=1.0)
