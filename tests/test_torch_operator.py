"""otmb_tpu_torch operator layer against otmb_tpu: face fluxes, the four
operator components leg by leg, the transpose, diagnostics and the sparse
export, in float64 on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops import apply as japply
from otmb_tpu.ops.coeffs import advection_coeffs as jax_advection_coeffs
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.utils.sparse_export import coeffs_to_scipy as jax_coeffs_to_scipy
from otmb_tpu_torch.ops.coeffs import advection_coeffs
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

COMPONENTS = ("T", "Tadv", "TkH", "TkVML", "TkVdeep")
MYR = 1e6 * 365.25 * 24 * 3600


def grid_kwargs(ds):
    return dict(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
                lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices)


@pytest.fixture(scope="module")
def port(dataset):
    gm = P.makegridmetrics(**grid_kwargs(dataset), device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=dataset.umo, vmo=dataset.vmo,
                                        gridmetrics=gm, indices=idx)
    return gm, idx, phi


@pytest.fixture(scope="module")
def jax_phi(dataset, gridmetrics, indices):
    return jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                        indices=indices)


def assert_legs(got, want, rtol=1e-12, atol=1e-18, what=""):
    for leg in P.StencilCoeffs._fields:
        np.testing.assert_allclose(got[leg].numpy(), np.asarray(want[leg]), rtol=rtol,
                                   atol=atol, err_msg=f"{what}.{leg}")


def test_facefluxes_match_jax(port, jax_phi):
    _, _, phi = port
    for face in phi._fields:
        np.testing.assert_allclose(getattr(phi, face).numpy(),
                                   np.asarray(getattr(jax_phi, face)),
                                   rtol=1e-12, atol=1e-6, err_msg=face)


@pytest.mark.parametrize("upwind", [True, False], ids=["upwind", "centered"])
def test_operator_legs_match_jax(dataset, port, jax_phi, gridmetrics, indices, upwind):
    gm, idx, phi = port
    got = P.transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gm, indices=idx,
                            upwind=upwind)
    want = jax_transportmatrix(phi=jax_phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                               indices=indices, upwind=upwind)
    for comp in COMPONENTS:
        assert_legs(getattr(got, comp), getattr(want, comp), what=comp)
    plain = P.assemble_transport(dataset.umo, dataset.vmo, dataset.mlotst, gm, idx.wet3d,
                                 upwind=upwind)
    for comp in COMPONENTS:
        assert_legs(getattr(plain, comp), getattr(want, comp), what=f"assemble_transport {comp}")


def test_advection_3d_rho_matches_jax(dataset, port, jax_phi, gridmetrics, indices):
    gm, idx, phi = port
    rng = np.random.default_rng(5)
    rho = np.where(dataset.wet3d, 1025.0 + 20.0 * rng.random(dataset.umo.shape), np.nan)
    got = advection_coeffs(phi, gm, idx.wet3d, torch.from_numpy(rho))
    want = jax_advection_coeffs(jax_phi, gridmetrics, indices.wet3d, jnp.asarray(rho))
    assert_legs(got, want, what="Tadv(rho3d)")


def test_transpose_matches_jax(dataset, jax_phi, gridmetrics, indices):
    """The JAX operator, carried over with coeffs_from_numpy: the port's
    transpose apply and transpose_coeffs equal the JAX package's."""
    jT = jax_transportmatrix(phi=jax_phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                             indices=indices).T
    T = coeffs_from_numpy({leg: np.asarray(jT[leg]) for leg in jT._fields}, device="cpu")
    topo = gridmetrics.topology
    rng = np.random.default_rng(6)
    chi = np.where(dataset.wet3d, rng.standard_normal(dataset.umo.shape), 0.0)
    x = torch.from_numpy(chi)
    want = np.asarray(japply.apply_stencil_transpose(jT, chi, topo))
    got = P.apply_stencil_transpose(T, x, topo)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-20)
    via_coeffs = P.apply_stencil(P.transpose_coeffs(T, topo), x, topo)
    np.testing.assert_allclose(via_coeffs.numpy(), got.numpy(), rtol=1e-12, atol=1e-20)
    assert_legs(P.transpose_coeffs(T, topo), japply.transpose_coeffs(jT, topo),
                rtol=0, atol=0, what="transpose_coeffs")


def test_operator_diagnostics(dataset, port, gridmetrics, indices, jax_phi):
    gm, idx, phi = port
    ops = P.transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gm, indices=idx)
    jops = jax_transportmatrix(phi=jax_phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                               indices=indices)
    for comp in COMPONENTS:
        d = P.operator_diagnostics(getattr(ops, comp), gm.v3d, idx.wet3d, gm.topology)
        jd = japply.operator_diagnostics(getattr(jops, comp), gridmetrics.v3d,
                                         indices.wet3d, gridmetrics.topology)
        # volume conservation holds for every component (roundoff-limited)
        assert float(d["tau_vol_s"]) / MYR > 1.0, comp
        if comp in ("TkH", "TkVML", "TkVdeep"):
            assert float(d["tau_div_s"]) / MYR > 1.0, comp
        else:  # finite, physical: surface evaporation/precipitation
            np.testing.assert_allclose(float(d["tau_div_s"]), float(jd["tau_div_s"]),
                                       rtol=1e-9, err_msg=comp)


def test_coeffs_to_scipy_matches_jax(dataset, port, jax_phi, gridmetrics, indices):
    gm, idx, phi = port
    ops = P.transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gm, indices=idx)
    jops = jax_transportmatrix(phi=jax_phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                               indices=indices)
    a = P.coeffs_to_scipy(ops.T, idx, gm.topology).tocoo()
    b = jax_coeffs_to_scipy(jops.T, indices, gridmetrics.topology).tocoo()
    oa, ob = np.lexsort((a.col, a.row)), np.lexsort((b.col, b.row))
    np.testing.assert_array_equal(a.row[oa], b.row[ob])
    np.testing.assert_array_equal(a.col[oa], b.col[ob])
    np.testing.assert_allclose(a.data[oa], b.data[ob], rtol=1e-12, atol=1e-24)


def test_upwind_sign_structure(dataset, port):
    gm, idx, phi = port
    T = P.transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gm, indices=idx).T
    wet = idx.wet3d
    assert bool((T.diag[wet] > 0).all())
    for leg in ("east", "west", "north", "south", "top", "bottom"):
        assert bool((T[leg][wet] <= 0).all()), leg
        assert bool((T[leg][~wet] == 0).all()), leg


def test_nan_guard_raises(dataset, port):
    gm, idx, phi = port
    wet = idx.wet3d.numpy()
    j, i = np.argwhere(wet[0])[len(np.argwhere(wet[0])) // 2]
    east = gm.edge_length.east.clone()
    east[j, i] = float("nan")
    bad = dataclasses.replace(gm, edge_length=dataclasses.replace(gm.edge_length, east=east))
    with pytest.raises(FloatingPointError, match="TkH"):
        P.transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=bad, indices=idx)


def _oracle_T(ds, gm, idx, upwind):
    """The reference's per-cell loops (tests/reference_oracle.py), as a
    dense matrix over wet cells."""
    from reference_oracle import (
        gm_to_numpy,
        oracle_advection_matrix,
        oracle_facefluxes,
        oracle_horizontal_diffusion_matrix,
        oracle_vertical_diffusion_matrix,
    )

    wet = idx.wet3d.numpy()
    phi_o = oracle_facefluxes(ds.umo, ds.vmo, wet, gm.topology)
    gm_np = gm_to_numpy(gm)
    omega = P.ops.coeffs.mixed_layer_mask(gm, torch.as_tensor(ds.mlotst)).numpy()
    return phi_o, (
        oracle_advection_matrix(phi_o, gm_np["v3d"], 1035.0, wet, gm.topology, upwind=upwind)
        + oracle_horizontal_diffusion_matrix(gm_np, wet, gm.topology, 500.0)
        + oracle_vertical_diffusion_matrix(gm_np, wet, gm.topology, 0.1, omega=omega)
        + oracle_vertical_diffusion_matrix(gm_np, wet, gm.topology, 1e-5)
    ).toarray()


def _port_slice(ds, upwind=True):
    gm = P.makegridmetrics(**grid_kwargs(ds), device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    ops = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx,
                            upwind=upwind)
    return gm, idx, phi, ops


@pytest.mark.parametrize("seed", [11, 22, 33, 44])
@pytest.mark.parametrize("topology", ["bipolar", "tripolar"])
def test_operator_fuzz_matches_oracle(seed, topology):
    """Random grids, land masks and flows (as test_fuzz_parity.py) against
    the per-cell oracle, through the plain operator and the K4 entry point."""
    rng = np.random.default_rng(seed)
    ds = P.synthetic_dataset(nx=12, ny=8, nz=4, topology=topology, seed=seed,
                             land_fraction=float(rng.uniform(0.0, 0.35)),
                             antisymmetric_seam=bool(seed % 2))
    upwind = bool(seed % 2)
    gm, idx, phi, ops = _port_slice(ds, upwind)
    phi_o, ref = _oracle_T(ds, gm, idx, upwind)
    for face in phi._fields:
        np.testing.assert_allclose(getattr(phi, face).numpy(), phi_o[face], rtol=1e-12,
                                   atol=1e-6, err_msg=face)
    fused = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm, upwind=upwind)
    for T in (ops.T, fused):
        ours = P.coeffs_to_scipy(T, idx, gm.topology).toarray()
        np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("topology", ["bipolar", "tripolar"])
def test_degenerate_grid_matches_oracle(topology):
    """One-cell basins, single-layer columns, deep mixed layers, a
    zero-volume hole and a seam-straddling sea (test_degenerate_grids.py)."""
    from test_degenerate_grids import _degenerate_case

    ds = _degenerate_case(topology)
    gm, idx, _, ops = _port_slice(ds)
    wet = idx.wet3d.numpy()
    assert not wet[1, 2, 10] and wet[2, 2, 10]  # the zero-volume hole is dry
    _, ref = _oracle_T(ds, gm, idx, True)
    ours = P.coeffs_to_scipy(ops.T, idx, gm.topology).toarray()
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-15)
    diag = np.diag(ours)
    assert (diag >= 0).all() and ((ours - np.diag(diag)) <= 1e-18).all()
