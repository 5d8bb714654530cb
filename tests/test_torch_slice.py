"""The whole slice through otmb_tpu_torch's public API: the frozen golden
operator and ages (tests/data/golden_tile.npz, as in test_golden.py), and
the same pipeline end to end against otmb_tpu, on the CPU."""

import os

import numpy as np
import pytest
import torch

import otmb_tpu as J
import otmb_tpu_torch as P

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_tile.npz")

SLICE_NAMES = (
    "makegridmetrics", "makeindices", "facefluxesfrommasstransport", "transportmatrix",
    "assemble_transport", "apply_stencil", "apply_stencil_transpose", "transpose_coeffs",
    "operator_diagnostics", "explicit_euler_propagate", "ideal_age", "synthetic_dataset",
    "StencilCoeffs", "coeffs_to_scipy", "stencil_apply", "euler_step", "euler_propagate",
    "tridiag_solve", "assemble_T",
)


def _slice(pkg, topology, **gm_kw):
    ds = pkg.synthetic_dataset(nx=18, ny=14, nz=6, topology=topology, seed=3)
    gm = pkg.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat, lev=ds.lev,
        lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices, **gm_kw)
    idx = pkg.makeindices(gm.v3d)
    phi = pkg.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    ops = pkg.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx)
    return ds, gm, idx, ops


@pytest.mark.parametrize("topology", ["tripolar", "bipolar"])
def test_slice_matches_golden(topology):
    golden = np.load(GOLDEN)
    ds, gm, idx, ops = _slice(P, topology, device="cpu")
    for T in (ops.T, P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)):
        mat = P.coeffs_to_scipy(T, idx, gm.topology).tocoo()
        order = np.lexsort((mat.col, mat.row))
        np.testing.assert_array_equal(mat.row[order], golden[f"{topology}_rows"])
        np.testing.assert_array_equal(mat.col[order], golden[f"{topology}_cols"])
        np.testing.assert_allclose(mat.data[order], golden[f"{topology}_vals"], rtol=1e-12,
                                   atol=1e-24)
    age, res = P.ideal_age(ops.T, idx.wet3d, gm.topology, tol=1e-12)
    assert res < 1e-10
    age_wet = age[idx.wet3d].numpy()
    np.testing.assert_allclose(age_wet, golden[f"{topology}_age_wet"], rtol=1e-8, atol=1e-2)
    assert 0.0 < float(age_wet.mean()) / (86400.0 * 365.25) < 2000.0


@pytest.mark.parametrize("topology", ["tripolar", "bipolar"])
def test_slice_matches_jax_end_to_end(topology):
    """Fused assembly, propagation and the refined f32 ideal age of the
    port against the JAX package's main path on the same seed."""
    ds, gm, idx, ops = _slice(P, topology, device="cpu")
    jds, jgm, jidx, jops = _slice(J, topology)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    for leg in T._fields:
        np.testing.assert_allclose(T[leg].numpy(), np.asarray(jops.T[leg]), rtol=1e-12,
                                   atol=1e-18, err_msg=leg)
    wet = idx.wet3d
    chi = wet.double()
    dt = 0.25 / float(T.diag.abs().max())
    got = P.explicit_euler_propagate(T, chi, dt, 50, gm.topology)
    want = J.explicit_euler_propagate(jops.T, np.asarray(jidx.wet3d, float), dt, 50,
                                      jgm.topology)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    import jax

    age, res = P.ideal_age(T.to(torch.float32), wet, gm.topology, tol=1e-9, refine=True)
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), jops.T)
    jage, _ = J.ideal_age(c32, jidx.wet3d, jgm.topology, tol=1e-9, refine=True)
    assert res < 1e-9
    w = wet.numpy()
    np.testing.assert_allclose(age.numpy()[w], np.asarray(jage)[w], rtol=1e-6, atol=1e-4)


def test_public_api():
    for name in SLICE_NAMES:
        assert name in P.__all__ and hasattr(P, name), name
    assert all(hasattr(P, name) for name in P.__all__)
