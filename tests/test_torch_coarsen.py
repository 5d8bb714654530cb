"""otmb_tpu_torch's LUMP/SPRAY coarsening (`utils/coarsen.py`) against
otmb_tpu's, on the conftest grids (18x14x6, both topologies): LUMP, SPRAY
and vol_c within 1e-12 and the coarsened ages within 1e-9 of otmb_tpu's,
the C++ labeller equal to the Python one, and the five tests of
tests/test_coarsen.py mirrored. The port's native core builds into
`otmb_tpu_torch/_build/` and never falls back to Python silently.
"""

import subprocess

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve

import otmb_tpu_torch as P
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.utils import coarsen as JC
from otmb_tpu_torch import _build
from otmb_tpu_torch.grid.indices import wet_vector
from otmb_tpu_torch.models.transport import buildTkVdeep, buildTkVML
from otmb_tpu_torch.utils import coarsen as C
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

YEAR = 365.25 * 86400.0


@pytest.fixture(scope="module")
def built(dataset, gridmetrics, indices):
    """otmb_tpu's T, the port's grid and indices, and T carried over."""
    phi = jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                       indices=indices)
    jT = jax_transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                             indices=indices).T
    ds = dataset
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    T = coeffs_from_numpy({leg: np.asarray(jT[leg]) for leg in jT._fields}, device="cpu")
    mat = P.coeffs_to_scipy(T, idx, gm.topology)
    wet = idx.wet3d.numpy()
    v = wet_vector(np.nan_to_num(gm.v3d.numpy()), idx)
    return dict(jT=jT, gm=gm, idx=idx, T=T, mat=mat, wet=wet, v=v)


def _same_sparse(a, b, rtol):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    assert abs(a - b).max() <= rtol * abs(b).max()


def _mask(wet):
    mask = np.zeros_like(wet)
    mask[:, : wet.shape[1] // 2, :] = True  # lump only the southern half
    return mask


@pytest.mark.parametrize("kw", [dict(di=2, dj=2, dk=1), dict(di=3, dj=2, dk=2), "mask"],
                         ids=["2x2x1", "3x2x2", "2x2x2 masked"])
def test_lump_and_spray_match_jax(built, kw):
    wet, v, mat = built["wet"], built["v"], built["mat"]
    kw = dict(di=2, dj=2, dk=2, mask=_mask(wet)) if kw == "mask" else kw
    lump, spray, vol_c = C.lump_and_spray(wet, v, mat, **kw)
    jl, js, jv = JC.lump_and_spray(wet, v, mat, **kw)
    _same_sparse(lump, jl, 1e-12)
    _same_sparse(spray, js, 0.0)
    np.testing.assert_allclose(vol_c, jv, rtol=1e-12)


def test_lump_and_spray(built):
    """tests/test_coarsen.py:24: LUMP averages by volume, volume is kept,
    SPRAY copies coarse values back, the coarse operator conserves volume."""
    wet, v, mat = built["wet"], built["v"], built["mat"]
    lump, spray, v_c = C.lump_and_spray(wet, v, mat, di=2, dj=2, dk=1)
    n, n_c = built["idx"].nwet, lump.shape[0]
    assert 0 < n_c < n and spray.shape == (n, n_c)
    np.testing.assert_allclose(np.asarray(lump @ np.ones(n)).ravel(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(v_c.sum(), v.sum(), rtol=1e-12)
    x_c = np.random.default_rng(0).standard_normal(n_c)
    assert set(np.round(np.asarray(spray @ x_c).ravel(), 12)) <= set(np.round(x_c, 12))
    resid = np.abs(v_c @ (lump @ mat @ spray)).max()
    assert resid < 10 * max(np.abs(v @ mat).max(), 1e-12)


def test_lump_respects_region_mask(built):
    """tests/test_coarsen.py:60: outside the mask each wet cell keeps its
    own coarse cell."""
    wet, v, mat = built["wet"], built["v"], built["mat"]
    mask = _mask(wet)
    lump_m, spray_m, _ = C.lump_and_spray(wet, v, mat, mask=mask, di=2, dj=2, dk=2)
    lump, _, _ = C.lump_and_spray(wet, v, mat, di=2, dj=2, dk=2)
    assert lump_m.shape[0] > lump.shape[0]
    spray_csr = spray_m.tocsr()
    assert np.all(np.diff(spray_csr.indptr) == 1)  # one coarse parent per fine cell
    parents = spray_csr.indices
    sizes = np.bincount(parents)
    assert np.all(sizes[parents[~mask[wet]]] == 1)


@pytest.mark.parametrize("kw", [dict(di=2, dj=2, dk=1), dict(di=3, dj=2, dk=2), "mask"],
                         ids=["2x2x1", "3x2x2", "2x2x1 masked"])
def test_native_labels_equal_python(built, kw):
    """The C++ core labels every cell as the Python labeller does: the same
    ids, not only the same partition (both number components in the order
    they first meet them)."""
    wet, v, mat = built["wet"], built["v"], built["mat"]
    kw = dict(di=2, dj=2, dk=1, mask=_mask(wet)) if kw == "mask" else kw
    l_py, s_py, v_py = C.lump_and_spray(wet, v, mat, use_native=False, **kw)
    l_c, s_c, v_c = C.lump_and_spray(wet, v, mat, use_native=True, **kw)
    _same_sparse(l_c, l_py, 0.0)
    _same_sparse(s_c, s_py, 0.0)
    np.testing.assert_array_equal(v_c, v_py)


def test_native_core_builds_into_the_build_dir():
    C.load_native()
    path = C.native_library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == "otmb_tpu_torch"


def test_native_never_falls_back_silently(built, monkeypatch, tmp_path):
    """Without a working g++ the native labeller raises; only use_native=False
    runs the Python one."""
    def no_gxx(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(C, "_native", None)
    monkeypatch.setattr(C, "native_library_path", lambda: tmp_path / "libcoarsen_native.so")
    monkeypatch.setattr(subprocess, "run", no_gxx)
    wet, v, mat = built["wet"], built["v"], built["mat"]
    with pytest.raises(RuntimeError, match="use_native=False"):
        C.lump_and_spray(wet, v, mat)
    lump, _, _ = C.lump_and_spray(wet, v, mat, use_native=False)
    assert lump.shape[0] < built["idx"].nwet


def test_ideal_age_coarsened_matches_jax(built, gridmetrics, indices):
    """tests/test_coarsen.py:109: the coarsened direct solve end to end,
    equal to otmb_tpu's, the reference's range check (0 < volume-mean age <
    2000 yr) and the coarse system solved."""
    gm, idx, T, wet, v, mat = (built[k] for k in ("gm", "idx", "T", "wet", "v", "mat"))
    g3, g_c, vol_c = P.ideal_age_coarsened(T, idx, gm.topology, gm.v3d, di=2, dj=2, dk=1)
    j3, j_c, jvol = JC.ideal_age_coarsened(built["jT"], indices, gridmetrics.topology,
                                           gridmetrics.v3d, di=2, dj=2, dk=1)
    np.testing.assert_allclose(vol_c, jvol, rtol=1e-12)
    assert np.abs(g_c - j_c).max() <= 1e-9 * np.abs(j_c).max()
    assert np.array_equal(np.isnan(g3), np.isnan(np.asarray(j3)))
    assert np.abs(g3[wet] - np.asarray(j3)[wet]).max() <= 1e-9 * np.abs(j_c).max()
    assert np.isfinite(g3[wet]).all() and np.isnan(g3[~wet]).all()
    mean_age_yr = float(v @ g3[wet]) / float(v.sum()) / YEAR
    assert 0.0 < mean_age_yr < 2000.0

    lump, spray, _ = C.lump_and_spray(wet, v, mat, di=2, dj=2, dk=1)
    issrf = wet.copy()
    issrf[1:] = False
    issrf_c = np.asarray(lump @ wet_vector(issrf.astype(float), idx)).ravel() > 0
    a_c = (lump @ mat @ spray).tocsc() + sp.diags(issrf_c.astype(float))
    s_c = np.asarray(lump @ np.ones(mat.shape[0])).ravel()
    assert np.linalg.norm(a_c @ g_c - s_c) / np.linalg.norm(s_c) < 1e-8
    assert np.array_equal(np.asarray(spray @ g_c).ravel(), g3[wet])

    # consistent with the full-resolution matrix-free solve (same order)
    g_full, res = P.ideal_age(T, idx.wet3d, gm.topology, tol=1e-10)
    assert res < 1e-7
    mean_full_yr = float(v @ g_full.numpy()[wet]) / float(v.sum()) / YEAR
    assert 0.2 < mean_age_yr / mean_full_yr < 5.0


def test_coarse_fine_cross_check(built, dataset):
    """tests/test_coarsen.py:178: identity coarsening reproduces the fine
    direct solve, a purely vertical operator coarsened 2x2x1 reproduces the
    fine ages, and the full T's volume-mean age stays in the band of the
    matrix-free fine solve."""
    gm, idx, T, wet, v, mat = (built[k] for k in ("gm", "idx", "T", "wet", "v", "mat"))
    issrf = wet.copy()
    issrf[1:] = False
    m = sp.diags(wet_vector(issrf.astype(float), idx))
    g_fine = spsolve((mat + m).tocsc(), np.ones(mat.shape[0]))
    g_id, _, _ = P.ideal_age_coarsened(T, idx, gm.topology, gm.v3d, di=1, dj=1, dk=1)
    np.testing.assert_allclose(g_id[wet], g_fine, rtol=1e-10)

    tv = P.add_coeffs(buildTkVdeep(gridmetrics=gm, indices=idx),
                      buildTkVML(mlotst=dataset.mlotst, gridmetrics=gm, indices=idx))
    mat_v = P.coeffs_to_scipy(tv, idx, gm.topology)
    gv_fine = spsolve((mat_v + m).tocsc(), np.ones(mat_v.shape[0]))
    gv_c, _, _ = P.ideal_age_coarsened(tv, idx, gm.topology, gm.v3d, di=2, dj=2, dk=1)
    np.testing.assert_allclose(gv_c[wet], gv_fine, rtol=1e-8)

    g_c, _, _ = P.ideal_age_coarsened(T, idx, gm.topology, gm.v3d, di=2, dj=2, dk=1)
    g_mf, res = P.ideal_age(T, idx.wet3d, gm.topology, tol=1e-10)
    assert res < 1e-7
    mean_c = float(v @ g_c[wet]) / v.sum() / YEAR
    mean_f = float(v @ g_mf.numpy()[wet]) / v.sum() / YEAR
    assert 0.15 < mean_c / mean_f < 1.1
