"""otmb_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU and skips without one. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.ops import stencil, tridiag
from otmb_tpu_torch.ops.tridiag import tridiag_solve_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels compile and run only there")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=["tripolar", "bipolar"])
def case(request, device):
    ds = P.synthetic_dataset(nx=36, ny=28, nz=10, topology=request.param, seed=3)
    gm = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat, lev=ds.lev,
        lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices, device=device)
    idx = P.makeindices(gm.v3d)
    T = P.assemble_transport(ds.umo, ds.vmo, ds.mlotst, gm, idx.wet3d).T
    rng = np.random.default_rng(4)
    chi = torch.where(idx.wet3d, torch.as_tensor(rng.standard_normal(gm.shape),
                                                 device=device), 0.0)
    return ds, gm, idx, T, chi


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("types", ["f64,f64", "f32,f64", "f32,f32", "bf16,f32"])
def test_k1_equals_plain(case, types):
    _, gm, _, T, chi = case
    ctype, vtype = ({"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[t]
                    for t in types.split(","))
    topo = gm.topology
    x = chi.to(vtype)
    dt = 0.25 / float(T.diag.abs().max())
    for c in (T.to(ctype), P.transpose_coeffs(T, topo).to(ctype)):
        torch.testing.assert_close(P.stencil_apply(c, x, topo),
                                   P.apply_stencil(c, x, topo), rtol=0, atol=0)
        torch.testing.assert_close(P.euler_step(c, x, dt, topo),
                                   x - dt * P.apply_stencil(c, x, topo), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k2_equals_plain(case, dtype):
    _, _, idx, T, chi = case
    surf = torch.zeros_like(chi)
    surf[0] = 1.0
    shifted = (T.diag + torch.where(idx.wet3d, surf, 0.0)).to(dtype)
    args = (T.bottom.to(dtype), torch.where(shifted != 0, shifted, 1.0), T.top.to(dtype),
            chi.to(dtype))
    torch.testing.assert_close(P.tridiag_solve(*args), tridiag_solve_plain(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["upwind", "centered", "rho3d"])
def test_k4_matches_plain(case, variant):
    ds, gm, idx, _, _ = case
    kw = {"upwind": variant != "centered"}
    if variant == "rho3d":
        rng = np.random.default_rng(5)
        kw["rho"] = torch.as_tensor(
            np.where(ds.wet3d, 1025.0 + 20.0 * rng.random(ds.umo.shape), np.nan),
            device=gm.v3d.device)
    got = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm, **kw)
    want = P.assemble_transport(ds.umo, ds.vmo, ds.mlotst, gm, idx.wet3d, **kw).T
    for leg in got._fields:
        assert _rel(got[leg], want[leg]) <= 1e-12, leg


def test_refined_ideal_age_goes_through_the_kernels(case):
    ds, gm, idx, _, _ = case
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm).to(torch.float32)
    k1, k2 = stencil.LAUNCHES, tridiag.LAUNCHES
    gamma, res = P.ideal_age(T, idx.wet3d, gm.topology, tol=1e-9, refine=True)
    assert res < 1e-9
    assert bool(torch.isfinite(gamma[idx.wet3d]).all())
    assert stencil.LAUNCHES > k1 and tridiag.LAUNCHES > k2


def test_wrappers_raise_on_card(case):
    _, gm, _, T, chi = case
    topo = gm.topology
    with pytest.raises(ValueError, match="not contiguous"):
        P.stencil_apply(T, chi.transpose(1, 2).contiguous().transpose(1, 2), topo)
    with pytest.raises(ValueError, match="on cpu"):
        P.stencil_apply(T._replace(diag=T.diag.cpu()), chi, topo)
    with pytest.raises(ValueError):
        P.tridiag_solve(T.bottom, T.diag, T.top.cpu(), chi)
