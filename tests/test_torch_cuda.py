"""otmb_tpu_torch's CUDA kernels against their plain PyTorch versions (and
K5 against K1, member by member), on the card. Every test here needs an
NVIDIA GPU and skips without one. The file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.models import redi_kernel
from otmb_tpu_torch.ops import krylov, stencil, tridiag
from otmb_tpu_torch.ops.krylov import fused_krylov_step_plain
from otmb_tpu_torch.ops.tridiag import tridiag_solve_plain
from otmb_tpu_torch.utils import profiling

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


def _k3_inputs(case, dtype, transpose):
    """The ideal-age system's operator in the engine's form, and random
    x1, x2, rhat on wet cells."""
    _, gm, idx, T, chi = case
    topo = gm.topology
    c = P.transpose_coeffs(T, topo) if transpose else T
    surf = torch.zeros_like(chi)
    surf[0] = 1.0
    shifted = c.diag + torch.where(idx.wet3d, surf, 0.0)
    a = c._replace(diag=shifted).to(dtype)
    m = (a.bottom, torch.where(a.diag != 0, a.diag, 1.0), a.top)
    rng = np.random.default_rng(6)
    vec = lambda: torch.where(idx.wet3d, torch.as_tensor(rng.standard_normal(gm.shape),
                                                         device=chi.device), 0.0).to(dtype)
    return topo, a, m, vec(), vec(), vec()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("flags", [(True, True), (True, False), (False, False), (False, True)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k3_equals_composition(case, dtype, flags, transpose):
    """z and out equal the K2 + K1 composition (and the plain version) bit
    for bit; d is within its stated bound of the f64 dot of the plain out,
    and the same bits on a second call."""
    topo, a, m, x1, x2, rhat = _k3_inputs(case, dtype, transpose)
    combine, dot = flags
    c2 = torch.tensor(-0.37, dtype=dtype, device=x1.device)
    kw = dict(with_combine=combine, with_dot=dot)
    scratch = krylov.krylov_scratch(*m)
    n0 = krylov.LAUNCHES
    z, out, d = P.fused_krylov_step(a, *m, x1, x2, c2, rhat, topo, scratch=scratch, **kw)
    assert krylov.LAUNCHES == n0 + 1
    want_z = x1 + c2 * x2 if combine else x1
    want_out = P.stencil_apply(a, P.tridiag_solve(*m, want_z), topo)
    torch.testing.assert_close(z, want_z, rtol=0, atol=0)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    pz, pout, pd = fused_krylov_step_plain(a, *m, x1, x2, c2, rhat, topo, **kw)
    torch.testing.assert_close(out, pout, rtol=0, atol=0)
    if not dot:
        assert d is None and pd is None
        return
    ref = torch.dot(rhat.double().flatten(), pout.double().flatten())
    scale = float((rhat.double() * pout.double()).abs().sum())
    bound = (1e-5 if dtype == torch.float32 else 1e-12) * scale
    assert abs(float(d) - float(ref)) <= bound
    _, _, d2 = P.fused_krylov_step(a, *m, x1, x2, c2, rhat, topo, **kw)  # factors M anew
    assert torch.equal(d, d2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k3_factorization_equals_plain(case, dtype):
    topo, a, m, _, _, _ = _k3_inputs(case, dtype, False)
    got = krylov.krylov_scratch(*m)
    cp, rden = krylov.krylov_factor_plain(*m)
    torch.testing.assert_close(got.cp, cp, rtol=0, atol=0)
    torch.testing.assert_close(got.rden, rden, rtol=0, atol=0)
    with pytest.raises(ValueError, match="other Thomas legs"):
        P.fused_krylov_step(a, *m, m[1], None, 0.0, None, topo, with_combine=False,
                            with_dot=False, scratch=krylov.krylov_scratch(*(t.clone() for t in m)))


def test_k10_equals_plain(device):
    thunk, nbytes = P.dma_peak_probe(nstreams=7, mbytes=8, device=device)
    assert nbytes == 8 * 8 * 1024 * 1024
    gen = torch.Generator(device=device).manual_seed(0)
    streams = [torch.randn((8, 512, 512), generator=gen, device=device) for _ in range(7)]
    n0 = profiling.LAUNCHES
    got = thunk()
    assert profiling.LAUNCHES == n0 + 1
    torch.testing.assert_close(got, profiling.probe_sum_plain(streams), rtol=0, atol=0)
    torch.testing.assert_close(profiling.probe_sum(streams[:3]),
                               profiling.probe_sum_plain(streams[:3]), rtol=0, atol=0)


@pytest.mark.parametrize("workload", ["ideal_age", "sequestration_time"])
def test_refined_bicgstab2_goes_through_k3(case, workload):
    ds, gm, idx, _, _ = case
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm).to(torch.float32)
    n3 = krylov.LAUNCHES
    stats = {}
    gamma, res = getattr(P, workload)(T, idx.wet3d, gm.topology, tol=1e-9, refine=True,
                                      algorithm="bicgstab2", stats=stats)
    assert res < 1e-9
    assert bool(torch.isfinite(gamma[idx.wet3d]).all())
    assert krylov.LAUNCHES > n3
    assert all(p["inner_stop"] in ("converged", "stall", "maxiter", "diverged")
               for p in stats["passes"])


def test_fused_and_unfused_engines_agree(case):
    _, gm, idx, T, _ = case
    b = idx.wet3d.to(torch.float32)
    kw = dict(shift=1e-3, tol=1e-6, chunk=20, algorithm="bicgstab2")
    xf, rf = P.solve_shifted_chunked(T.to(torch.float32), b, gm.topology, fused=True, **kw)
    xc, rc = P.solve_shifted_chunked(T.to(torch.float32), b, gm.topology, fused=False, **kw)
    # the residual is recomputed in f32, whose rounding floor on this
    # system is ~1e-5 (1.04e-5 for the fused solve on an H100)
    assert rf < 1e-4 and rc < 1e-4
    scale = float(xc.abs().max())
    assert float((xf - xc).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("nmembers", [1, 3, 8])
@pytest.mark.parametrize("types", ["f64,f64", "f32,f64", "f32,f32", "bf16,f32"])
def test_k5_equals_k1_per_member(case, types, nmembers):
    """K5's member b equals K1 on member b bit for bit (apply and Euler
    step, T and T'), and one K5 launch serves the whole batch."""
    _, gm, idx, T, chi = case
    ctype, vtype = ({"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[t]
                    for t in types.split(","))
    topo = gm.topology
    rng = np.random.default_rng(7)
    xs = torch.where(idx.wet3d, torch.as_tensor(rng.standard_normal((nmembers,) + gm.shape),
                                                device=chi.device), 0.0).to(vtype)
    dt = 0.25 / float(T.diag.abs().max())
    for c in (T.to(ctype), P.transpose_coeffs(T, topo).to(ctype)):
        n5 = stencil.MULTI_LAUNCHES
        got = P.stencil_apply_multi(c, xs, topo)
        step = P.euler_step_multi(c, xs, dt, topo)
        assert stencil.MULTI_LAUNCHES == n5 + 2
        for m in range(nmembers):
            torch.testing.assert_close(got[m], P.stencil_apply(c, xs[m], topo), rtol=0, atol=0)
            torch.testing.assert_close(step[m], P.euler_step(c, xs[m], dt, topo), rtol=0, atol=0)
        torch.testing.assert_close(got, P.apply_stencil(c, xs, topo), rtol=0, atol=0)
    prop = P.euler_propagate_multi(T.to(ctype), xs, dt, 3, topo)
    for m in range(nmembers):
        torch.testing.assert_close(prop[m], P.euler_propagate(T.to(ctype), xs[m], dt, 3, topo),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_k2_equals_per_member(case, dtype):
    _, _, idx, T, chi = case
    surf = torch.zeros_like(chi)
    surf[0] = 1.0
    shifted = (T.diag + torch.where(idx.wet3d, surf, 0.0)).to(dtype)
    legs = (T.bottom.to(dtype), torch.where(shifted != 0, shifted, 1.0), T.top.to(dtype))
    rng = np.random.default_rng(8)
    bs = torch.as_tensor(rng.standard_normal((4,) + chi.shape), device=chi.device).to(dtype)
    n2 = tridiag.LAUNCHES
    got = P.tridiag_solve(*legs, bs)
    assert tridiag.LAUNCHES == n2 + 1
    for m in range(4):
        torch.testing.assert_close(got[m], P.tridiag_solve(*legs, bs[m]), rtol=0, atol=0)
    torch.testing.assert_close(got, tridiag_solve_plain(*legs, bs), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,algorithm,tol", [(torch.float64, "bicgstab", 1e-12),
                                                 (torch.float64, "bicgstab2", 1e-12),
                                                 (torch.float32, "bicgstab", 1e-4),
                                                 (torch.float32, "bicgstab2", 1e-4)])
def test_water_mass_fractions_go_through_k5_and_k2(case, dtype, algorithm, tol):
    """The fractions launch K5 and the batched K2 and no K1, and meet tol;
    their sum solves the all-surface dye system to sqrt(R) tol (the bands'
    right-hand sides are disjoint), evaluated in f64, plus the f32 floor.
    Only a tight f64 solve resolves the interior (the residual is dominated
    by the surface restoring rows), so only that one is held to [0, 1]."""
    _, gm, idx, T, _ = case
    ny, nx = gm.shape[1:]
    nbands = 3
    masks = np.zeros((nbands, ny, nx), bool)
    for r in range(nbands):
        masks[r, r * ny // nbands:(r + 1) * ny // nbands] = True
    c = T.to(dtype)
    n1, n5, n2 = stencil.LAUNCHES, stencil.MULTI_LAUNCHES, tridiag.LAUNCHES
    fr, res = P.water_mass_fractions(c, idx.wet3d, gm.topology, masks, tol=tol,
                                     algorithm=algorithm)
    assert stencil.MULTI_LAUNCHES > n5 and tridiag.LAUNCHES > n2 and stencil.LAUNCHES == n1
    assert res.shape == (nbands,) and float(res.max()) <= tol
    wet = idx.wet3d
    assert bool(torch.isfinite(fr[:, wet]).all()) and bool(torch.isnan(fr[:, ~wet]).all())
    surf = torch.zeros(wet.shape, dtype=torch.float64, device=wet.device)
    surf[0] = 1.0
    surf = torch.where(wet, surf, 0.0)
    total = torch.where(wet, fr.sum(0), 0.0).double()
    defect = P.stencil_apply(c, total, gm.topology) + surf * total - surf
    floor = 1e-5 if dtype == torch.float32 else 0.0
    assert float(defect.norm() / surf.norm()) <= nbands ** 0.5 * tol + floor
    if dtype == torch.float64:
        frv = fr[:, wet]
        assert float(frv.min()) > -1e-3 and float(frv.max()) < 1.0 + 1e-3


def test_k5_wrapper_raises_on_card(case):
    _, gm, _, T, chi = case
    topo = gm.topology
    xs = torch.stack([chi, chi])
    with pytest.raises(ValueError, match="B, "):
        P.stencil_apply_multi(T, chi, topo)
    with pytest.raises(ValueError, match="B, "):
        P.stencil_apply_multi(T, xs[:0], topo)
    with pytest.raises(ValueError, match="not contiguous"):
        P.stencil_apply_multi(T, xs.transpose(2, 3).contiguous().transpose(2, 3), topo)
    with pytest.raises(ValueError, match="on cpu"):
        P.euler_step_multi(T._replace(top=T.top.cpu()), xs, 1.0, topo)
    with pytest.raises(ValueError, match="expected"):
        P.stencil_apply(T, xs, topo)


def _redi(case):
    """The Redi operator of a TEOS-10 density on the case's grid, as the
    density path builds it (f64)."""
    _, gm, idx, _, _ = case
    wet = idx.wet3d
    so = torch.where(wet, 35.0 + 0.3 * torch.cos(torch.deg2rad(gm.lat))
                     * torch.sin(torch.deg2rad(gm.lon)), torch.nan)
    ct = torch.where(wet, 20.0 - 0.004 * gm.z3d - 6.0 * torch.sin(torch.deg2rad(gm.lat)) ** 2,
                     torch.nan)
    rho = torch.where(wet, P.rho_teos10(so, ct, gm.z3d), torch.nan)
    return P.build_redi_operator(rho, gm, wet)


REDI_TYPES = {"f64,f64": (torch.float64, torch.float64), "f32,f32": (torch.float32, torch.float32),
              "bf16,f32": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("types", list(REDI_TYPES))
def test_k6_equals_plain(case, types):
    """K6 runs the plain version's operations in its order without FMA:
    equal bit for bit, NaN on land included (chi is masked by wet)."""
    _, _, idx, _, chi = case
    ctype, vtype = REDI_TYPES[types]
    op = _redi(case).to(ctype)
    x = torch.where(idx.wet3d, chi, torch.nan).to(vtype)
    n6 = redi_kernel.LAUNCHES
    got = P.redi_apply_fused(op, x)
    assert redi_kernel.LAUNCHES == n6 + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, P.redi_apply(op, x), rtol=0, atol=0)


@pytest.mark.parametrize("nmembers", [1, 3, 8])
@pytest.mark.parametrize("types", list(REDI_TYPES))
def test_k6_multi_equals_k6_per_member(case, types, nmembers):
    _, _, idx, _, chi = case
    ctype, vtype = REDI_TYPES[types]
    op = _redi(case).to(ctype)
    rng = np.random.default_rng(9)
    xs = torch.where(idx.wet3d, torch.as_tensor(rng.standard_normal((nmembers,) + chi.shape),
                                                device=chi.device), 0.0).to(vtype)
    n6 = redi_kernel.MULTI_LAUNCHES
    got = P.redi_apply_fused_multi(op, xs)
    assert redi_kernel.MULTI_LAUNCHES == n6 + 1
    for m in range(nmembers):
        torch.testing.assert_close(got[m], P.redi_apply_fused(op, xs[m]), rtol=0, atol=0)
    torch.testing.assert_close(got, P.redi_apply(op, xs), rtol=0, atol=0)


def test_k6_invariants(case):
    """Conservation of the volume integral and constants in the null space,
    through the kernel in f64."""
    _, gm, idx, _, chi = case
    op = _redi(case)
    wet = idx.wet3d
    v = torch.where(wet, gm.v3d, 0.0)
    tend = P.redi_apply_fused(op, chi)
    assert abs(float((tend * v).sum())) < 1e-12 * float((tend * v).abs().sum())
    assert float(P.redi_apply_fused(op, torch.where(wet, 7.5, 0.0).double()).abs().max()) < 1e-12


def test_k6_wrapper_raises_on_card(case):
    _, _, _, _, chi = case
    op = _redi(case)
    with pytest.raises(ValueError, match="not contiguous"):
        P.redi_apply_fused(op, chi.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="on cpu"):
        P.redi_apply_fused(dataclasses.replace(op, g_t=op.g_t.cpu()), chi)
    with pytest.raises(TypeError, match="no kernel"):
        P.redi_apply_fused(op, chi.float())
    with pytest.raises(ValueError, match="B, "):
        P.redi_apply_fused_multi(op, chi)
