"""otmb_tpu_torch's CUDA kernels against their plain PyTorch versions (and
K11/K12, the BiCGStab(2) cycle's algebra, against theirs in every mode;
K5 against K1, member by member; K7, K8 and K9 on shards against K1/K5, K4
and K6 on the whole field), on the card. Every test here needs an
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
from otmb_tpu_torch.ops import krylov, krylov_algebra, stencil, tridiag
from otmb_tpu_torch.ops.krylov import fused_krylov_step_plain
from otmb_tpu_torch.ops.coeffs import StencilCoeffs
from otmb_tpu_torch.ops.tridiag import tridiag_solve_plain
from otmb_tpu_torch.ops import assemble
from otmb_tpu_torch.parallel import assemble_halo, halo, halo_kernel, redi_halo
from otmb_tpu_torch.parallel.halo import _local_stencil
from otmb_tpu_torch.parallel.mesh import ProcessGrid
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


@pytest.mark.parametrize("nmembers", [0, 1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nz", [1, 2, 50, 75])
def test_k2_cut_shapes_equal_plain(device, nz, dtype, nmembers):
    """The factor and the solve at nz up to 75, on 7 x 45 columns (not a
    multiple of the solve's 64-column block), one field (nmembers 0) or a
    batch, with a zero pivot guarded: bit for bit against the plain
    versions, and every member against its own solve."""
    rng = np.random.default_rng(nz + 10 * nmembers)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape), device=device).to(dtype)
    lower, upper = t(nz, 7, 45), t(nz, 7, 45)
    diag = 4.0 + t(nz, 7, 45).abs()
    diag[:, 0, 0], upper[:, 0, 0] = 0.0, 0.0
    b = t(*(((nmembers,) if nmembers else ()) + (nz, 7, 45)))
    n2 = tridiag.LAUNCHES
    cp, rden = P.tridiag_factor(lower, diag, upper)
    x = P.tridiag_solve_factored(cp, rden, upper, b)
    assert tridiag.LAUNCHES == n2 + 2
    pcp, prden = tridiag.tridiag_factor_plain(lower, diag, upper)
    torch.testing.assert_close(cp, pcp, rtol=0, atol=0)
    torch.testing.assert_close(rden, prden, rtol=0, atol=0)
    torch.testing.assert_close(x, tridiag_solve_plain(lower, diag, upper, b), rtol=0, atol=0)
    for m in range(nmembers):
        torch.testing.assert_close(x[m], P.tridiag_solve_factored(cp, rden, upper, b[m]),
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


def test_bf16_refined_ideal_age_runs_in_f32(case):
    """bf16 coefficients: K1's (bf16, f32) matvecs and K2 on f32 legs, f64
    defects; the age agrees with the f32 one to the bf16 rounding."""
    ds, gm, idx, _, _ = case
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm).to(torch.float32)
    wet = idx.wet3d
    age32, _ = P.ideal_age(T, wet, gm.topology, tol=1e-9, refine=True)
    k1, k2 = stencil.LAUNCHES, tridiag.LAUNCHES
    gamma, res = P.ideal_age(T.to(torch.bfloat16), wet, gm.topology, tol=1e-9, refine=True)
    assert res < 1e-9 and bool(torch.isfinite(gamma[wet]).all())
    assert stencil.LAUNCHES > k1 and tridiag.LAUNCHES > k2
    assert float((gamma[wet] / age32[wet]).mean()) == pytest.approx(1.0, abs=1e-2)


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
    cp, rden = tridiag.tridiag_factor_plain(*m)
    torch.testing.assert_close(got.cp, cp, rtol=0, atol=0)
    torch.testing.assert_close(got.rden, rden, rtol=0, atol=0)
    shared = P.tridiag_factor(*m)  # K3 on K2's factor: the same tensors
    assert krylov.krylov_scratch(*m, factor=shared).cp is shared[0]
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
    assert tridiag.LAUNCHES == n2 + 2  # the factor, then one solve for the batch
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


TYPES = {"f64,f64": (torch.float64, torch.float64), "f32,f64": (torch.float32, torch.float64),
         "f32,f32": (torch.float32, torch.float32), "bf16,f32": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
@pytest.mark.parametrize("types", list(TYPES))
@pytest.mark.parametrize("dims", [(1, 13, 37), (3, 13, 180), (13, 9, 45), (50, 16, 64),
                                  (2, 1080, 1440)])
def test_k5_cut_shapes_equal_k1_per_member(device, kind, types, dims):
    """K5's k-marching 32 x 8 tiles on shapes that cut them on every side:
    nx of 37, 45 and 180, ny of 13 and 9 (a tile straddles the tripolar
    fold or the bipolar north edge), fewer levels than a chunk (nz = 1, 3)
    and walks split into uneven chunks (13, 50), at B = 1, 3, 5, 8 and 9
    (groups of 1, 4, 8, and 8 with a remainder of 1; one member takes K1's
    kernel where its planes fit in the L2, and the walk on the 0.25-degree
    plane). Apply and Euler step on T and T', random legs: each member
    equals K1 bit for bit."""
    from otmb_tpu_torch.grid.topology import GridTopology

    ctype, vtype = TYPES[types]
    nz, ny, nx = dims
    topo = GridTopology(kind=kind, nx=nx, ny=ny, nz=nz)
    rng = np.random.default_rng(nz + ny + nx)
    legs = StencilCoeffs(*(torch.as_tensor(rng.standard_normal((nz, ny, nx)), device=device)
                           for _ in StencilCoeffs._fields))
    dt = 0.125
    for nb in (1, 3, 5, 8, 9):
        xs = torch.as_tensor(rng.standard_normal((nb, nz, ny, nx)), device=device).to(vtype)
        for c in (legs.to(ctype), P.transpose_coeffs(legs, topo).to(ctype)):
            n5 = stencil.MULTI_LAUNCHES
            got = P.stencil_apply_multi(c, xs, topo)
            step = P.euler_step_multi(c, xs, dt, topo)
            assert stencil.MULTI_LAUNCHES == n5 + 2
            for m in range(nb):
                torch.testing.assert_close(got[m], P.stencil_apply(c, xs[m], topo), rtol=0,
                                           atol=0, msg=f"apply, B = {nb}, member {m}")
                torch.testing.assert_close(step[m], P.euler_step(c, xs[m], dt, topo), rtol=0,
                                           atol=0, msg=f"step, B = {nb}, member {m}")

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


def _random_redi(kind, nz, ny, nx, device, seed):
    """A RediOperator of random coefficient fields and a random wet mask:
    the kernel's arithmetic on any shape, physical or not."""
    from otmb_tpu_torch.grid.topology import GridTopology
    from otmb_tpu_torch.models.redi import _COEF_FIELDS, RediOperator

    rng = np.random.default_rng(seed)
    shape = lambda n: (ny, nx) if n in ("inv_de", "inv_dn") else (nz, ny, nx)
    f = {n: torch.as_tensor(rng.standard_normal(shape(n)), device=device) for n in _COEF_FIELDS}
    return RediOperator(**f, wet=torch.as_tensor(rng.random((nz, ny, nx)) < 0.8, device=device),
                        topology=GridTopology(kind=kind, nx=nx, ny=ny, nz=nz))


@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
@pytest.mark.parametrize("types", list(REDI_TYPES))
@pytest.mark.parametrize("dims", [(1, 1, 33), (2, 1, 37), (2, 9, 45), (1, 17, 70), (3, 11, 5),
                                  (13, 9, 45)])
def test_k6_cut_shapes_equal_plain(device, kind, types, dims):
    """K6 on shapes that cut its 32 x 8 tile on every side (ny = 1, nz of 1
    and 2, i wrapping inside one tile) and its walk into uneven chunks of
    levels (nz = 13), one tracer and B = 1, 4 and 8: bit for bit against
    the plain version, NaN on land masked."""
    ctype, vtype = REDI_TYPES[types]
    nz, ny, nx = dims
    op = _random_redi(kind, nz, ny, nx, device, seed=nz + ny + nx).to(ctype)
    rng = np.random.default_rng(nx)
    for nb in (0, 1, 4, 8):
        x = torch.as_tensor(rng.standard_normal(((nb,) if nb else ()) + (nz, ny, nx)),
                            device=device).to(vtype)
        x = torch.where(op.wet, x, torch.nan)
        got = P.redi_apply_fused_multi(op, x) if nb else P.redi_apply_fused(op, x)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, P.redi_apply(op, x), rtol=0, atol=0)


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


# ----------------------------------------------------------------------------
# K7, K8 and K9 on shards, in one process: each shard's halo lines are cut
# from the whole field (no exchange), so these test the kernels without the
# transport (tests/test_torch_parallel.py tests the exchange on the CPU).

SHARD_SHAPES = [(2, 2), (1, 4), (1, 3), (2, 1)]
SIDES = ("east", "west", "north", "south")


def _shards(shape, device, ny, nx):
    """Each rank's ProcessGrid and a slicer of (..., ny, nx) fields."""
    for rank in range(shape[0] * shape[1]):
        g = ProcessGrid(shape, rank, device, "gloo")
        (j0, i0), (ny_l, nx_l) = g.offset(ny, nx), g.local_shape(ny, nx)
        yield g, lambda f, j0=j0, i0=i0, a=ny_l, b=nx_l: f[..., j0:j0 + a, i0:i0 + b].contiguous()


def _cut(f, g, topo, side):
    """The line of (..., ny, nx) field `f` beyond shard `g`'s `side`: the
    neighbours' values, periodic in x, the i-reversed top row across the
    tripolar fold, zeros where the grid ends."""
    ny, nx = topo.ny, topo.nx
    (j0, i0), (ny_l, nx_l) = g.offset(ny, nx), g.local_shape(ny, nx)
    j1, i1 = j0 + ny_l, i0 + nx_l
    if side == "east":
        return f[..., j0:j1, i1 % nx].contiguous()
    if side == "west":
        return f[..., j0:j1, (i0 - 1) % nx].contiguous()
    if side == "south":
        return f[..., j0 - 1, i0:i1].contiguous() if j0 > 0 else torch.zeros_like(f[..., 0, i0:i1])
    if j1 < ny:
        return f[..., j1, i0:i1].contiguous()
    if topo.is_tripolar:
        return torch.flip(f[..., ny - 1, nx - i1:nx - i0], dims=(-1,)).contiguous()
    return torch.zeros_like(f[..., 0, i0:i1])


@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("types", ["f64,f64", "f32,f64", "f32,f32", "bf16,f32"])
def test_k7_equals_k1_and_k5_on_each_shard(case, types, shape):
    """K7 on each shard, apply and Euler step, one tracer and a batch of 3,
    equals K1 and K5 on the whole field, and its plain version, bit for bit."""
    _, gm, idx, T, chi = case
    ctype, vtype = ({"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[t]
                    for t in types.split(","))
    topo = gm.topology
    dt = 0.25 / float(T.diag.abs().max())
    x = chi.to(vtype)
    xs = torch.stack([x, 2 * x, -x])
    for c in (T.to(ctype), P.transpose_coeffs(T, topo).to(ctype)):
        whole = {"apply": P.stencil_apply(c, x, topo), "step": P.euler_step(c, x, dt, topo),
                 "multi": P.stencil_apply_multi(c, xs, topo),
                 "multi_step": P.euler_step_multi(c, xs, dt, topo)}
        for g, sl in _shards(shape, chi.device, topo.ny, topo.nx):
            c_l = StencilCoeffs(*(sl(leg) for leg in c))
            h = tuple(_cut(x, g, topo, s) for s in SIDES)
            hb = tuple(_cut(xs, g, topo, s) for s in SIDES)
            n7, n7m = halo_kernel.LAUNCHES, halo_kernel.MULTI_LAUNCHES
            got = {"apply": halo_kernel.local_apply(c_l, sl(x), h),
                   "step": halo_kernel.local_apply(c_l, sl(x), h, dt),
                   "multi": halo_kernel.local_apply(c_l, sl(xs), hb),
                   "multi_step": halo_kernel.local_apply(c_l, sl(xs), hb, dt)}
            assert (halo_kernel.LAUNCHES, halo_kernel.MULTI_LAUNCHES) == (n7 + 2, n7m + 2)
            for name, y in got.items():
                torch.testing.assert_close(y, sl(whole[name]), rtol=0, atol=0, msg=name)
            torch.testing.assert_close(got["apply"], _local_stencil(c_l, sl(x), h), rtol=0,
                                       atol=0)
            torch.testing.assert_close(got["multi"], _local_stencil(c_l, sl(xs), hb), rtol=0,
                                       atol=0)


@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("types", ["f64,f64", "f32,f64", "f32,f32", "bf16,f32"])
def test_k7_pack_and_edge_equal_plain_on_each_shard(case, types, shape):
    """K7's pack and edge entries on each shard, one tracer and a batch of
    3, apply and Euler step, equal their plain versions bit for bit; the
    bulk on null halos equals K7 on zero lines, so bulk plus edge is the
    overlap mode of `_boundary_patch` on the lines the exchange delivers."""
    _, gm, _, T, chi = case
    ctype, vtype = ({"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[t]
                    for t in types.split(","))
    topo = gm.topology
    dt = 0.25 / float(T.diag.abs().max())
    x = chi.to(vtype)
    xs = torch.stack([x, 2 * x, -x])
    c = T.to(ctype)
    for g, sl in _shards(shape, chi.device, topo.ny, topo.nx):
        c_l = StencilCoeffs(*(sl(leg) for leg in c))
        for whole in (x, xs):
            x_l = sl(whole)
            lines = tuple(_cut(whole, g, topo, s) for s in SIDES)
            plan, plain = halo.HaloExchange(x_l, topo, g), halo.HaloExchange(x_l, topo, g)
            n_pack, n_edge = halo_kernel.PACK_LAUNCHES, halo_kernel.EDGE_LAUNCHES
            halo_kernel._pack(plan, x_l, topo)
            halo._pack_plain(x_l, topo, plain.lines)
            torch.testing.assert_close(plan.send, plain.send, rtol=0, atol=0)
            for h, line in zip(plan.halos, lines):  # land the lines, as the messages would
                if h is not None:
                    h.copy_(line)
            for step in (None, dt):
                bulk = halo_kernel._bulk(c_l, x_l, halo_kernel._NO_HALOS, step)
                zeros = tuple(torch.zeros_like(line) for line in lines)
                torch.testing.assert_close(bulk, halo_kernel.local_apply(c_l, x_l, zeros, step),
                                           rtol=0, atol=0)
                scale = 1.0 if step is None else -step
                got = halo_kernel._edge(c_l, bulk.clone(), plan.halos, scale)
                want = halo._boundary_patch(c_l, bulk.clone(), plan.halos, scale)
                torch.testing.assert_close(got, want, rtol=0, atol=0)
                delivered = tuple(z if h is None else h for h, z in zip(plan.halos, zeros))
                torch.testing.assert_close(got, halo._boundary_patch(c_l, bulk.clone(), delivered,
                                                                     scale), rtol=0, atol=0)
            assert (halo_kernel.PACK_LAUNCHES, halo_kernel.EDGE_LAUNCHES) == (n_pack + 1,
                                                                            n_edge + 2)


@pytest.mark.parametrize("nmembers", [3, 8])
@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("types", list(TYPES))
def test_k7_multi_equals_k5_on_each_shard(case, types, shape, nmembers):
    """K7 multi on each shard (shards of 14 to 36 columns and 9 to 28 rows:
    one or two ragged tiles each way), apply and Euler step on T and T',
    B = 3 and 8. With the lines the exchange delivers it equals K5 on the
    whole field bit for bit. On null lines (the overlapped step's bulk) it
    equals the plain version on zero lines, and the edge entry then adds the
    halo terms as the plain `_boundary_patch` does, leaving the cells with
    no halo term equal to K5."""
    _, gm, _, T, chi = case
    ctype, vtype = TYPES[types]
    topo = gm.topology
    dt = 0.25 / float(T.diag.abs().max())
    rng = np.random.default_rng(nmembers)
    xs = torch.as_tensor(rng.standard_normal((nmembers,) + gm.shape), device=chi.device).to(vtype)
    inner = (slice(None), slice(None), slice(1, -1), slice(1, -1))
    for c in (T.to(ctype), P.transpose_coeffs(T, topo).to(ctype)):
        whole = {None: P.stencil_apply_multi(c, xs, topo), dt: P.euler_step_multi(c, xs, dt, topo)}
        for g, sl in _shards(shape, chi.device, topo.ny, topo.nx):
            c_l, x_l = StencilCoeffs(*(sl(leg) for leg in c)), sl(xs)
            lines = tuple(_cut(xs, g, topo, s) for s in SIDES)
            for step, want in whole.items():
                n7m = halo_kernel.MULTI_LAUNCHES
                got = halo_kernel.local_apply(c_l, x_l, lines, step)
                torch.testing.assert_close(got, sl(want), rtol=0, atol=0)
                bulk = halo_kernel._bulk(c_l, x_l, halo_kernel._NO_HALOS, step)
                assert halo_kernel.MULTI_LAUNCHES == n7m + 2
                y = _local_stencil(c_l, x_l, halo_kernel._NO_HALOS)
                torch.testing.assert_close(bulk, y if step is None else x_l - step * y, rtol=0,
                                           atol=0)
                scale = 1.0 if step is None else -step
                patched = halo_kernel._edge(c_l, bulk.clone(), lines, scale)
                torch.testing.assert_close(
                    patched, halo._boundary_patch(c_l, bulk.clone(), lines, scale), rtol=0, atol=0)
                torch.testing.assert_close(patched[inner], sl(want)[inner], rtol=0, atol=0)

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_prep_equals_plain(case, dtype):
    """The prep entry equals `_residents` and `_levels` bit for bit."""
    ds = case[0]
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, dtype=dtype, device=case[1].v3d.device)
    ml = torch.as_tensor(ds.mlotst, dtype=dtype, device=gm.v3d.device)
    kappas = (P.KAPPA_H_DEFAULT, P.KAPPA_VML_DEFAULT, P.KAPPA_VDEEP_DEFAULT)
    n = assemble.PREP_LAUNCHES
    res, lev = assemble._prep(gm, ml, *kappas)
    assert assemble.PREP_LAUNCHES == n + 1
    torch.testing.assert_close(res, assemble._residents(gm, ml, kappas[0]), rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(lev, assemble._levels(gm.zt, *kappas[1:]), rtol=0, atol=0)


def test_overlapped_step_launches_three_kernels(case):
    """One overlapped `stencil_apply_halo` step is three kernels on the card
    (pack, bulk, edge; counted by the wrappers and by torch.profiler) and,
    on one rank, no copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, gm, _, T, chi = case
    topo = gm.topology
    grid = ProcessGrid((1, 1), 0, chi.device, "gloo")
    x = chi.float()
    c = T.to(torch.float32)
    want = P.stencil_apply(c, x, topo)
    halo_kernel.stencil_apply_halo(c, x, topo, grid, overlap=True)  # warm-up
    torch.cuda.synchronize()
    counts = (halo_kernel.PACK_LAUNCHES, halo_kernel.LAUNCHES, halo_kernel.EDGE_LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = halo_kernel.stencil_apply_halo(c, x, topo, grid, overlap=True)
        torch.cuda.synchronize()
    assert (halo_kernel.PACK_LAUNCHES, halo_kernel.LAUNCHES, halo_kernel.EDGE_LAUNCHES) == \
        tuple(n + 1 for n in counts)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e.name for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    assert len(kernels) == 3, kernels
    assert not [e for e in events if e.name.startswith("Memcpy")]
    assert _rel(y, want) <= 1e-6


def _k8_shard(ds, gm, g, sl, topo, rho, upwind):
    """Shard `g`'s K8 inputs with lines cut from the whole field (the lines
    of parallel/assemble_halo.py:_lines: v3d, the transport, rho; 1/area and
    the neighbour's edge)."""
    from otmb_tpu_torch.ops.assemble import _levels, _residents

    dev, dtype = gm.v3d.device, gm.v3d.dtype
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    umo, vmo, ml = t(ds.umo), t(ds.vmo), t(ds.mlotst)
    res = _residents(gm, ml, P.KAPPA_H_DEFAULT)
    rho_c = None if rho is None else torch.where(torch.isnan(rho), 1.0, rho)
    cut = lambda f, side: _cut(f, g, topo, side)
    (j0, _), (ny_l, _) = g.offset(topo.ny, topo.nx), g.local_shape(topo.ny, topo.nx)
    top = j0 + ny_l == topo.ny
    flux = {"east": umo, "west": umo, "north": vmo, "south": vmo}
    # the neighbour's edge in its face area (rows E, W, N, S of the
    # residents): its west, east, south (across the fold: north), north edge
    edge = {"east": res[1], "west": res[0], "north": res[2] if top else res[3],
            "south": res[2]}
    level = {s: torch.stack([cut(gm.v3d, s), cut(flux[s], s)]
                            + ([] if rho_c is None else [cut(rho_c, s)])) for s in SIDES}
    static = {s: torch.stack([cut(res[9], s), cut(edge[s], s)]) for s in SIDES}
    return assemble_halo._Shard(
        sl(umo), sl(vmo), sl(gm.v3d), None if rho_c is None else sl(rho_c), sl(res),
        _levels(gm.zt, P.KAPPA_VML_DEFAULT, P.KAPPA_VDEEP_DEFAULT),
        (tuple(level[s] for s in SIDES), tuple(static[s] for s in SIDES)), j0 > 0, not top,
        topo.is_tripolar, upwind, 0.0 if rho is not None else 1.0 / 1035.0)


@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("variant", ["upwind", "centered", "rho3d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k8_equals_k4_on_each_shard(case, variant, dtype, shape):
    """K8 on each shard equals K4 on the whole field, and its plain version,
    bit for bit."""
    ds, gm64, _, _, _ = case
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, dtype=dtype, device=gm64.v3d.device)
    topo = gm.topology
    upwind = variant != "centered"
    rho = None
    if variant == "rho3d":
        rng = np.random.default_rng(5)
        rho = torch.as_tensor(np.where(ds.wet3d, 1025.0 + 20.0 * rng.random(ds.umo.shape),
                                       np.nan), dtype=dtype, device=gm.v3d.device)
    whole = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm, rho=1035.0 if rho is None else rho,
                         upwind=upwind)
    for g, sl in _shards(shape, gm.v3d.device, topo.ny, topo.nx):
        a = _k8_shard(ds, gm, g, sl, topo, rho, upwind)
        n8 = assemble_halo.LAUNCHES
        got = assemble_halo._launch(a)
        assert assemble_halo.LAUNCHES == n8 + 1
        plain = assemble_halo._assemble_plain(*a)
        for leg in got._fields:
            torch.testing.assert_close(got[leg], sl(whole[leg]), rtol=0, atol=0, msg=leg)
            torch.testing.assert_close(got[leg], plain[leg], rtol=0, atol=0, msg=leg)


@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("types", list(REDI_TYPES))
def test_k9_equals_k6_on_each_shard(case, types, shape):
    """K9 on each shard (NaN on land) equals K6 on the whole field, and its
    plain version, bit for bit."""
    _, gm, idx, _, chi = case
    ctype, vtype = REDI_TYPES[types]
    op = _redi(case).to(ctype)
    topo = gm.topology
    x = torch.where(idx.wet3d, chi, torch.nan).to(vtype)
    whole = P.redi_apply_fused(op, x)
    for g, sl in _shards(shape, chi.device, topo.ny, topo.nx):
        cut = lambda f, side: _cut(f, g, topo, side)
        fields = lambda names, side: torch.stack([cut(getattr(op, n), side) for n in names])
        dz = ("cz_u", "cz_d")
        (j0, _), (ny_l, _) = g.offset(topo.ny, topo.nx), g.local_shape(topo.ny, topo.nx)
        op_l = dataclasses.replace(op, wet=sl(op.wet), **{n: sl(getattr(op, n))
                                                          for n in redi_halo._COEF_FIELDS})
        rs = redi_halo.RediShard(
            op_l, (fields(dz, "east"), fields(dz + ("ae", "s_e"), "west"), fields(dz, "north"),
                   fields(dz + ("an", "s_n"), "south")),
            (cut(op.inv_de, "west"), cut(op.inv_dn, "south")),
            tuple(cut(op.wet, s) for s in SIDES), j0 > 0,
            j0 + ny_l < topo.ny or topo.is_tripolar)
        h = tuple(cut(x, s) for s in SIDES)
        n9 = redi_halo.LAUNCHES
        got = redi_halo._launch(rs, sl(x), h)
        assert redi_halo.LAUNCHES == n9 + 1
        torch.testing.assert_close(got, sl(whole), rtol=0, atol=0)
        torch.testing.assert_close(got, redi_halo._redi_plain(rs, sl(x), h), rtol=0, atol=0)


# --- the autodiff layer, GMRES and the native labeller on the card ------------------


def _ad_grads(loss, T, chi):
    c = P.StencilCoeffs(*(leg.clone().requires_grad_(True) for leg in T))
    x = chi.clone().requires_grad_(True)
    loss(c, x).backward()
    return [leg.grad for leg in c], x.grad


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("op", ["apply", "euler chain"])
def test_autodiff_functions_equal_plain_autograd(case, dtype, tol, op):
    """apply_stencil_ad and a 3-step euler_step_ad chain (K1 forward and
    backward) against torch's autograd through the plain apply, for chi and
    all seven legs, within tol of each gradient's largest value."""
    _, gm, idx, T, chi = case
    topo, T, chi = gm.topology, T.to(dtype), chi.to(dtype)
    w = torch.where(idx.wet3d, torch.cos(chi), 0.0)
    dt = 0.25 / float(T.diag.abs().max())
    if op == "apply":
        ad = lambda c, x: P.apply_stencil_ad(c, x, topo)
        plain = lambda c, x: P.apply_stencil(c, x, topo)
    else:
        def chain(step):
            def run(c, x):
                for _ in range(3):
                    x = step(c, x)
                return x
            return run
        ad = chain(lambda c, x: P.euler_step_ad(c, x, dt, topo))
        plain = chain(lambda c, x: x - dt * P.apply_stencil(c, x, topo))
    gc, gx = _ad_grads(lambda c, x: (w * ad(c, x) ** 2).sum(), T, chi)
    rc, rx = _ad_grads(lambda c, x: (w * plain(c, x) ** 2).sum(), T, chi)
    assert _rel(gx, rx) <= tol
    for leg, a, b in zip(T._fields, gc, rc):
        assert a.dtype == dtype and _rel(a, b) <= tol, leg


@pytest.mark.parametrize("op", ["apply", "euler"])
def test_autodiff_backward_runs_k1_on_the_transposed_legs(case, monkeypatch, op):
    """One K1 launch per forward and one per backward (the chi cotangent on
    T'), and no plain stencil anywhere."""
    _, gm, _, T, chi = case
    topo = gm.topology

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain stencil ran on the card")

    monkeypatch.setattr(stencil, "_plain", no_plain)
    monkeypatch.setattr(stencil, "apply_stencil", no_plain)
    x = chi.clone().requires_grad_(True)
    n0 = stencil.LAUNCHES
    y = (P.apply_stencil_ad(T, x, topo) if op == "apply"
         else P.euler_step_ad(T, x, 100.0, topo))
    assert stencil.LAUNCHES == n0 + 1
    y.sum().backward()
    assert stencil.LAUNCHES == n0 + 2
    tc = P.transpose_coeffs(T, topo)
    ones = torch.ones_like(chi)
    want = (P.stencil_apply(tc, ones, topo) if op == "apply"
            else P.euler_step(tc, ones, 100.0, topo))
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def box(device):
    """The 1-degree grid's depth (50 levels) at a quarter of its width:
    90x75x50, tripolar, f64 T from the fused assembly (K4)."""
    ds = P.synthetic_dataset(nx=90, ny=75, nz=50, topology="tripolar", seed=0)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device=device)
    idx = P.makeindices(gm.v3d)
    return gm, idx, P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)


@pytest.mark.parametrize("workload", ["ideal_age", "sequestration_time"])
def test_gmres_runs_on_k1_and_k2_and_matches_bicgstab(box, workload):
    gm, idx, T = box
    wet = idx.wet3d
    ref, res_b = getattr(P, workload)(T, wet, gm.topology, tol=1e-10)
    n1, n2 = stencil.LAUNCHES, tridiag.LAUNCHES
    stats = {}
    out, res = getattr(P, workload)(T, wet, gm.topology, tol=1e-10, algorithm="gmres",
                                    stats=stats)
    assert res <= 1e-10 and res_b <= 1e-10 and stats["stop"] == "converged"
    assert stencil.LAUNCHES - n1 >= stats["iters"] and tridiag.LAUNCHES - n2 >= stats["iters"]
    assert bool(torch.isfinite(out[wet]).all()) and bool((out[wet] > 0).all())
    assert _rel(out[wet], ref[wet]) <= 1e-6


def test_refined_gmres_age_on_the_card(box):
    """The f32 refined age with GMRES inner solves (K1 + K2, f64 defects)
    reaches 1e-9, near the BiCGStab(2) one (K3)."""
    gm, idx, T = box
    wet, T32 = idx.wet3d, T.to(torch.float32)
    ref, _ = P.ideal_age(T32, wet, gm.topology, tol=1e-9, refine=True, algorithm="bicgstab2")
    out, res = P.ideal_age(T32, wet, gm.topology, tol=1e-9, refine=True, algorithm="gmres")
    assert res <= 1e-9
    assert _rel(out[wet], ref[wet]) <= 1e-6


def test_native_labeller_builds_into_the_build_dir(device):
    from otmb_tpu_torch import _build
    from otmb_tpu_torch.utils import coarsen

    coarsen.load_native()
    path = coarsen.native_library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()


#: K11/K12 shapes (nz, ny, nx): every nx of 37, 180, 1440, ny of 13, 1080
#: and nz of 1, 13, 75 at least once; none a multiple of the 1024-cell tile.
ALGEBRA_SHAPES = [(1, 13, 37), (13, 13, 180), (75, 13, 1440), (1, 1080, 1440),
                  (13, 1080, 180), (75, 1080, 37)]
#: The sums within 1e-12 of the f64 plain sums (f64 `torch.dot`s, whose
#: order differs from the kernel's fixed tree), relative to the sum of the
#: terms' magnitudes.
TOL_ALGEBRA_SUM = 1e-12


def _algebra_inputs(device, shape, members, dtype, nfields: int, seed: int):
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    fields = [torch.as_tensor(rng.standard_normal(lead + shape), device=device).to(dtype)
              for _ in range(nfields)]
    scalar = lambda: torch.as_tensor(rng.uniform(-1.0, 1.0, lead), device=device).to(dtype)
    return fields, scalar


def _check_sums(got, pairs, dtype):
    """`got` (..., k) against the f64 plain sums of `pairs`: within
    TOL_ALGEBRA_SUM; in f32 also equal to their rounding unless the f64
    value lies within that bound of a rounding tie."""
    want = torch.stack([krylov_algebra.dot64(a, b) for a, b in pairs], dim=-1)
    mag = torch.stack([krylov_algebra.dot64(a.abs(), b.abs()) for a, b in pairs], dim=-1)
    g = got.double()
    if dtype == torch.float64:
        assert bool(((g - want).abs() <= TOL_ALGEBRA_SUM * mag).all())
        return
    rounded = want.float().double()
    tie = ((g + rounded) / 2 - want).abs() <= TOL_ALGEBRA_SUM * mag
    assert bool(((g == rounded) | tie).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("members", [None, 1, 3, 8])
@pytest.mark.parametrize("shape", ALGEBRA_SHAPES)
def test_k11_equals_plain(device, shape, members, dtype):
    (r0, u1, r1, r2), scalar = _algebra_inputs(device, shape, members, dtype, 4, 21)
    alpha = scalar()
    n0 = krylov_algebra.SUMS_LAUNCHES
    got_r0, sums = krylov_algebra.polish_sums(r0, u1, r1, r2, alpha)
    assert krylov_algebra.SUMS_LAUNCHES == n0 + 1
    want_r0, _ = krylov_algebra.polish_sums_plain(r0, u1, r1, r2, alpha)
    torch.testing.assert_close(got_r0, want_r0, rtol=0, atol=0)
    assert sums.shape == r0.shape[:-3] + (krylov_algebra.NSUMS,) and sums.dtype == dtype
    _check_sums(sums, ((r1, r1), (r1, r2), (r2, r2), (want_r0, r1), (want_r0, r2)), dtype)


@pytest.mark.parametrize("with_dot", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("members", [None, 1, 3, 8])
@pytest.mark.parametrize("shape", ALGEBRA_SHAPES)
def test_k12_equals_plain(device, shape, members, dtype, with_dot):
    fields, scalar = _algebra_inputs(device, shape, members, dtype, 8, 22)
    y, u0, r0, r1, r2, u1, u2, rhat = fields
    alpha, w1, w2 = scalar(), scalar(), scalar()
    rhat = rhat if with_dot else None
    n0 = krylov_algebra.UPDATE_LAUNCHES
    got = krylov_algebra.polish_update(y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat)
    assert krylov_algebra.UPDATE_LAUNCHES == n0 + 1
    want = krylov_algebra.polish_update_plain(y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if with_dot:
        assert got[3].shape == r0.shape[:-3] and got[3].dtype == dtype
        _check_sums(got[3].unsqueeze(-1), ((rhat, want[1]),), dtype)
    else:
        assert got[3] is None


def test_k11_k12_sums_repeat(device):
    """The same inputs give the same sums, bit for bit, launch after launch."""
    (r0, u1, r1, r2), scalar = _algebra_inputs(device, (75, 1080, 37), 3, torch.float32, 4, 23)
    alpha = scalar()
    first = krylov_algebra.polish_sums(r0, u1, r1, r2, alpha)[1]
    for _ in range(3):
        torch.testing.assert_close(krylov_algebra.polish_sums(r0, u1, r1, r2, alpha)[1], first,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("members", [None, 4])
def test_bicgstab2_cycle_runs_k11_and_k12(case, members):
    """A BiCGStab(2) solve (a field on K3, a batch unfused on K5 + K2) ends
    every cycle in K11 and K12, and two solves give the same bits."""
    _, gm, idx, T, _ = case
    b = idx.wet3d.to(torch.float32)
    if members is not None:
        b = torch.stack([b * (m + 1) for m in range(members)])
    kw = dict(shift=1e-3, tol=1e-6, chunk=20, algorithm="bicgstab2", fused=members is None)
    n11, n12 = krylov_algebra.SUMS_LAUNCHES, krylov_algebra.UPDATE_LAUNCHES
    stats = {}
    x1, r1 = P.solve_shifted_chunked(T.to(torch.float32), b, gm.topology, stats=stats, **kw)
    cycles = stats["iters"] // 2
    assert krylov_algebra.SUMS_LAUNCHES - n11 == cycles
    assert krylov_algebra.UPDATE_LAUNCHES - n12 == cycles
    x2, r2 = P.solve_shifted_chunked(T.to(torch.float32), b, gm.topology, **kw)
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    assert (r1 == r2) if members is None else bool((r1 == r2).all())
