"""otmb_tpu_torch's CUDA kernels against their plain PyTorch versions (and
K11/K12, the BiCGStab(2) cycle's algebra, and K13, a BiCGStab(1)
iteration's, against theirs in every mode;
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
from otmb_tpu_torch import _build
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

#: Each kernel's C entry calls as `_build.calls` reads them.
K1, K2, K3, K4, K4_PREP, K5, K6, K6_MULTI, K7, K7_MULTI, K7_PACK, K7_EDGE, K8, K9, K10, K11, \
    K12, K13 = (_build.KERNELS[name] for name in (
        "K1", "K2", "K3", "K4", "K4 prep", "K5", "K6", "K6 multi", "K7", "K7 multi", "K7 pack",
        "K7 edge", "K8", "K9", "K10", "K11", "K12", "K13"))


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


#: torch.profiler now and then reports no CUDA event at all for a window:
#: 20 of 12,000 windows around one K3 launch on an H100, with or without 2 ms
#: of host time at each end (scripts/profiler_window.py). A window that
#: reports no event is taken again, at most PROFILE_TRIES times; the first
#: that reports any event is the one a test holds to its counts.
PROFILE_TRIES = 3


def _cuda_events(fn):
    """(fn(), the CUDA events torch.profiler records while `fn` runs and the
    device finishes, the number of windows taken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    return out, events, tries


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
    n2 = _build.calls(K2)
    cp, rden = P.tridiag_factor(lower, diag, upper)
    x = P.tridiag_solve_factored(cp, rden, upper, b)
    assert _build.calls(K2) == n2 + 2
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
    k1, k2 = _build.calls(K1), _build.calls(K2)
    gamma, res = P.ideal_age(T, idx.wet3d, gm.topology, tol=1e-9, refine=True)
    assert res < 1e-9
    assert bool(torch.isfinite(gamma[idx.wet3d]).all())
    assert _build.calls(K1) > k1 and _build.calls(K2) > k2


def test_bf16_refined_ideal_age_runs_in_f32(case):
    """bf16 coefficients: K1's (bf16, f32) matvecs and K2 on f32 legs, f64
    defects; the age agrees with the f32 one to the bf16 rounding."""
    ds, gm, idx, _, _ = case
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm).to(torch.float32)
    wet = idx.wet3d
    age32, _ = P.ideal_age(T, wet, gm.topology, tol=1e-9, refine=True)
    k1, k2 = _build.calls(K1), _build.calls(K2)
    gamma, res = P.ideal_age(T.to(torch.bfloat16), wet, gm.topology, tol=1e-9, refine=True)
    assert res < 1e-9 and bool(torch.isfinite(gamma[wet]).all())
    assert _build.calls(K1) > k1 and _build.calls(K2) > k2
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
    n0 = _build.calls(K3)
    z, out, d = P.fused_krylov_step(a, *m, x1, x2, c2, rhat, topo, scratch=scratch, **kw)
    assert _build.calls(K3) == n0 + 1
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


K3_FLAGS = [(True, True), (True, False), (False, True), (False, False)]


def _k3_random(device, kind, nz, ny, nx, dtype, seed):
    """Random legs on a (nz, ny, nx) grid with land columns (every leg 0,
    the diagonal too) and a partial column, the legs across missing
    neighbours left nonzero (both K3 and the composition read 0 there);
    x1, x2, rhat random."""
    rng = np.random.default_rng(seed)
    t = lambda scale=1.0: torch.as_tensor(scale * rng.standard_normal((nz, ny, nx)),
                                          device=device)
    wet = torch.ones((nz, ny, nx), dtype=torch.bool, device=device)
    wet[:, ny // 2, : nx // 3] = False
    wet[:, -1, -1] = False  # a land column in the fold row
    wet[nz // 2:, 1, 2] = False
    legs = {"diag": 3.0 + t().abs()}
    for leg in ("east", "west", "north", "south", "top", "bottom"):
        legs[leg] = t(0.3)
    a = StencilCoeffs(**{k: torch.where(wet, v, 0.0).to(dtype) for k, v in legs.items()})
    return P.GridTopology(kind, nx, ny, nz), a, t().to(dtype), t().to(dtype), t().to(dtype)


def _k3_check(a, m, x1, x2, rhat, topo, dtype, call):
    """Every combine/dot flag of `call` (the kernel on legs m) against the
    K2 + K1 composition: z and out exact, d within its bound and the same
    bits on a second call."""
    c2 = torch.tensor(-0.37, dtype=dtype, device=x1.device)
    for combine, dot in K3_FLAGS:
        z, out, d = call(x1, x2 if combine else None, c2, rhat if dot else None)
        want_z = x1 + c2 * x2 if combine else x1
        want_out = P.stencil_apply(a, P.tridiag_solve(*m, want_z), topo)
        torch.testing.assert_close(z, want_z, rtol=0, atol=0)
        torch.testing.assert_close(out, want_out, rtol=0, atol=0)
        if not dot:
            assert d is None
            continue
        ref = torch.dot(rhat.double().flatten(), want_out.double().flatten())
        scale = float((rhat.double() * want_out.double()).abs().sum())
        assert abs(float(d) - float(ref)) <= (1e-5 if dtype == torch.float32 else 1e-12) * scale
        assert torch.equal(d, call(x1, x2 if combine else None, c2, rhat)[2])


@pytest.mark.parametrize("path", ["a_legs", "other_legs"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
@pytest.mark.parametrize("nz", [1, 2, 50, 75])
def test_k3_cut_shapes_equal_composition(device, nz, kind, dtype, path):
    """K3 at nz up to 75 on 37 x 70 columns (not a multiple of any tile
    along i or of the strips along j), both topologies (the fold row
    solved by the top strip), land columns with diag 0, every flag: on
    A's own legs (the engine's M) and on other legs (an unguarded diagonal
    with zeros and legs unrelated to A)."""
    topo, a, x1, x2, rhat = _k3_random(device, kind, nz, 37, 70, dtype, seed=nz)
    if path == "a_legs":
        m = (a.bottom, torch.where(a.diag != 0, a.diag, 1.0), a.top)
    else:
        rng = np.random.default_rng(nz + 100)
        r = lambda: torch.as_tensor(rng.standard_normal((nz, 37, 70)), device=device).to(dtype)
        m = (0.2 * r(), 2.0 + r().abs(), 0.2 * r())
        m[1][:, 0, :5] = 0.0
    scratch = krylov.krylov_scratch(*m)
    n0 = _build.calls(K3)
    _k3_check(a, m, x1, x2, rhat, topo, dtype,
              lambda x1, x2, c2, rhat: P.fused_krylov_step(
                  a, *m, x1, x2, c2, rhat, topo, with_combine=x2 is not None,
                  with_dot=rhat is not None, scratch=scratch))
    assert _build.calls(K3) == n0 + 6


# (dtype, nz, ny, nx, state in device memory): the launcher's choices,
# reached through the shapes. 56-column tiles in strips of one row and of
# several rows; 30-column tiles where 56 columns' state would not fit in
# shared memory (f64 above nz = 96, f32 above nz = 200), up to their limit
# (f64 nz = 176, f32 nz = 360); past it the state in device memory.
K3_LAUNCH_SHAPES = [
    (torch.float32, 20, 23, 300, False),
    (torch.float32, 20, 200, 1500, False),
    (torch.float64, 96, 9, 70, False),
    (torch.float64, 120, 9, 70, False),
    (torch.float64, 176, 9, 70, False),
    (torch.float64, 177, 9, 70, True),
    (torch.float64, 177, 40, 1500, True),
    (torch.float32, 201, 9, 70, False),
    (torch.float32, 360, 5, 40, False),
    (torch.float32, 361, 5, 40, True),
]


@pytest.mark.parametrize("shape", K3_LAUNCH_SHAPES, ids=lambda s: "{}-{}x{}x{}".format(
    str(s[0]).replace("torch.", ""), *s[1:4]))
@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
def test_k3_tiles_and_strips_equal_composition(device, kind, shape):
    """The launcher's choices change no bit: every tile, strip and place of
    a block's state that the shapes of K3_LAUNCH_SHAPES lead it to, on A's
    own legs, every flag, against the composition; the kernel that ran
    keeps its state in device memory exactly where the shape says."""
    dtype, nz, ny, nx, spill = shape
    topo, a, x1, x2, rhat = _k3_random(device, kind, nz, ny, nx, dtype, seed=nz)
    m = (a.bottom, torch.where(a.diag != 0, a.diag, 1.0), a.top)
    scratch = krylov.krylov_scratch(*m)
    call = lambda x1, x2, c2, rhat: P.fused_krylov_step(
        a, *m, x1, x2, c2, rhat, topo, with_combine=x2 is not None, with_dot=rhat is not None,
        scratch=scratch)
    _k3_check(a, m, x1, x2, rhat, topo, dtype, call)
    _, events, _ = _cuda_events(lambda: call(x1, x2, 0.5, rhat))
    # krylov_kernel<T, kCombine, kDot, kSpill>
    names = [e.name for e in events if "krylov_kernel" in e.name]
    assert len(names) == 1, names
    assert names[0].split("<")[1].split(">")[0].split(",")[-1].strip() == str(spill).lower()


@pytest.mark.parametrize("dot", [True, False])
def test_k3_is_one_launch_per_call(case, dot):
    """One K3 kernel a call, and the finish kernel of the dot with it:
    nothing else runs on the card (torch.profiler)."""
    topo, a, m, x1, x2, rhat = _k3_inputs(case, torch.float32, False)
    c2 = torch.tensor(0.5, dtype=torch.float32, device=x1.device)
    scratch = krylov.krylov_scratch(*m)
    step = lambda: P.fused_krylov_step(a, *m, x1, x2, c2, rhat, topo, with_dot=dot,
                                       scratch=scratch)
    step()
    torch.cuda.synchronize()
    names = [e.name for e in _cuda_events(step)[1]]
    assert len(names) == (2 if dot else 1), names
    assert sum("krylov_kernel" in n for n in names) == 1
    assert sum("krylov_dot_finish" in n for n in names) == (1 if dot else 0)


def test_k10_equals_plain(device):
    thunk, nbytes = P.dma_peak_probe(nstreams=7, mbytes=8, device=device)
    assert nbytes == 8 * 8 * 1024 * 1024
    gen = torch.Generator(device=device).manual_seed(0)
    streams = [torch.randn((8, 512, 512), generator=gen, device=device) for _ in range(7)]
    n0 = _build.calls(K10)
    got = thunk()
    assert _build.calls(K10) == n0 + 1
    torch.testing.assert_close(got, profiling.probe_sum_plain(streams), rtol=0, atol=0)
    torch.testing.assert_close(profiling.probe_sum(streams[:3]),
                               profiling.probe_sum_plain(streams[:3]), rtol=0, atol=0)


@pytest.mark.parametrize("workload", ["ideal_age", "sequestration_time"])
def test_refined_bicgstab2_goes_through_k3(case, workload):
    ds, gm, idx, _, _ = case
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm).to(torch.float32)
    n3 = _build.calls(K3)
    stats = {}
    gamma, res = getattr(P, workload)(T, idx.wet3d, gm.topology, tol=1e-9, refine=True,
                                      algorithm="bicgstab2", stats=stats)
    assert res < 1e-9
    assert bool(torch.isfinite(gamma[idx.wet3d]).all())
    assert _build.calls(K3) > n3
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
        n5 = _build.calls(K5)
        got = P.stencil_apply_multi(c, xs, topo)
        step = P.euler_step_multi(c, xs, dt, topo)
        assert _build.calls(K5) == n5 + 2
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
    n2 = _build.calls(K2)
    got = P.tridiag_solve(*legs, bs)
    assert _build.calls(K2) == n2 + 2  # the factor, then one solve for the batch
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
    n1, n5, n2 = _build.calls(K1), _build.calls(K5), _build.calls(K2)
    fr, res = P.water_mass_fractions(c, idx.wet3d, gm.topology, masks, tol=tol,
                                     algorithm=algorithm)
    assert _build.calls(K5) > n5 and _build.calls(K2) > n2 and _build.calls(K1) == n1
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
            n5 = _build.calls(K5)
            got = P.stencil_apply_multi(c, xs, topo)
            step = P.euler_step_multi(c, xs, dt, topo)
            assert _build.calls(K5) == n5 + 2
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
    n6 = _build.calls(K6)
    got = P.redi_apply_fused(op, x)
    assert _build.calls(K6) == n6 + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, P.redi_apply(op, x), rtol=0, atol=0)


def _k6_group(nmembers: int, vtype: torch.dtype) -> int:
    """The member group K6's batched launch takes: the batch rounded up to
    a power of two, at most 8 f32 members or 4 f64 ones."""
    return min(1 << (nmembers - 1).bit_length(), 4 if vtype == torch.float64 else 8)


def _k6_batch_equals(op, xs):
    """K6 on the batch `xs` (one launch, under its group) against the plain
    version and member by member against one-tracer launches, bit for
    bit."""
    from otmb_tpu_torch.models import redi_kernel

    nb, group = xs.shape[0], _k6_group(xs.shape[0], xs.dtype)
    tally = lambda: redi_kernel.batch_groups.get(group, 0)
    n6, g6 = _build.calls(K6_MULTI), tally()
    got = P.redi_apply_fused_multi(op, xs)
    assert _build.calls(K6_MULTI) == n6 + 1 and tally() == g6 + 1
    assert redi_kernel.plan(op, xs, True)["group"] == group
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, P.redi_apply(op, xs), rtol=0, atol=0)
    for m in range(nb):
        torch.testing.assert_close(got[m], P.redi_apply_fused(op, xs[m]), rtol=0, atol=0)


@pytest.mark.parametrize("nmembers", [1, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("types", list(REDI_TYPES))
def test_k6_multi_equals_k6_per_member(case, types, nmembers):
    """K6 on a batch (full and ragged member groups, and more than one
    group) equals one-tracer launches member by member and the plain
    version, bit for bit; each batched launch is counted under the member
    group it took."""
    _, _, idx, _, chi = case
    ctype, vtype = REDI_TYPES[types]
    op = _redi(case).to(ctype)
    rng = np.random.default_rng(9)
    xs = torch.where(idx.wet3d, torch.as_tensor(rng.standard_normal((nmembers,) + chi.shape),
                                                device=chi.device), torch.nan).to(vtype)
    _k6_batch_equals(op, xs)


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
    levels (nz = 13), one tracer and B = 1, 3, 4, 5, 8, 9 and 16 (full,
    ragged and several member groups): bit for bit against the plain
    version and member by member against one-tracer launches, NaN on land
    masked."""
    ctype, vtype = REDI_TYPES[types]
    nz, ny, nx = dims
    op = _random_redi(kind, nz, ny, nx, device, seed=nz + ny + nx).to(ctype)
    rng = np.random.default_rng(nx)
    for nb in (0, 1, 3, 4, 5, 8, 9, 16):
        x = torch.as_tensor(rng.standard_normal(((nb,) if nb else ()) + (nz, ny, nx)),
                            device=device).to(vtype)
        x = torch.where(op.wet, x, torch.nan)
        if nb:
            _k6_batch_equals(op, x)
            continue
        got = P.redi_apply_fused(op, x)
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
# T + R steps: euler_propagate(_multi)(..., redi=R), one launch of K6's step
# mode a step (T's 7-point sum inside K6's walk).

#: (T's legs, R's coefficients, values): every triple the step takes.
STEP_TYPES = {"f32,f32,f32": (torch.float32, torch.float32, torch.float32),
              "f32,bf16,f32": (torch.float32, torch.bfloat16, torch.float32),
              "bf16,f32,f32": (torch.bfloat16, torch.float32, torch.float32),
              "bf16,bf16,f32": (torch.bfloat16, torch.bfloat16, torch.float32),
              "f32,f64,f64": (torch.float32, torch.float64, torch.float64),
              "f64,f64,f64": (torch.float64, torch.float64, torch.float64)}


def _step_batches(vtype: torch.dtype) -> tuple[int, ...]:
    """The batches a step test takes: one tracer (0), then full and ragged
    member groups."""
    return (0, 1, 3, 5, 8) if vtype == torch.float32 else (0, 1, 3, 4)


def _step_equals(legs, op, xs, dt: float, topo, batched: bool) -> None:
    """One T + R step of `xs` on the card against the plain step
    stencil._plain(T, chi, dt) + dt redi_apply(R, chi), bit for bit; one K6
    (one tracer) or K6 multi (a batch) call and no K5 or K1 call; for a
    batch, each member against its single run and the launch under its
    member group."""
    from otmb_tpu_torch.models import redi_kernel

    before = {name: _build.calls(prefixes) for name, prefixes in
              (("K1", K1), ("K5", K5), ("K6", K6), ("K6 multi", K6_MULTI))}
    go = P.euler_propagate_multi if batched else P.euler_propagate
    got = go(legs, xs, dt, 1, topo, redi=op)
    calls = {name: _build.calls(prefixes) - before[name] for name, prefixes in
             (("K1", K1), ("K5", K5), ("K6", K6), ("K6 multi", K6_MULTI))}
    assert calls == {"K1": 0, "K5": 0, "K6": 0 if batched else 1,
                     "K6 multi": 1 if batched else 0}, calls
    torch.testing.assert_close(got, stencil._plain(legs, xs, topo, dt)
                               + dt * P.redi_apply(op, xs), rtol=0, atol=0)
    if batched:
        plan = redi_kernel.plan(op, xs, True, "step", legs.diag.dtype)
        assert plan["group"] == _k6_group(xs.shape[0], xs.dtype), plan
        assert plan["group"] < 8 or plan["per_sm"] == 2, plan
        for m in range(xs.shape[0]):
            torch.testing.assert_close(got[m], P.euler_propagate(legs, xs[m], dt, 1, topo,
                                                                 redi=op), rtol=0, atol=0)


@pytest.mark.parametrize("types", list(STEP_TYPES))
def test_t_plus_r_step_equals_the_plain_step(case, types):
    """K6's step mode on the case's T and R, in every type triple, on both
    topologies: one tracer and B = 1, 3, 5, 8 (f32) or 1, 3, 4 (f64), with a
    finite nonzero chi on land, which T reads as stored and R as 0."""
    _, gm, idx, T, _ = case
    ltype, ctype, vtype = STEP_TYPES[types]
    legs, op, topo = T.to(ltype), _redi(case).to(ctype), gm.topology
    dt = _tr_dt(T, _redi(case))
    rng = np.random.default_rng(17)
    for nb in _step_batches(vtype):
        xs = torch.as_tensor(1.0 + rng.standard_normal(((nb,) if nb else ()) + tuple(gm.shape)),
                             device=gm.v3d.device).to(vtype)
        assert bool((xs[..., ~idx.wet3d] != 0).all())
        _step_equals(legs, op, xs, dt, topo, batched=nb > 0)


@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
@pytest.mark.parametrize("types", list(STEP_TYPES))
@pytest.mark.parametrize("dims", [(1, 1, 33), (2, 9, 45), (1, 17, 70), (3, 11, 5), (13, 9, 45)])
def test_t_plus_r_step_cut_shapes_equal_the_plain_step(device, kind, types, dims):
    """K6's step mode on shapes that cut its 32 x 8 tile on every side and
    its walk into uneven chunks, with random T legs (nonzero towards dry
    cells) and a random R and wet mask, chi random on every cell: bit for
    bit against the plain step, one tracer and B = 1, 3, 5, 8 (f32) or 1,
    3, 4 (f64)."""
    from otmb_tpu_torch.grid.topology import GridTopology

    ltype, ctype, vtype = STEP_TYPES[types]
    nz, ny, nx = dims
    topo = GridTopology(kind=kind, nx=nx, ny=ny, nz=nz)
    op = _random_redi(kind, nz, ny, nx, device, seed=nz + ny + nx + 1).to(ctype)
    rng = np.random.default_rng(nz * ny + nx)
    legs = StencilCoeffs(*(torch.as_tensor(rng.standard_normal((nz, ny, nx)),
                                           device=device).to(ltype)
                           for _ in StencilCoeffs._fields))
    for nb in _step_batches(vtype):
        xs = torch.as_tensor(rng.standard_normal(((nb,) if nb else ()) + dims),
                             device=device).to(vtype)
        _step_equals(legs, op, xs, 0.125, topo, batched=nb > 0)


@pytest.fixture(scope="module")
def one_degree_redi(one_degree):
    """R at 1 degree from a TEOS-10 density of a sloped hydrography (f64
    build; the density path's slopes, `potential_density_slopes`)."""
    gm, wet, T = one_degree
    lat, lon = torch.deg2rad(gm.lat.double()), torch.deg2rad(gm.lon.double())
    z = gm.z3d.double()
    so = torch.where(wet, 35.0 + 0.3 * torch.cos(lat) * torch.sin(lon), torch.nan)
    ct = torch.where(wet, 2.0 + 20.0 * torch.exp(-z / (300.0 + 400.0 * torch.sin(2 * lat) ** 2))
                     * torch.cos(lat) ** 2, torch.nan)
    slopes = P.potential_density_slopes(P.rho_teos10, so, ct, gm, wet)
    return P.build_redi_operator(None, gm, wet, slopes=slopes)


def _tr_dt(T, R) -> float:
    return 0.5 / (float(T.diag.abs().max()) + P.redi_max_rate(R))


@pytest.mark.parametrize("nmembers", [0, 1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_t_plus_r_steps_equal_the_eager_path_at_1_degree(one_degree, one_degree_redi, dtype,
                                                         nmembers):
    """Three T + R steps at 1 degree on the card (one tracer, B = 1 and 8)
    against the eager composition of the plain versions on the same card,
    (chi - dt T chi) + dt R chi: K6's step mode rounds as K5/K1 and then
    the Redi half do, bit for bit. In f32 at B = 8 the launch takes a member
    group of 8, two blocks an SM (T's legs staged with R's coefficients)."""
    from otmb_tpu_torch.models import redi_kernel

    gm, wet, T = one_degree
    c, R, topo = T.to(dtype), one_degree_redi.to(dtype), gm.topology
    dt = _tr_dt(T, one_degree_redi)
    rng = np.random.default_rng(12)
    shape = ((nmembers,) if nmembers else ()) + tuple(wet.shape)
    x0 = torch.where(wet, torch.as_tensor(1.0 + 0.1 * rng.standard_normal(shape),
                                          device=wet.device), 0.0).to(dtype)
    go = P.euler_propagate_multi if nmembers else P.euler_propagate
    got = go(c, x0, dt, 3, topo, redi=R)
    want = x0
    for _ in range(3):
        want = stencil._plain(c, want, topo, dt) + dt * P.redi_apply(R, want)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    without = go(c, x0, dt, 3, topo)
    assert float((got - without).abs().max()) > 0  # R moved the tracers
    if nmembers == 8 and dtype == torch.float32:
        plan = redi_kernel.plan(R, x0, True, "step", dtype)
        assert (plan["group"], plan["per_sm"]) == (8, 2), plan


@pytest.mark.parametrize("redi", [False, True])
def test_t_plus_r_step_is_two_launch_path_calls(case, redi):
    """Without R, a step issues one K5 call as before; with redi=R, where
    the earlier design issued two launch-path calls a step (K5, then K6
    adding R chi), it issues one, K6's step mode (under "K6 multi"), and
    the device runs that one kernel a step and no elementwise kernel."""
    _, gm, idx, T, chi = case
    topo, c = gm.topology, T.to(torch.float32)
    R = _redi(case).to(torch.float32) if redi else None
    xs = torch.stack([chi.float()] * 8)
    dt, steps = 0.25 / float(T.diag.abs().max()), 5
    P.euler_propagate_multi(c, xs, dt, 2, topo, redi=R)  # warm-up
    n0, k5, k6 = _build.calls(), _build.calls(K5), _build.calls(K6_MULTI)
    _, events, tries = _cuda_events(
        lambda: P.euler_propagate_multi(c, xs, dt, steps, topo, redi=R))
    assert _build.calls() - n0 == tries * steps
    assert _build.calls(K5) - k5 == (0 if redi else tries * steps)
    assert _build.calls(K6_MULTI) - k6 == (tries * steps if redi else 0)
    kernels = sorted({e.name.split("(")[0] for e in events})
    assert len(events) == steps, kernels
    assert all(("redi_kernel" if redi else "stencil_multi_kernel") in k for k in kernels), kernels


def test_t_plus_r_arguments_are_checked_on_card(case):
    _, gm, idx, T, chi = case
    topo, R = gm.topology, _redi(case)
    x = chi.double()
    with pytest.raises(TypeError, match="no kernel"):
        P.euler_propagate(T.to(torch.float32), x.float(), 1.0, 1, topo, redi=R.to(torch.float16))
    with pytest.raises(ValueError, match="on cpu"):
        P.euler_propagate(T, x, 1.0, 1, topo, redi=R.to("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        P.euler_propagate_multi(T, x[None], 1.0, 1, topo,
                                redi=dataclasses.replace(R, ae=R.ae.transpose(1, 2)
                                                         .contiguous().transpose(1, 2)))


# ----------------------------------------------------------------------------
# T - R matvecs: the steady-state solves with redi=R, one launch of K6's
# matvec mode a matvec (T's 7-point sum less R chi in one walk).

APPLY_TYPES = {"f32": torch.float32, "f64": torch.float64}


def _apply_equals(legs, op, x, topo) -> None:
    """K6's matvec mode on `x` through the solvers' dispatch against the
    plain composition apply_stencil(T, x) - redi_apply(R, x), bit for bit:
    one K6 call, of a matvec-mode entry, and no K1 call; the plan's member
    group is 1."""
    from otmb_tpu_torch.models import redi_kernel
    from otmb_tpu_torch.models import solvers as S

    counted = (("K1", K1), ("K6", K6), ("apply", redi_kernel.APPLY_ENTRIES))
    before = {name: _build.calls(prefixes) for name, prefixes in counted}
    got = S._matvec(legs, op, x, topo)
    calls = {name: _build.calls(prefixes) - before[name] for name, prefixes in counted}
    assert calls == {"K1": 0, "K6": 1, "apply": 1}, calls
    torch.testing.assert_close(got, P.apply_stencil(legs, x, topo) - P.redi_apply(op, x),
                               rtol=0, atol=0)
    assert redi_kernel.plan(op, x, False, mode="apply")["group"] == 1


@pytest.mark.parametrize("dtype", list(APPLY_TYPES))
def test_t_minus_r_matvec_equals_the_plain_composition(case, dtype):
    """K6's matvec mode on the case's T (the age's surface restoring and a
    shift folded into its diagonal) and R, f32 and f64, both topologies,
    with chi finite and nonzero on land, which T reads as stored and R as
    0."""
    _, gm, idx, T, _ = case
    dt = APPLY_TYPES[dtype]
    legs = T._replace(diag=T.diag + 1e-7 + _surface(idx.wet3d).double()).to(dt)
    rng = np.random.default_rng(23)
    x = torch.as_tensor(1.0 + rng.standard_normal(tuple(gm.shape)), device=gm.v3d.device).to(dt)
    assert bool((x[~idx.wet3d] != 0).all())
    _apply_equals(legs, _redi(case).to(dt), x, gm.topology)


@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
@pytest.mark.parametrize("dtype", list(APPLY_TYPES))
@pytest.mark.parametrize("dims", [(1, 1, 33), (2, 9, 45), (1, 17, 70), (3, 11, 5), (13, 9, 45)])
def test_t_minus_r_matvec_cut_shapes_equal_the_plain_composition(device, kind, dtype, dims):
    """K6's matvec mode on shapes that cut its 32 x 8 tile on every side and
    its walk into uneven chunks, with random T legs, a random R and wet
    mask, chi random on every cell: bit for bit against the plain
    composition."""
    from otmb_tpu_torch.grid.topology import GridTopology

    dt = APPLY_TYPES[dtype]
    nz, ny, nx = dims
    topo = GridTopology(kind=kind, nx=nx, ny=ny, nz=nz)
    op = _random_redi(kind, nz, ny, nx, device, seed=nz + ny + nx + 2).to(dt)
    rng = np.random.default_rng(nz * ny + nx + 1)
    legs = StencilCoeffs(*(torch.as_tensor(rng.standard_normal((nz, ny, nx)), device=device)
                           .to(dt) for _ in StencilCoeffs._fields))
    x = torch.as_tensor(rng.standard_normal(dims), device=device).to(dt)
    _apply_equals(legs, op, x, topo)


def test_a_graphed_t_minus_r_solve_runs_only_k6_matvecs(case):
    """BiCGStab(1) on T - R: no K1 call; each iteration two runs of K6's
    matvec mode, eager in the first iteration and inside a replay after it,
    and one more for the final residual; the two captured iterations call
    it twice each (counted under "capture:", nothing run); two solves give
    the same bits."""
    from otmb_tpu_torch.models import redi_kernel

    _, gm, idx, T, _ = case
    apply = redi_kernel.APPLY_ENTRIES[0]
    c, R = T.to(torch.float32), _redi(case).to(torch.float32)
    b = idx.wet3d.to(torch.float32)
    kw = dict(extra_diag=_surface(idx.wet3d), tol=1e-5, chunk=20, algorithm="bicgstab", redi=R)
    solves = []
    for _ in range(2):
        n1, n6, g0, c0, stats = (_build.calls(K1), _build.calls(apply),
                                 _build.calls("graph:bicg1"), _build.calls("capture:" + apply),
                                 {})
        solves.append(P.solve_shifted_chunked(c, b, gm.topology, stats=stats, **kw))
        assert _build.calls(K1) == n1
        assert _build.calls(apply) - n6 == 2 * stats["iters"] + 1
        assert _build.calls("graph:bicg1") - g0 == stats["iters"] - 1 > 2
        assert _build.calls("capture:" + apply) - c0 == 2 * 2
    (x1, r1), (x2, r2) = solves
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    assert r1 == r2 <= 1e-5


def _redi_age_1deg(one_degree, one_degree_redi, stats):
    gm, wet, T = one_degree
    return P.ideal_age(T, wet, gm.topology, tol=1e-8, refine=True, stats=stats,
                       redi=one_degree_redi.to(torch.float32))


def test_the_refined_t_minus_r_age_at_1_degree_runs_k6_not_k1(one_degree, one_degree_redi):
    """The refined age of T - R at 1 degree (f32 inner solves, f64 defects):
    no K1 call; the f32 matvec mode runs twice an inner iteration and once
    for each pass's final residual, the f64 one once a defect (its
    `ir.defect` spans); K2 and K13 as a BiCGStab(1) solve runs them."""
    from otmb_tpu_torch.models import redi_kernel
    from otmb_tpu_torch.utils import tracing

    f32, f64 = redi_kernel.APPLY_ENTRIES
    before = {k: _build.calls(p) for k, p in (("K1", K1), ("K13", K13), ("f32", f32),
                                              ("f64", f64))}
    tracing.clear()
    stats = {}
    age, res = _redi_age_1deg(one_degree, one_degree_redi, stats)
    got = {k: _build.calls(p) - before[k] for k, p in (("K1", K1), ("K13", K13), ("f32", f32),
                                                       ("f64", f64))}
    solved = [p for p in stats["passes"] if "inner_iters" in p]
    iters = sum(p["inner_iters"] for p in solved)
    defects = sum(s.name == "ir.defect" for s in tracing.spans())
    assert res <= 1e-8 and iters > 0, stats
    assert got == {"K1": 0, "K13": 5 * iters, "f32": 2 * iters + len(solved),
                   "f64": defects}, (got, iters, len(solved), defects)
    gm, wet, _ = one_degree
    assert bool(torch.isfinite(age[wet]).all()) and float(age[wet].min()) > 0


def test_the_graphed_t_minus_r_age_equals_the_eager_one(one_degree, one_degree_redi,
                                                        monkeypatch):
    """The graphed loop and the eager one give the refined age of T - R at
    1 degree the same bits: the age, the residual and the iterations."""
    from otmb_tpu_torch.models import solvers as S

    runs = []
    for graphed in (True, False):
        if not graphed:
            monkeypatch.setattr(S, "_graphed", lambda sys_, algorithm, b: False)
        g0, stats = _build.calls("graph:bicg1"), {}
        x, res = _redi_age_1deg(one_degree, one_degree_redi, stats)
        runs.append((x, res, _iterations(stats), _build.calls("graph:bicg1") - g0))
    (xg, rg, ig, replays), (xe, re_, ie, none) = runs
    assert replays > 0 and none == 0 and ig == ie
    torch.testing.assert_close(xg, xe, rtol=0, atol=0, equal_nan=True)
    assert rg == re_


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
            n7, n7m = _build.calls(K7), _build.calls(K7_MULTI)
            got = {"apply": halo_kernel.local_apply(c_l, sl(x), h),
                   "step": halo_kernel.local_apply(c_l, sl(x), h, dt),
                   "multi": halo_kernel.local_apply(c_l, sl(xs), hb),
                   "multi_step": halo_kernel.local_apply(c_l, sl(xs), hb, dt)}
            assert (_build.calls(K7), _build.calls(K7_MULTI)) == (n7 + 2, n7m + 2)
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
            n_pack, n_edge = _build.calls(K7_PACK), _build.calls(K7_EDGE)
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
            assert (_build.calls(K7_PACK), _build.calls(K7_EDGE)) == (n_pack + 1, n_edge + 2)


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
                n7m = _build.calls(K7_MULTI)
                got = halo_kernel.local_apply(c_l, x_l, lines, step)
                torch.testing.assert_close(got, sl(want), rtol=0, atol=0)
                bulk = halo_kernel._bulk(c_l, x_l, halo_kernel._NO_HALOS, step)
                assert _build.calls(K7_MULTI) == n7m + 2
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
    n = _build.calls(K4_PREP)
    res, lev = assemble._prep(gm, ml, *kappas)
    assert _build.calls(K4_PREP) == n + 1
    torch.testing.assert_close(res, assemble._residents(gm, ml, kappas[0]), rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(lev, assemble._levels(gm.zt, *kappas[1:]), rtol=0, atol=0)


def test_overlapped_step_launches_three_kernels(case):
    """One overlapped `stencil_apply_halo` step is three kernels on the card
    (pack, bulk, edge; counted by the wrappers and by torch.profiler) and,
    on one rank, no copies."""
    _, gm, _, T, chi = case
    topo = gm.topology
    grid = ProcessGrid((1, 1), 0, chi.device, "gloo")
    x = chi.float()
    c = T.to(torch.float32)
    want = P.stencil_apply(c, x, topo)
    halo_kernel.stencil_apply_halo(c, x, topo, grid, overlap=True)  # warm-up
    torch.cuda.synchronize()
    counts = (_build.calls(K7_PACK), _build.calls(K7), _build.calls(K7_EDGE))
    y, events, tries = _cuda_events(lambda: halo_kernel.stencil_apply_halo(c, x, topo, grid,
                                                                           overlap=True))
    assert (_build.calls(K7_PACK), _build.calls(K7), _build.calls(K7_EDGE)) == \
        tuple(n + tries for n in counts)
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
        n8 = _build.calls(K8)
        got = assemble_halo._launch(a)
        assert _build.calls(K8) == n8 + 1
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
        n9 = _build.calls(K9)
        got = redi_halo._launch(rs, sl(x), h)
        assert _build.calls(K9) == n9 + 1
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
    n0 = _build.calls(K1)
    y = (P.apply_stencil_ad(T, x, topo) if op == "apply"
         else P.euler_step_ad(T, x, 100.0, topo))
    assert _build.calls(K1) == n0 + 1
    y.sum().backward()
    assert _build.calls(K1) == n0 + 2
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
    n1, n2 = _build.calls(K1), _build.calls(K2)
    stats = {}
    out, res = getattr(P, workload)(T, wet, gm.topology, tol=1e-10, algorithm="gmres",
                                    stats=stats)
    assert res <= 1e-10 and res_b <= 1e-10 and stats["stop"] == "converged"
    assert _build.calls(K1) - n1 >= stats["iters"] and _build.calls(K2) - n2 >= stats["iters"]
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
    n0 = _build.calls(K11)
    got_r0, sums = krylov_algebra.polish_sums(r0, u1, r1, r2, alpha)
    assert _build.calls(K11) == n0 + 1
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
    n0 = _build.calls(K12)
    got = krylov_algebra.polish_update(y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat)
    assert _build.calls(K12) == n0 + 1
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
    n11, n12 = _build.calls(K11), _build.calls(K12)
    stats = {}
    x1, r1 = P.solve_shifted_chunked(T.to(torch.float32), b, gm.topology, stats=stats, **kw)
    cycles = stats["iters"] // 2
    assert _build.calls(K11) - n11 == cycles
    assert _build.calls(K12) - n12 == cycles
    x2, r2 = P.solve_shifted_chunked(T.to(torch.float32), b, gm.topology, **kw)
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    assert (r1 == r2) if members is None else bool((r1 == r2).all())


#: K13 shapes (nz, ny, nx): nz 1, 2, 50 and 75, uneven ny and nx, none a
#: multiple of the 1024-cell tile; (50, 300, 360) is the 1-degree grid, where
#: a block takes several tiles.
BICG1_SHAPES = [(1, 13, 37), (2, 1080, 37), (50, 13, 180), (75, 13, 1440), (50, 300, 360)]


def _bicg1_iteration(fields, rho, plain: bool):
    """K13's four entries (or their plain versions) on one iteration's
    fields, as `_bicgstab_steps` chains them."""
    x, r, p, rhat, v, phat, shat, t = fields
    A = krylov_algebra
    sums, s_entry, update, p_entry = ((A.bicg1_sums_plain, A.bicg1_s_plain,
                                       A.bicg1_update_plain, A.bicg1_p_plain) if plain else
                                      (A.bicg1_sums, A.bicg1_s, A.bicg1_update, A.bicg1_p))
    dv = sums(v, rhat)
    s, alpha = s_entry(r, v, rho, dv)
    ts = sums(t, s, True)
    x1, r1, omega, rho1 = update(x, phat, shat, s, t, rhat, alpha, ts)
    return dv, s, alpha, ts, x1, r1, omega, rho1, p_entry(r1, p, v, rho, rho1, alpha, omega)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("members", [None, 1, 3, 4])
@pytest.mark.parametrize("shape", BICG1_SHAPES)
def test_k13_equals_plain(device, shape, members, dtype):
    """Each K13 entry equals its plain version bit for bit (sums, scalars and
    updates), chained as one iteration; five launches."""
    fields, scalar = _algebra_inputs(device, shape, members, dtype, 8, 24)
    rho = scalar()
    n0 = _build.calls(K13)
    got = _bicg1_iteration(fields, rho, plain=False)
    assert _build.calls(K13) == n0 + 5
    want = _bicg1_iteration(fields, rho, plain=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("members", [None, 3])
def test_k13_guards_equal_plain(device, members, dtype):
    """Zero denominators: rhat = 0 makes <rhat, v> and rho' zero, t = 0 makes
    <t, t> and omega zero; the guards give what the plain versions give."""
    fields, scalar = _algebra_inputs(device, (50, 13, 180), members, dtype, 8, 25)
    fields[3] = torch.zeros_like(fields[3])  # rhat
    fields[7] = torch.zeros_like(fields[7])  # t
    rho = scalar()
    got = _bicg1_iteration(fields, rho, plain=False)
    want = _bicg1_iteration(fields, rho, plain=True)
    assert bool((got[6] == 0).all())  # omega
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert bool(torch.isfinite(g).all())


def test_k13_sums_repeat(device):
    """The same inputs give the same sums, bit for bit, launch after launch."""
    (a, b), _ = _algebra_inputs(device, (50, 300, 360), 3, torch.float32, 2, 26)
    first = krylov_algebra.bicg1_sums(a, b, True)
    for _ in range(3):
        torch.testing.assert_close(krylov_algebra.bicg1_sums(a, b, True), first, rtol=0, atol=0)


def test_bicgstab1_iteration_launches_only_k2_k1_k13(case):
    """One BiCGStab(1) iteration on a field is two K2 solves, two K1
    applies and K13 (five entries, three of them with a finish kernel), and
    nothing else runs on the card: no addcmul, dot or scalar kernel
    (torch.profiler)."""
    from otmb_tpu_torch.models import solvers as S

    _, gm, idx, T, _ = case
    sys_ = S._system(T.to(torch.float32), torch.float32, gm.topology, shift=1e-3)
    state = S._bicgstab_steps(sys_, S._initial_state(sys_, "bicgstab", idx.wet3d.float()), 1)
    torch.cuda.synchronize()
    names = [e.name for e in _cuda_events(lambda: S._bicgstab_steps(sys_, state, 1))[1]]
    assert sum("thomas_solve_kernel" in n for n in names) == 2, names
    assert sum("stencil_kernel" in n for n in names) == 2, names
    assert sum("bicg1_" in n for n in names) == 5, names
    assert sum("alg_finish_kernel" in n for n in names) == 3, names
    assert len(names) == 12, names


def _surface(wet: torch.Tensor) -> torch.Tensor:
    """The ideal age's surface restoring (1 on the wet top level), f32."""
    surf = torch.zeros(wet.shape, dtype=torch.float32, device=wet.device)
    surf[0] = 1.0
    return torch.where(wet, surf, 0.0)


@pytest.mark.parametrize("members", [None, 3])
def test_bicgstab1_solve_runs_k13(case, members):
    """A BiCGStab(1) solve (a field on K1 + K2, a batch on K5 + batched K2)
    runs K13's five entries every iteration, and two solves give the same
    bits. The solve is graphed: its first iteration calls the entries, then
    two iterations are captured (each entry called once, nothing run,
    counted under "capture:"), and every later iteration is one replay
    under "graph:bicg1", which counts the five entries it runs."""
    _, gm, idx, T, _ = case
    b = idx.wet3d.to(torch.float32)
    if members is not None:
        b = torch.stack([b * (m + 1) for m in range(members)])
    # the age system, 15 iterations (a shifted one converges in one)
    kw = dict(extra_diag=_surface(idx.wet3d), tol=1e-5, chunk=20, algorithm="bicgstab")
    solves = []
    for _ in range(2):
        n0, g0, c0, stats = (_build.calls(K13), _build.calls("graph:bicg1"),
                             _build.calls("capture:otmb_bicg1_"), {})
        solves.append(P.solve_shifted_chunked(T.to(torch.float32), b, gm.topology, stats=stats,
                                              **kw))
        assert _build.calls(K13) - n0 == 5 * stats["iters"]
        assert _build.calls("graph:bicg1") - g0 == stats["iters"] - 1 > 2
        assert _build.calls("capture:otmb_bicg1_") - c0 == 5 * 2
    (x1, r1), (x2, r2) = solves
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    assert (r1 == r2) if members is None else bool((r1 == r2).all())


@pytest.fixture(scope="module")
def one_degree(device):
    """The 1-degree synthetic case (360x300x50, tripolar): grid metrics, wet
    mask, and T from K4 in f32."""
    gm, wet, umo, vmo, ml = P.synthetic_device_case(360, 300, 50, device=device)
    return gm, wet, P.assemble_T(umo, vmo, ml, gm)


def _bands(gm, n: int = 4) -> np.ndarray:
    ny, nx = gm.shape[1:]
    masks = np.zeros((n, ny, nx), bool)
    for r in range(n):
        masks[r, r * ny // n:(r + 1) * ny // n] = True
    return masks


#: The solves that take the graphed BiCGStab(1) loop on the card: the
#: refined 1-degree age on an f32 field (the benchmark's age), the water-mass
#: fractions of 4 bands as one f64 batch (tol 1e-12), and the refined age in
#: the bf16-narrow mode. Each returns (x, residuals, iterations by solve).
GRAPHED_SOLVES = {
    "field_f32": lambda gm, wet, T, st: P.ideal_age(T, wet, gm.topology, tol=1e-8, refine=True,
                                                    stats=st),
    "batch_f64": lambda gm, wet, T, st: P.water_mass_fractions(
        T.to(torch.float64), wet, gm.topology, _bands(gm), tol=1e-12, stats=st),
    "bf16_narrow": lambda gm, wet, T, st: P.ideal_age(T.to(torch.bfloat16), wet, gm.topology,
                                                      tol=1e-8, refine=True, stats=st),
    # on T', whose coefficients the solve forms
    "field_f32_transposed": lambda gm, wet, T, st: P.sequestration_time(
        T, wet, gm.topology, tol=1e-8, refine=True, stats=st),
}


def _iterations(stats: dict) -> list:
    return [p.get("inner_iters") for p in stats["passes"]] if "passes" in stats \
        else [stats["iters"]]


@pytest.mark.parametrize("mode", sorted(GRAPHED_SOLVES))
def test_graphed_bicgstab1_equals_eager(one_degree, monkeypatch, mode):
    """The graphed loop (one replay an iteration) and the eager one (every
    entry called) give the same bits: x, the residuals and the iterations,
    on a 1-degree f32 field (T and, after it, T'), a B = 4 f64 batch and the
    bf16-narrow mode."""
    from otmb_tpu_torch.models import solvers as S

    gm, wet, T = one_degree
    runs = []
    for graphed in (True, False):
        if not graphed:
            monkeypatch.setattr(S, "_graphed", lambda sys_, algorithm, b: False)
        g0, stats = _build.calls("graph:bicg1"), {}
        x, res = GRAPHED_SOLVES[mode](gm, wet, T, stats)
        runs.append((x, res, _iterations(stats), _build.calls("graph:bicg1") - g0))
    (xg, rg, ig, replays), (xe, re_, ie, none) = runs
    assert replays > 0 and none == 0 and ig == ie
    torch.testing.assert_close(xg, xe, rtol=0, atol=0, equal_nan=True)  # NaN on land
    assert rg == re_ if isinstance(rg, float) else torch.equal(rg, re_)


def test_graphed_solves_keep_memory_flat(one_degree):
    """Twenty graphed solves in a row leave the allocated and the reserved
    device memory where the first left them: each solve's state sets,
    graphs and their pool are freed when it returns, the pool's memory
    given back to the device."""
    gm, wet, T = one_degree
    b = wet.to(torch.float32)
    allocated, reserved = [], []
    for _ in range(20):
        x, _ = P.solve_shifted_chunked(T, b, gm.topology, extra_diag=_surface(wet), tol=1e-6)
        del x
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
        reserved.append(torch.cuda.memory_reserved())
    assert allocated == allocated[:1] * 20, allocated
    assert reserved == reserved[:1] * 20, reserved


def test_a_graphed_solve_shows_its_kernels_to_the_profiler(one_degree):
    """torch.profiler sees the kernels inside the replays by name, as the
    benchmark's `krylov_roofline.solve` reads them: K1, K2 and each K13
    kernel, and at least one K1 kernel an iteration (two run in each, but
    the profiler now and then drops a record)."""
    gm, wet, T = one_degree
    b = wet.to(torch.float32)
    g0, stats = _build.calls("graph:bicg1"), {}
    _, events, _ = _cuda_events(lambda: P.solve_shifted_chunked(
        T, b, gm.topology, extra_diag=_surface(wet), tol=1e-6, stats=stats))
    assert _build.calls("graph:bicg1") - g0 == stats["iters"] - 1
    names = [e.name for e in events]
    for kernel in ("stencil_kernel", "thomas_solve_kernel", "bicg1_sums_kernel",
                   "bicg1_s_kernel", "bicg1_update_kernel", "bicg1_p_kernel",
                   "alg_finish_kernel"):
        assert any(kernel in n for n in names), kernel
    assert sum("stencil_kernel" in n for n in names) >= stats["iters"]


def test_k13_wrappers_raise_on_card(device):
    f = torch.zeros((2, 3, 4), dtype=torch.float32, device=device)
    s = torch.zeros((), dtype=torch.float32, device=device)
    with pytest.raises(ValueError, match="b is"):
        krylov_algebra.bicg1_sums(f, f.cpu())
    with pytest.raises(ValueError, match="rho must be"):
        krylov_algebra.bicg1_s(f, f, s.cpu(), torch.zeros((1,), device=device))
    with pytest.raises(TypeError, match="float32 or float64"):
        krylov_algebra.bicg1_sums(f.half(), f.half())


def test_a_span_holds_its_kernel_on_the_device_trace_clock(case):
    """The program's spans and torch.profiler's device trace share one clock:
    a span around a synchronised K1 launch holds the kernel's interval as
    `otmb_bench.window.device_ops` reads it, and no device operation of the
    trace is named after a program span (the spans never reach it)."""
    from torch.profiler import ProfilerActivity, profile

    from otmb_bench.window import device_ops
    from otmb_tpu_torch.utils import tracing

    _, gm, _, T, chi = case
    c, x, topo = T.to(torch.float32), chi.float(), gm.topology
    dt = 0.25 / float(T.diag.abs().max())
    P.euler_propagate(c, x, dt, 2, topo)  # warm-up
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        tracing.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with tracing.span("card.k1") as around:
                P.stencil_apply(c, x, topo)
                torch.cuda.synchronize()
            P.euler_propagate(c, x, dt, 2, topo)
            torch.cuda.synchronize()
        ops = device_ops(prof)
        if ops:
            break
    k1 = sorted((o for o in ops if "stencil_kernel" in o[0]), key=lambda o: o[1])
    assert len(k1) == 3, ops
    _, start, end = k1[0]
    lead, lag = start - around.start_ns * 1e-9, around.end_ns * 1e-9 - end
    print(f"span around K1: the kernel starts {lead * 1e6:.1f} us after the span opens and "
          f"ends {lag * 1e6:.1f} us before it closes")
    assert lead >= 0 and lag >= 0, (lead, lag)
    names = {s.name for s in tracing.spans()}
    assert names == {"card.k1", "euler_propagate"}
    assert not [o for o in ops if o[0] in names]
