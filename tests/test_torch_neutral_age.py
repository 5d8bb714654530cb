"""The steady state of the neutral physics: the refined ideal age of T - R,
`ideal_age(..., redi=R)`, on the CPU's eager path, against a dense float64
solve of (T - R + M) built from the benchmark's plain reference
(`otmb_bench/reference.py`'s legs, `otmb_bench/reference_neutral.py`'s
Redi operator; float64 PyTorch that imports neither package). Also: the
system's matvec T - R against the plain composition and the reference, M's
Thomas legs against their formula (T's vertical legs less R's pure
vertical ones, the g_t term), `redi=None` as before, the argument checks,
the solves that do not take `redi=` yet, the spans, the roofline's bytes,
and the two cells this configuration brought (`esm1deg.redi-age`,
`om2qdeg.fractions4-cycles`) at a small size, whole and broken.

On the conftest grids (18x14x6, both topologies), f64, with a seeded
hydrography (`otmb_bench/hydrography.py`) and the dataset's flow, GM's
bolus transports added."""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_bench import reference as REF
from otmb_bench import reference_neutral as RN
from otmb_bench import reference_redi_age as RA
from otmb_bench import roofline, roofline_redi_solve
from otmb_bench.hydrography import hydrography
from otmb_tpu_torch.grid.topology import GridTopology
from otmb_tpu_torch.models import redi as redi_mod
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.utils import tracing

torch.set_num_threads(1)

KAPPA, MAXSLOPE, SC, SD = 600.0, 0.01, 0.004, 0.001
# The program's T and R and the reference's, built from the same slopes,
# grid and transports, differ only in the order of their sums (1e-16 of a
# leg). The dense system has a condition number of about 2e8 here, so the
# refined solve at tol 1e-12 meets the dense answer to 2.9e-13 (bipolar) and
# 6.6e-13 (tripolar) of the largest age (measured); without R it misses by
# 0.5 to 0.6 of it.
TOL_AGE = 1e-10
# T - R applied by the program and by the reference: the order of sums only.
TOL_SAME_INPUTS = 1e-12


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def neutral(dataset, topology_kind):
    """The case through both packages' inputs: the port's f64 grid, the
    reference's grid of the same raw fields, a seeded hydrography, the
    reference's slopes and GM-augmented transports; T and R through the
    port and through the reference from those."""
    ds = dataset
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
                           lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    wet = P.makeindices(gm.v3d).wet3d
    raw = types.SimpleNamespace(
        topology=topology_kind, lon=ds.lon, lat=ds.lat, lon_vertices=ds.lon_vertices,
        lat_vertices=ds.lat_vertices, lev=ds.lev, areacello=ds.areacello,
        volcello=torch.as_tensor(ds.volcello), wet=wet, rng=np.random.default_rng(31))
    thetao, so = (x.double() for x in hydrography(raw))
    tri = topology_kind == "tripolar"
    grid = REF.grid_metrics(raw)
    slopes = RN.neutral_slopes(so, thetao, grid, wet, tri)
    rho = RN.rho_teos10(so, thetao, grid["z3d"])
    umo, vmo = RN.bolus_transports(torch.as_tensor(ds.umo), torch.as_tensor(ds.vmo), rho, slopes,
                                   grid, wet, tri, KAPPA, MAXSLOPE, SC, SD)
    T = P.assemble_T(umo, vmo, ds.mlotst, gm)
    legs = REF.operator(grid, REF.face_fluxes(umo, vmo, wet, tri), torch.as_tensor(ds.mlotst),
                        ds.lev, tri)
    R = P.build_redi_operator(None, gm, wet, kappa_redi=KAPPA, maxslope=MAXSLOPE, slopes=slopes)
    ref = RN.Redi(slopes, grid, wet, tri, KAPPA, MAXSLOPE, SC, SD)
    surf = torch.where(wet, (torch.arange(wet.shape[0]) == 0).double()[:, None, None], 0.0)
    return types.SimpleNamespace(gm=gm, wet=wet, tri=tri, topo=gm.topology, T=T, legs=legs,
                                 R=R, ref=ref, surf=surf)


@pytest.fixture(scope="module")
def dense_age(neutral):
    """The age of (T - R + M) a = 1 on the wet cells by a dense float64
    solve of the reference's operator, each column the operator applied to
    a unit vector."""
    n = neutral
    cells = n.wet.numel()
    eye = torch.eye(cells, dtype=torch.float64).reshape(cells, *n.wet.shape)
    columns = RA.apply(n.legs, n.ref, eye, n.surf, n.tri).reshape(cells, cells)
    w = n.wet.reshape(-1)
    a = columns.T[w][:, w]
    return torch.linalg.solve(a, torch.ones(int(w.sum()), dtype=torch.float64))


def test_the_refined_age_of_t_minus_r_matches_a_dense_solve(neutral, dense_age):
    n = neutral
    stats = {}
    age, res = P.ideal_age(n.T, n.wet, n.topo, refine=True, tol=1e-12, redi=n.R, stats=stats)
    w = n.wet.reshape(-1)
    assert res <= 1e-12 and age.dtype == torch.float64
    assert bool(torch.isnan(age[~n.wet]).all())
    assert rel(age.reshape(-1)[w], dense_age) <= TOL_AGE
    # the largest cell's residual under the reference, as the cell reads it
    x = torch.where(n.wet, age, 0.0)
    assert RA.largest_residual(n.legs, n.ref, x, n.wet.double(), n.surf, n.tri) <= 1e-9
    # R matters: the age of T alone is another answer
    without, _ = P.ideal_age(n.T, n.wet, n.topo, refine=True, tol=1e-12)
    assert rel(without.reshape(-1)[w], dense_age) > 1e3 * TOL_AGE


@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2", "gmres"])
def test_each_algorithm_solves_t_minus_r(neutral, dense_age, algorithm):
    """Unrefined f64 solves (BiCGStab(2) unfused: K3 has no R) meet the
    dense answer to what their tolerance allows."""
    n = neutral
    age, res = P.ideal_age(n.T, n.wet, n.topo, tol=1e-11, redi=n.R, algorithm=algorithm)
    assert res <= 1e-11
    assert rel(age.reshape(-1)[n.wet.reshape(-1)], dense_age) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_matvec_is_t_minus_r(neutral, dtype):
    """The system's matvec is stencil_apply - redi_apply on the CPU (the
    plain composition that K6's matvec mode equals on the card) and, in
    f64, the reference's (T - R + M) x to the order of sums."""
    n = neutral
    T, R = P.StencilCoeffs(*(leg.to(dtype) for leg in n.T)), n.R.to(dtype)
    sys_ = S._system(T, dtype, n.topo, shift=1e-7, extra_diag=n.surf.to(dtype), redi=R)
    assert sys_.redi is not None and sys_.a.diag.dtype == dtype
    x = torch.where(n.wet, torch.randn(n.wet.shape, dtype=torch.float64,
                                       generator=torch.Generator().manual_seed(5)), 0.0).to(dtype)
    got = sys_.apply(x)
    want = P.stencil_apply(sys_.a, x, n.topo) - P.redi_apply(R, x)
    assert torch.equal(got, want)
    if dtype == torch.float64:
        ref = RA.apply(n.legs, n.ref, x, n.surf, n.tri) + 1e-7 * x
        assert rel(got, ref) <= TOL_SAME_INPUTS
        assert rel(P.stencil_apply(sys_.a, x, n.topo), ref) > 1e6 * TOL_SAME_INPUTS  # R is in it


def _by_hand(T, R, shifted):
    """M's legs by the formula: R's top-face flux at g_t (chi_up - chi) over
    the cell's volume couples k to k - 1 with inv_v at g_t of its top face
    and to k + 1 with inv_v at g_t of its bottom face (the top face of the
    cell below, 0 at the floor); T - R takes them off T's legs and adds
    them to the diagonal."""
    w = R.at * R.g_t
    w_below = torch.zeros_like(w)
    w_below[:-1] = w[1:]
    up, down = R.inv_v * w, R.inv_v * w_below
    diag = shifted + (up + down)
    return T.bottom - down, torch.where(diag != 0, diag, 1.0), T.top - up


def test_the_thomas_legs_take_off_r_vertical_legs(neutral):
    n = neutral
    sys_ = S._system(n.T, torch.float64, n.topo, extra_diag=n.surf, redi=n.R)
    shifted = n.surf + n.T.diag
    for got, want in zip(sys_.m_legs, _by_hand(n.T, n.R, shifted)):
        torch.testing.assert_close(got, want, rtol=1e-15, atol=0)
    up, diag, down = redi_mod.vertical_legs(n.R)
    assert float(up.abs().max()) > 0 and float(down.abs().max()) > 0
    assert torch.equal(diag, -(up + down))
    # nothing couples across the surface or the floor, nor to land
    assert not bool(up[0].any()) and not bool(down[-1].any())
    assert not bool(up[~n.wet].any()) and not bool(down[~n.wet].any())
    # R's vertical part of R chi is what the legs give on a column profile
    chi = torch.where(n.wet, n.gm.z3d, 0.0)
    flat = dataclasses.replace(n.R, s_ti=torch.zeros_like(n.R.s_ti),
                               s_tj=torch.zeros_like(n.R.s_tj), s_e=torch.zeros_like(n.R.s_e),
                               s_n=torch.zeros_like(n.R.s_n), ae=torch.zeros_like(n.R.ae),
                               an=torch.zeros_like(n.R.an))
    above, below = torch.zeros_like(chi), torch.zeros_like(chi)
    above[1:], below[:-1] = chi[:-1], chi[1:]
    tridiag = up * above + diag * chi + down * below
    assert rel(tridiag, P.redi_apply(flat, chi)) <= TOL_SAME_INPUTS
    # the f32 legs: formed in the system's dtype from R's f32 fields
    sys32 = S._system(n.T.to(torch.float32), torch.float32, n.topo,
                      extra_diag=n.surf.float(), redi=n.R.to(torch.float32))
    assert all(leg.dtype == torch.float32 for leg in sys32.m_legs)
    assert rel(sys32.m_legs[2], sys_.m_legs[2]) <= 1e-6


@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2"])
def test_without_redi_the_solves_are_todays(neutral, monkeypatch, algorithm):
    """redi=None builds today's system (no R, T's own Thomas legs, K3 for
    BiCGStab(2)) and gives the same bits as leaving it out."""
    n = neutral
    fused = []
    real = S._fused_step
    monkeypatch.setattr(S, "_fused_step", lambda *a: fused.append(1) or real(*a))
    got = P.ideal_age(n.T, n.wet, n.topo, refine=True, tol=1e-10, algorithm=algorithm,
                      redi=None)
    want = P.ideal_age(n.T, n.wet, n.topo, refine=True, tol=1e-10, algorithm=algorithm)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0, equal_nan=True)
    assert got[1] == want[1]
    assert bool(fused) == (algorithm == "bicgstab2")
    sys_ = S._system(n.T, torch.float64, n.topo, extra_diag=n.surf)
    assert sys_.redi is None
    legs = (n.T.bottom, n.surf + n.T.diag, n.T.top)
    assert torch.equal(sys_.m_legs[0], legs[0]) and torch.equal(sys_.m_legs[2], legs[2])


def _other_grid(R):
    t = R.topology
    kind = "bipolar" if t.kind == "tripolar" else "tripolar"
    return dataclasses.replace(R, topology=GridTopology(kind=kind, nx=t.nx, ny=t.ny, nz=t.nz))


@pytest.mark.parametrize("case, error, match", [
    ("not an operator", TypeError, "RediOperator"),
    ("another grid", ValueError, "grid"),
    ("another type than T", TypeError, "must match T's"),
    ("another device than T", ValueError, "R is on meta"),
    ("a type without a matvec", TypeError, "no T - R matvec"),
    ("a field not contiguous", ValueError, "not contiguous"),
])
def test_redi_arguments_are_checked(neutral, case, error, match):
    n = neutral
    T, redi = n.T, n.R
    if case == "not an operator":
        redi = n.R.ae
    elif case == "another grid":
        redi = _other_grid(n.R)
    elif case == "another type than T":
        redi = n.R.to(torch.float32)
    elif case == "another device than T":
        redi = n.R.to("meta")
    elif case == "a type without a matvec":  # f16: stencil and Redi plain, no K6 entry
        T, redi = P.StencilCoeffs(*(leg.half() for leg in n.T)), n.R.to(torch.float16)
    else:
        redi = dataclasses.replace(n.R, g_t=n.R.g_t.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(error, match=match):
        P.ideal_age(T, n.wet, n.topo, refine=True, redi=redi)


def _band_masks(n):
    masks = np.zeros((2,) + tuple(n.wet.shape[1:]), bool)
    masks[0, : n.wet.shape[1] // 2] = True
    masks[1, n.wet.shape[1] // 2:] = True
    return masks


@pytest.mark.parametrize("call, match", [
    ("sequestration_time", "sequestration_time with redi= is not yet supported"),
    ("water_mass_fractions", "water_mass_fractions with redi= is not yet supported"),
    ("solve_shifted_multi", "solve_shifted_multi with redi= is not yet supported"),
    ("solve_shifted_chunked_multi", "solve_shifted_chunked_multi with redi= is not yet"),
    ("ideal_age on a grid", r"process grid \(grid=\) with redi= is not yet supported"),
    ("solve_shifted_ir on a grid", r"process grid \(grid=\) with redi= is not yet supported"),
    ("solve_shifted transposed", r"adjoint \(transpose=True\) with redi= is not yet supported"),
    ("fused K3", "K3, which has no Redi operator"),
    ("jacobi", "the jacobi preconditioner with redi= is not yet supported"),
])
def test_the_solves_without_redi_say_so(neutral, call, match):
    """Every solve that does not take R yet raises ValueError, naming
    itself, rather than solve without it."""
    n = neutral
    b = n.wet.double()
    bs = torch.stack([b, 2 * b])
    grid = object()  # checked before anything reads it
    go = {
        "sequestration_time": lambda: P.sequestration_time(n.T, n.wet, n.topo, redi=n.R),
        "water_mass_fractions": lambda: P.water_mass_fractions(n.T, n.wet, n.topo,
                                                               _band_masks(n), redi=n.R),
        "solve_shifted_multi": lambda: P.solve_shifted_multi(n.T, bs, n.topo, redi=n.R),
        "solve_shifted_chunked_multi": lambda: P.solve_shifted_chunked_multi(n.T, bs, n.topo,
                                                                             redi=n.R),
        "ideal_age on a grid": lambda: P.ideal_age(n.T, n.wet, n.topo, grid=grid, redi=n.R),
        "solve_shifted_ir on a grid": lambda: P.solve_shifted_ir(n.T, b, n.topo, grid=grid,
                                                                 redi=n.R),
        "solve_shifted transposed": lambda: P.solve_shifted(n.T, b, n.topo, transpose=True,
                                                            redi=n.R),
        "fused K3": lambda: P.solve_shifted_chunked(n.T, b, n.topo, algorithm="bicgstab2",
                                                    fused=True, redi=n.R),
        "jacobi": lambda: P.solve_shifted(n.T, b, n.topo, preconditioner="jacobi", redi=n.R),
    }[call]
    with pytest.raises(ValueError, match=match):
        go()


def test_the_bf16_narrow_mode_takes_r_in_bf16(neutral, dense_age):
    """bf16 T and R (the control's lower-precision path): f32 vectors, K1's
    and K6's (bf16, f32) kernels beside each other, f64 defects on the
    widened copies; the refinement converges against the rounded operator,
    so the age misses the exact one by about bf16's rounding."""
    n = neutral
    Tb, Rb = P.StencilCoeffs(*(leg.to(torch.bfloat16) for leg in n.T)), n.R.to(torch.bfloat16)
    sys_ = S._system(Tb, torch.float32, n.topo, extra_diag=n.surf.float(), redi=Rb)
    assert sys_.outside is not None and sys_.redi.ae.dtype == torch.bfloat16
    age, res = P.ideal_age(Tb, n.wet, n.topo, refine=True, tol=1e-10, redi=Rb)
    assert res <= 1e-10
    err = rel(age.reshape(-1)[n.wet.reshape(-1)], dense_age)
    assert 1e-5 < err < 0.5, err


def test_the_spans_carry_redi(neutral):
    n = neutral
    for redi in (n.R, None):
        tracing.clear()
        P.ideal_age(n.T, n.wet, n.topo, refine=True, tol=1e-10, redi=redi)
        got = tracing.spans()
        want = redi is not None
        for name in ("ideal_age", "ir.pass", "ir.defect", "engine"):
            found = [s for s in got if s.name == name]
            assert found and all(s.attrs["redi"] is want for s in found), name


def test_the_redi_solve_bytes_count_r_twice():
    shape = (50, 300, 360)
    cells, plane = 50 * 300 * 360, 300 * 360
    got = roofline_redi_solve.bicgstab1_redi_iteration_bytes(shape, 4, 4, 1, 4)
    assert got == roofline.bicgstab1_iteration_bytes(shape, 4, 4) + 2 * (
        cells * (15 * 4 + 1) + 2 * plane * 4)
    assert abs(got / 1e9 - 1.39) < 0.01


def _run(cell, monkeypatch=None, control=False):
    from otmb_bench import run as R
    from otmb_bench import spec as S_

    sp = S_.load(cell)
    sp.config = dict(sp.config, grid={"nx": 24, "ny": 16, "nz": 8})
    if cell == "om2qdeg.fractions4-cycles":
        # the cell's limits are set at 0.25 degrees, where 300 f32 cycles
        # leave the dyes at a residual of 1.3e-7; at 24x16x8 the f32 floor
        # is 1.5e-6, so the dyes run in f64, 10 pairs (3e-16), against a
        # tolerance no solve meets, which keeps the work fixed
        sp.traffic = dict(sp.traffic, tol=1e-30, maxiter=10, dtype="float64")
    return R.run(sp, 2**31 + 999, 0.1, False, torch.device("cpu"), control=control)


@pytest.mark.parametrize("cell", ["esm1deg.redi-age", "om2qdeg.fractions4-cycles"])
@pytest.mark.parametrize("control", [False, True])
def test_the_new_cells_run_on_the_cpu(cell, control):
    """The entries end to end at 24x16x8 through the harness, with the cell's
    own limits: the program is correct, its control (the reference's
    products in the next precision below) is not."""
    res = _run(cell, control=control)
    assert res["correct"] != control, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_the_redi_age_cell_counts_k6_matvecs(monkeypatch):
    """On the CPU nothing is launched, so the counter reads 0 a request and
    the reader gives 0; the reader reads nothing where a request has no
    count (a program without the matvec mode)."""
    from otmb_bench import spec as S_
    from otmb_bench.window import Record

    read = S_.reader("matvecs_per_iter.redi_solve")
    run = types.SimpleNamespace(window=types.SimpleNamespace(records=[
        Record(0.1, 1, {"krylov_iters": 10, "k6_matvecs": 23}, True),
        Record(0.1, 1, {"krylov_iters": 30, "k6_matvecs": 63}, True)]))
    assert read(run) == pytest.approx(86 / 40)
    run.window.records = [Record(0.1, 1, {"krylov_iters": 10}, True)]
    assert read(run) is None


def _zeroed(fn):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        x = out[0]
        x.copy_(torch.where(torch.isfinite(x), 0.0, x))
        return out
    return wrapped


def _doubled_cell(fn):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        flat = out[0].view(-1)
        wet = torch.nonzero(torch.isfinite(flat) & (flat != 0)).view(-1)
        flat[wet[len(wet) // 2]] *= 2
        return out
    return wrapped


def _doubled_surface_cell(fn):
    """One surface cell of the first dye doubled: the dyes' residual is
    relative to ||b||, which lives on the surface, and after 60 pairs the
    interior's rows, whose rates are orders of magnitude smaller, hardly
    move it (ROADMAP Queue 1 item 1)."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        top = out[0][0, 0].view(-1)
        top[torch.nan_to_num(top).abs().argmax()] *= 2
        return out
    return wrapped


def _without_redi(fn):
    return lambda *a, redi=None, **k: fn(*a, **k)


def _minus_r_twice(fn):
    """R counted twice: T - 2R."""
    def wrapped(*a, redi=None, **k):
        twice = dataclasses.replace(redi, **{f: 2 * getattr(redi, f) for f in ("ae", "an", "at")})
        return fn(*a, redi=twice, **k)
    return wrapped


def _swapped_members(fn):
    def wrapped(*a, **k):
        xs, res = fn(*a, **k)
        return xs.flip(0), res
    return wrapped


@pytest.mark.parametrize("cell, name, fault", [
    ("esm1deg.redi-age", "ideal_age", _zeroed),
    ("esm1deg.redi-age", "ideal_age", _doubled_cell),
    ("esm1deg.redi-age", "ideal_age", _without_redi),
    ("esm1deg.redi-age", "ideal_age", _minus_r_twice),
    ("om2qdeg.fractions4-cycles", "solve_shifted_chunked_multi", _zeroed),
    ("om2qdeg.fractions4-cycles", "solve_shifted_chunked_multi", _doubled_surface_cell),
    ("om2qdeg.fractions4-cycles", "solve_shifted_chunked_multi", _swapped_members),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_answer_in_a_new_cell_is_not_correct(cell, name, fault, monkeypatch):
    """The new cells' checks see an answer zeroed (the program's residuals
    kept), one cell doubled, the age solved without R or with R twice, or
    the dyes' members in another order."""
    monkeypatch.setattr(P, name, fault(getattr(P, name)))
    res = _run(cell)
    assert res["failed"] == 0 and not res["correct"], res["checks"]
    assert math.isfinite(res["checks"]["grid_gap"]["value"])
