"""otmb_tpu_torch's neutral physics against the benchmark's plain reference
(`otmb_bench/reference_neutral.py`, float64 PyTorch that imports neither
package): TEOS-10 density, the slopes of the locally referenced potential
density, the tapered slopes on R's faces, the GM bolus transports, R
applied to a field, and the T + R propagation `euler_propagate(_multi)(...,
redi=R)` on the CPU's eager path. Also: `redi=None` is today's path bit for
bit, the arguments are checked, the density path and the propagation leave
their spans, the adjoint reference agrees with the program's T', and the
benchmark's two neutral-physics-era cells run at a small size.

On the conftest grids (18x14x6, both topologies), f64, with a seeded
hydrography (`otmb_bench/hydrography.py`) and the dataset's flow."""

import dataclasses
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_bench import reference as REF
from otmb_bench import reference_adjoint as RA
from otmb_bench import reference_neutral as RN
from otmb_bench import roofline, roofline_neutral
from otmb_bench.hydrography import hydrography
from otmb_tpu_torch.utils import tracing

torch.set_num_threads(1)

KAPPA, MAXSLOPE, SC, SD = 600.0, 0.01, 0.004, 0.001
# Density: the program sums the polynomial in Horner form, the reference
# term by term; in float64 the two differ by a few units in the last place
# of rho ~ 1030 (measured: 2.4e-15 relative).
TOL_RHO = 1e-13
# Slopes are ratios of density differences across a cell, which are as
# small as 1e-4 kg/m^3 in the mixed layer (a 1e-4 C/m gradient over a
# level): the last-place differences of rho (~2e-13 kg/m^3) become 1e-9
# of a slope there (measured: up to 5.5e-9 of the largest), and everything
# built from the slopes inherits that.
TOL_SLOPE = 1e-7
# Given the same slopes, grid and transports, the program's R (17
# coefficient fields) and the reference's face-by-face fluxes, and T + R
# steps through each, differ only in the order of their sums.
TOL_SAME_INPUTS = 1e-12


def rel(got, want) -> float:
    """max |got - want| / max |want| over the cells finite in want; inf
    where the NaN patterns differ."""
    got, want = got.double(), want.double()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    scale = float(torch.nan_to_num(want.abs(), nan=0.0).max())
    return float(torch.nan_to_num((got - want).abs(), nan=0.0).max()) / scale


@pytest.fixture(scope="module")
def neutral(dataset, topology_kind):
    """The case through both packages' inputs: the port's f64 grid, the
    reference's grid of the same raw fields, and a seeded hydrography."""
    ds = dataset
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
                           lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    wet = P.makeindices(gm.v3d).wet3d
    raw = types.SimpleNamespace(
        topology=topology_kind, lon=ds.lon, lat=ds.lat, lon_vertices=ds.lon_vertices,
        lat_vertices=ds.lat_vertices, lev=ds.lev, areacello=ds.areacello,
        volcello=torch.as_tensor(ds.volcello), wet=wet, rng=np.random.default_rng(31))
    thetao, so = hydrography(raw)
    tri = topology_kind == "tripolar"
    grid = REF.grid_metrics(raw)
    umo, vmo = (torch.as_tensor(x) for x in (ds.umo, ds.vmo))
    return types.SimpleNamespace(ds=ds, gm=gm, wet=wet, tri=tri, grid=grid, umo=umo, vmo=vmo,
                                 thetao=thetao.double(), so=so.double(), topo=gm.topology)


@pytest.fixture(scope="module")
def slopes(neutral):
    n = neutral
    return (P.potential_density_slopes(P.rho_teos10, n.so, n.thetao, n.gm, n.wet),
            RN.neutral_slopes(n.so, n.thetao, n.grid, n.wet, n.tri))


def test_density_matches_the_reference(neutral):
    n = neutral
    got = P.rho_teos10(n.so, n.thetao, n.gm.z3d)
    assert rel(got, RN.rho_teos10(n.so, n.thetao, n.grid["z3d"])) <= TOL_RHO


def test_slopes_match_the_reference(neutral, slopes):
    """The triad slopes themselves, and clamped and tapered on R's faces."""
    n = neutral
    (pi, pj), (ri, rj) = slopes
    assert rel(pi, ri) <= TOL_SLOPE and rel(pj, rj) <= TOL_SLOPE
    R = P.build_redi_operator(None, n.gm, n.wet, kappa_redi=KAPPA, maxslope=MAXSLOPE,
                              slopes=(pi, pj))
    faces = RN.Redi((ri, rj), n.grid, n.wet, n.tri, KAPPA, MAXSLOPE, SC, SD).face_slopes()
    for name, want in faces.items():
        assert rel(getattr(R, name), want) <= TOL_SLOPE, name
    # both the clamp and the taper engage on this hydrography
    mag = torch.sqrt(torch.nan_to_num(ri) ** 2 + torch.nan_to_num(rj) ** 2)[n.wet]
    assert bool((mag > MAXSLOPE).any()) and bool(((mag > 1e-4) & (mag < SC)).any())


def test_bolus_transports_match_the_reference(neutral, slopes):
    n = neutral
    rho = P.rho_teos10(n.so, n.thetao, n.gm.z3d)
    got = P.add_bolus_transports(n.umo, n.vmo, rho, n.gm, n.wet, kappa_gm=KAPPA,
                                 maxslope=MAXSLOPE, slopes=slopes[0])
    want = RN.bolus_transports(n.umo, n.vmo, RN.rho_teos10(n.so, n.thetao, n.grid["z3d"]),
                               slopes[1], n.grid, n.wet, n.tri, KAPPA, MAXSLOPE, SC, SD)
    for g, w, raw in zip(got, want, (n.umo, n.vmo)):
        assert rel(g - raw, w - raw) <= TOL_SLOPE  # the bolus part alone
        assert float(torch.nan_to_num(w - raw).abs().max()) > 0


@pytest.mark.parametrize("own_slopes", [False, True])
def test_redi_apply_matches_the_reference(neutral, slopes, own_slopes):
    """R chi from the same slopes (only the order of sums differs), and from
    each package's own slopes."""
    n = neutral
    given = slopes[0] if own_slopes else slopes[1]
    R = P.build_redi_operator(None, n.gm, n.wet, kappa_redi=KAPPA, maxslope=MAXSLOPE,
                              slopes=given)
    ref = RN.Redi(slopes[1], n.grid, n.wet, n.tri, KAPPA, MAXSLOPE, SC, SD)
    chi = torch.where(n.wet, torch.randn(n.wet.shape, dtype=torch.float64,
                                         generator=torch.Generator().manual_seed(5)), 0.0)
    got, want = P.redi_apply(R, chi), ref(chi)
    assert rel(got, want) <= (TOL_SLOPE if own_slopes else TOL_SAME_INPUTS)
    assert rel(P.redi_apply(R, chi[None].expand(3, -1, -1, -1)), ref(chi)[None].expand(
        3, -1, -1, -1)) <= (TOL_SLOPE if own_slopes else TOL_SAME_INPUTS)


@pytest.fixture(scope="module")
def t_and_r(neutral, slopes):
    """T from the reference's GM-augmented transports through the port's
    assembly and through the reference's, and R through each, from the
    reference's slopes: the same inputs on both sides."""
    n = neutral
    rho = RN.rho_teos10(n.so, n.thetao, n.grid["z3d"])
    umo, vmo = RN.bolus_transports(n.umo, n.vmo, rho, slopes[1], n.grid, n.wet, n.tri, KAPPA,
                                   MAXSLOPE, SC, SD)
    T = P.assemble_T(umo, vmo, n.ds.mlotst, n.gm)
    legs = REF.operator(n.grid, REF.face_fluxes(umo, vmo, n.wet, n.tri),
                        torch.as_tensor(n.ds.mlotst), n.ds.lev, n.tri)
    R = P.build_redi_operator(None, n.gm, n.wet, kappa_redi=KAPPA, maxslope=MAXSLOPE,
                              slopes=slopes[1])
    ref = RN.Redi(slopes[1], n.grid, n.wet, n.tri, KAPPA, MAXSLOPE, SC, SD)
    dt = 0.5 / (float(T.diag.abs().max()) + P.redi_max_rate(R))
    return T, legs, R, ref, dt


@pytest.mark.parametrize("members", [0, 3])
def test_t_plus_r_propagation_matches_the_reference(neutral, t_and_r, members):
    """20 steps chi <- chi - dt T chi + dt R chi on the eager path against
    the reference's float64 steps, one tracer and a batch: only the order of
    sums differs (TOL_SAME_INPUTS). Leaving R out, or adding it with the
    wrong sign, misses by orders of magnitude more."""
    n = neutral
    T, legs, R, ref, dt = t_and_r
    gen = torch.Generator().manual_seed(7)
    shape = ((members,) if members else ()) + tuple(n.wet.shape)
    x0 = torch.where(n.wet, 1.0 + 0.1 * torch.randn(shape, dtype=torch.float64, generator=gen),
                     0.0)
    go = P.euler_propagate_multi if members else P.euler_propagate
    got = go(T, x0, dt, 20, n.topo, redi=R)
    want = RN.euler(legs, ref, x0, dt, 20, n.tri)
    assert rel(got, want) <= TOL_SAME_INPUTS
    minus = dataclasses.replace(R, ae=-R.ae, an=-R.an, at=-R.at)  # -R: every flux negated
    for wrong in (go(T, x0, dt, 20, n.topo), go(T, x0, dt, 20, n.topo, redi=minus)):
        assert rel(wrong, want) > 1e4 * TOL_SAME_INPUTS


def test_without_redi_the_propagation_is_todays(neutral, t_and_r):
    n = neutral
    T, _, _, _, dt = t_and_r
    from otmb_tpu_torch.ops import stencil

    x = torch.where(n.wet, torch.linspace(0, 1, n.wet.numel(), dtype=torch.float64)
                    .reshape(n.wet.shape), 0.0)
    xs = torch.stack([x, 2 * x])
    want = xs
    for _ in range(4):
        want = stencil._plain(T, want, n.topo, dt)
    for got in (P.euler_propagate_multi(T, xs, dt, 4, n.topo),
                P.euler_propagate_multi(T, xs, dt, 4, n.topo, redi=None)):
        assert torch.equal(got, want)
    assert torch.equal(P.euler_propagate(T, x, dt, 4, n.topo, redi=None), want[0])


def _other_grid_redi(R):
    from otmb_tpu_torch.grid.topology import GridTopology

    t = R.topology
    kind = "bipolar" if t.kind == "tripolar" else "tripolar"
    return dataclasses.replace(R, topology=GridTopology(kind=kind, nx=t.nx, ny=t.ny, nz=t.nz))


@pytest.mark.parametrize("case, error, match", [
    ("not an operator", TypeError, "RediOperator"),
    ("another grid", ValueError, "grid"),
    ("a pair K6 lacks", TypeError, "no kernel"),
    ("a batch of the wrong shape", ValueError, "chis has shape"),
])
def test_redi_arguments_are_checked(neutral, t_and_r, case, error, match):
    n = neutral
    T, _, R, _, dt = t_and_r
    x = torch.where(n.wet, 1.0, 0.0).double()
    redi, chi, go = R, x, P.euler_propagate
    if case == "not an operator":
        redi = R.ae
    elif case == "another grid":
        redi = _other_grid_redi(R)
    elif case == "a pair K6 lacks":  # (f32, f64): K1 and K5 take it, K6 does not
        redi, T = R.to(torch.float32), P.StencilCoeffs(*(leg.float() for leg in T))
    else:
        go, chi = P.euler_propagate_multi, x[None, 1:]
    with pytest.raises(error, match=match):
        go(T, chi, dt, 1, n.topo, redi=redi)


def test_every_type_triple_the_checks_take_has_a_step_entry():
    """Every (T's legs, R's coefficients, values) triple that
    `stencil._validate` and `redi_kernel.validate` take together names an
    entry of K6's step mode that csrc/redi.cu defines, one entry a triple."""
    from otmb_tpu_torch.models import redi_kernel
    from otmb_tpu_torch.ops import stencil

    src = (Path(P.__file__).parent / "csrc" / "redi.cu").read_text()
    defined = {f"otmb_redi_{types}_step_{legs}" for types, legs in re.findall(
        r"^OTMB_REDI_STEP_ENTRIES\((\w+), [\w ]+, [\w ]+, (\w+), ", src, re.M)}
    triples = [(legs, coef, value) for legs, value in stencil._ENTRY
               for coef, v in redi_kernel._ENTRY if v == value]
    names = [redi_kernel.step_entry(*triple) for triple in triples]
    assert len(triples) == 6 and sorted(names) == sorted(defined)


@pytest.mark.parametrize("members", [0, 3])
def test_a_triple_without_a_step_entry_raises_before_any_step(neutral, t_and_r, monkeypatch,
                                                              members):
    """Where K6's step mode has no entry for the triple, the propagation
    raises TypeError before it steps or launches anything."""
    from otmb_tpu_torch import _build
    from otmb_tpu_torch.models import redi_kernel
    from otmb_tpu_torch.ops import stencil

    n = neutral
    T, _, R, _, dt = t_and_r
    monkeypatch.delitem(redi_kernel._STEP_ENTRY, (torch.float64,) * 3)

    def stepped(*args, **kwargs):
        raise AssertionError("stepped before the check")

    monkeypatch.setattr(stencil, "_plain", stepped)
    monkeypatch.setattr(stencil, "redi_apply", stepped)
    x = torch.where(n.wet, 1.0, 0.0).double()
    chi = torch.stack([x] * members) if members else x
    go = P.euler_propagate_multi if members else P.euler_propagate
    calls = _build.calls()
    with pytest.raises(TypeError, match=r"no T \+ R step"):
        go(T, chi, dt, 1, n.topo, redi=R)
    assert _build.calls() == calls
    with pytest.raises(TypeError, match=r"no T \+ R step"):
        redi_kernel.step_entry(torch.float16, torch.float32, torch.float32)


@pytest.mark.parametrize("given", ["both", "neither"])
@pytest.mark.parametrize("build", ["build_redi_operator", "bolus_gm_velocity"])
def test_rho_or_slopes_is_given_not_both(neutral, slopes, build, given):
    """With `slopes`, `rho` would go unused: R and the bolus velocity take
    one of the two."""
    n = neutral
    rho = P.rho_teos10(n.so, n.thetao, n.gm.z3d) if given == "both" else None
    s = slopes[0] if given == "both" else None
    with pytest.raises(ValueError, match="rho or slopes"):
        getattr(P, build)(rho, n.gm, n.wet, slopes=s)


def test_the_density_path_and_the_propagation_leave_spans(neutral, t_and_r):
    n = neutral
    T, _, R, _, dt = t_and_r
    tracing.clear()
    rho = P.rho_teos10(n.so, n.thetao, n.gm.z3d)
    s = P.potential_density_slopes(P.rho_teos10, n.so, n.thetao, n.gm, n.wet)
    P.add_bolus_transports(n.umo, n.vmo, rho, n.gm, n.wet, slopes=s)
    P.build_redi_operator(rho, n.gm, n.wet)  # its own slopes: density_slopes
    x = torch.where(n.wet, 1.0, 0.0).double()
    P.euler_propagate_multi(T, x[None], dt, 3, n.topo, redi=R)
    P.euler_propagate(T, x, dt, 2, n.topo)
    got = tracing.spans()
    names = {sp.name for sp in got}
    assert {"rho_teos10", "potential_density_slopes", "add_bolus_transports",
            "build_redi_operator", "density_slopes"} <= names
    by_name = {sp.name: sp for sp in got}
    assert by_name["euler_propagate_multi"].attrs == {"redi": True, "steps": 3}
    assert by_name["euler_propagate"].attrs == {"redi": False, "steps": 2}
    slopes_span = by_name["potential_density_slopes"]
    inner = [sp for sp in got if sp.parent == slopes_span.id]
    assert len(inner) == 12 and {sp.name for sp in inner} == {"rho_teos10"}
    assert by_name["density_slopes"].parent == by_name["build_redi_operator"].id


def test_the_adjoint_reference_is_the_programs_transpose(neutral, t_and_r):
    n = neutral
    T = t_and_r[0]
    legs = T._asdict()
    x = torch.where(n.wet, torch.randn(n.wet.shape, dtype=torch.float64,
                                       generator=torch.Generator().manual_seed(3)), 0.0)
    want = P.apply_stencil(P.transpose_coeffs(T, n.topo), x, n.topo)
    assert rel(RA.apply_transpose(legs, x, n.tri), want) <= TOL_SAME_INPUTS
    # <T' x, y> = <x, T y>
    y = torch.where(n.wet, torch.cos(x), 0.0)
    lhs = float((RA.apply_transpose(legs, x, n.tri) * y).sum())
    rhs = float((x * REF.apply(legs, y, n.tri)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


def test_the_step_bytes_count_t_r_and_the_members_once():
    shape = (50, 300, 360)
    cells = 50 * 300 * 360
    got = roofline_neutral.neutral_step_bytes(shape, 4, 4, 8, 4)
    assert got == cells * (2 * 4 * 8 + 7 * 4 + 15 * 4 + 1) + 2 * 300 * 360 * 4
    # T's part alone is the Euler step's count
    no_redi = roofline.euler_step_bytes(shape, 4, 4, 8)
    assert got - no_redi == cells * (15 * 4 + 1) + 2 * 300 * 360 * 4


@pytest.mark.parametrize("cell", ["esm1deg.seqtime", "esm1deg.redi-step8"])
@pytest.mark.parametrize("control", [False, True])
def test_the_new_cells_run_on_the_cpu(cell, control):
    """The entries end to end at 24x16x8 through the harness, with the cell's
    own limits: the program is correct, its control (the reference's
    products in the next precision below) is not."""
    from otmb_bench import run as R
    from otmb_bench import spec as S

    sp = S.load(cell)
    sp.config = dict(sp.config, grid={"nx": 24, "ny": 16, "nz": 8})
    res = R.run(sp, 2**31 + 999, 0.1, False, torch.device("cpu"), control=control)
    assert res["correct"] != control, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def _zeroed(fn):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        x = out[0] if isinstance(out, tuple) else out
        x.copy_(torch.where(torch.isfinite(x), 0.0, x))
        return out
    return wrapped


def _doubled_cell(fn):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        flat = (out[0] if isinstance(out, tuple) else out).view(-1)
        wet = torch.nonzero(torch.isfinite(flat) & (flat != 0)).view(-1)
        flat[wet[len(wet) // 2]] *= 2
        return out
    return wrapped


def _without_redi(fn):
    return lambda *a, redi=None, **k: fn(*a, **k)


def _half_batch(fn):
    """The first half of the members propagated, the rest filled with their
    mean."""
    def wrapped(coeffs, xs, *a, **k):
        h = xs.shape[0] // 2
        got = fn(coeffs, xs[:h], *a, **k)
        return torch.cat([got, got.mean(0, keepdim=True).expand_as(got)[: xs.shape[0] - h]])
    return wrapped


@pytest.mark.parametrize("cell, name, fault", [
    ("esm1deg.seqtime", "sequestration_time", _zeroed),
    ("esm1deg.seqtime", "sequestration_time", _doubled_cell),
    ("esm1deg.redi-step8", "euler_propagate_multi", _zeroed),
    ("esm1deg.redi-step8", "euler_propagate_multi", _doubled_cell),
    ("esm1deg.redi-step8", "euler_propagate_multi", _without_redi),
    ("esm1deg.redi-step8", "euler_propagate_multi", _half_batch),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_answer_in_a_new_cell_is_not_correct(cell, name, fault, monkeypatch):
    """The new cells' checks see an answer zeroed (the program's residuals
    kept), one cell doubled, the propagation run without R, or half of the
    batch left out and filled with the mean of the rest."""
    from otmb_bench import run as R
    from otmb_bench import spec as S

    monkeypatch.setattr(P, name, fault(getattr(P, name)))
    sp = S.load(cell)
    sp.config = dict(sp.config, grid={"nx": 24, "ny": 16, "nz": 8})
    res = R.run(sp, 2**31 + 999, 0.1, False, torch.device("cpu"))
    assert res["failed"] == 0 and not res["correct"], res["checks"]
