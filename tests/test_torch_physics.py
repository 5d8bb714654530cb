"""otmb_tpu_torch's density path against otmb_tpu on the CPU, in float64:
the TEOS-10 equation of state, the classic, dyad and triad derivatives,
the velocity <-> flux conversions and the GM slopes and bolus transports.

The same seeded numpy inputs go through both packages on the conftest
grids (18x14x6, both topologies). Fields must have identical NaN
positions, and their values agree within 1e-12 of each field's largest
finite value unless a looser bound says why."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.grid.geometry import midpoint_on_sphere as jax_midpoint
from otmb_tpu.models import redigm as jredigm
from otmb_tpu.ops import derivatives as jder
from otmb_tpu.ops import velocities as jvel
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.physics import eos as jeos
from otmb_tpu_torch.ops import derivatives as pder
from otmb_tpu_torch.physics import eos as peos
from otmb_tpu_torch.utils.convert import gridmetrics_from_numpy

torch.set_num_threads(1)

TOL = 1e-12


def port_grid(gm):
    """The JAX grid metrics carried over, so both packages see one grid."""
    per_dir = lambda pd: {d: np.asarray(pd[d]) for d in ("east", "west", "north", "south")}
    return gridmetrics_from_numpy(
        **{f: np.asarray(getattr(gm, f)) for f in (
            "area2d", "v3d", "thkcello", "lon", "lat", "lon_vertices", "lat_vertices",
            "z3d", "zt")},
        edge_length=per_dir(gm.edge_length), distance_to_edge=per_dir(gm.distance_to_edge),
        distance_to_neighbour=per_dir(gm.distance_to_neighbour),
        topology=gm.topology.kind, device="cpu")


def assert_same(got, want, tol=TOL, what=""):
    """Identical NaN positions; finite values within tol * max|want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"NaN positions {what}")
    ok = ~np.isnan(want)
    if not ok.any():
        return
    scale = float(np.abs(want[ok]).max()) or 1.0
    err = float(np.abs(got[ok] - want[ok]).max())
    assert err <= tol * scale, f"{what}: max abs {err:.3e} > {tol} * {scale:.3e}"


@pytest.fixture(scope="module")
def pgm(gridmetrics):
    return port_grid(gridmetrics)


@pytest.fixture(scope="module")
def wet(indices):
    return np.asarray(indices.wet3d)


@pytest.fixture(scope="module")
def so_ct(gridmetrics, wet):
    """Hydrography varying in both horizontal directions and depth, NaN on
    land, as the JAX package's density-pipeline test makes it."""
    z = np.asarray(gridmetrics.z3d)
    lat, lon = np.asarray(gridmetrics.lat), np.asarray(gridmetrics.lon)
    so = np.where(wet, 35.0 + 0.002 * z + 0.3 * np.sin(np.deg2rad(lat))
                  * np.cos(np.deg2rad(lon)), np.nan)
    ct = np.where(wet, 20.0 - 0.004 * z + 0.5 * np.cos(np.deg2rad(lon))
                  - 3.0 * np.sin(np.deg2rad(lat)) ** 2, np.nan)
    return so, ct


@pytest.fixture(scope="module")
def field(gridmetrics, wet):
    rng = np.random.default_rng(41)
    return np.where(wet, rng.standard_normal(gridmetrics.shape), np.nan)


# --- TEOS-10 -----------------------------------------------------------------


def test_eos_coefficients_are_the_jax_packages():
    """4 reduction constants, 6 of r0(z) and 52 R_ijk, the same in both."""
    coefficient = lambda n: n.startswith("_") and n[1:2].isupper()
    names = [n for n in vars(jeos) if coefficient(n)]
    assert len(names) == 4 + 6 + 52
    assert sorted(names) == sorted(n for n in vars(peos) if coefficient(n))
    for n in names:
        assert getattr(peos, n) == getattr(jeos, n), n


def test_published_check_value():
    """Roquet et al. 2015: rho(SA=30 g/kg, CT=10 C, 1000 m) = 1027.45140 kg/m^3."""
    r = float(P.rho_teos10(torch.tensor(30.0, dtype=torch.float64), 10.0, 1000.0))
    assert abs(r - 1027.45140) < 1e-4


def test_surface_sigma0():
    sa = torch.tensor([30.0, 35.0], dtype=torch.float64)
    s0 = P.sigma0_teos10(sa, torch.tensor([10.0, 15.0], dtype=torch.float64))
    assert abs(float(s0[0]) - 22.957) < 0.01 and abs(float(s0[1]) - 25.848) < 0.01


def test_expansion_coefficients_via_autograd():
    """alpha = -(1/rho) drho/dCT and beta = (1/rho) drho/dSA at (35 g/kg,
    15 C, surface) against the literature's magnitudes and the JAX
    package's jax.grad."""
    sa = torch.tensor(35.0, dtype=torch.float64, requires_grad=True)
    ct = torch.tensor(15.0, dtype=torch.float64, requires_grad=True)
    r = P.rho_teos10(sa, ct, 0.0)
    d_sa, d_ct = torch.autograd.grad(r, (sa, ct))
    alpha, beta = -float(d_ct) / float(r), float(d_sa) / float(r)
    assert 1.9e-4 < alpha < 2.3e-4 and 7.0e-4 < beta < 7.8e-4
    j_ct = float(jax.grad(lambda c: jeos.rho_teos10(35.0, c, 0.0))(15.0))
    j_sa = float(jax.grad(lambda s: jeos.rho_teos10(s, 15.0, 0.0))(35.0))
    assert abs(float(d_ct) - j_ct) <= 1e-13 * abs(j_ct)
    assert abs(float(d_sa) - j_sa) <= 1e-13 * abs(j_sa)


def test_rho_matches_jax_to_a_few_ulps():
    """The Horner chains run in the JAX package's order: f64 values agree to
    a few ulps of rho (4 ulps ~ 9e-13 kg/m^3 at 1030), and f32 to f32
    rounding of the f64 value."""
    rng = np.random.default_rng(3)
    sa, ct, z = rng.uniform(30, 38, 500), rng.uniform(-1, 25, 500), rng.uniform(0, 4000, 500)
    want = np.asarray(jeos.rho_teos10(sa, ct, z))
    got = P.rho_teos10(*(torch.from_numpy(a) for a in (sa, ct, z))).numpy()
    np.testing.assert_allclose(got, want, rtol=4 * np.finfo(np.float64).eps, atol=0)
    got32 = P.rho_teos10(*(torch.from_numpy(a.astype(np.float32)) for a in (sa, ct, z)))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want, rtol=2e-6)


def test_monotonicity_and_compressibility():
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    assert bool((torch.diff(P.rho_teos10(f64(np.linspace(5, 40, 20)), 10.0, 0.0)) > 0).all())
    assert bool((torch.diff(P.rho_teos10(35.0, f64(np.linspace(6, 30, 20)), 0.0)) < 0).all())
    z = f64(np.linspace(0.0, 5000.0, 20))
    r_z = P.rho_teos10(35.0, 5.0, z)
    assert bool((torch.diff(r_z) > 0).all())
    dr_km = float(r_z[4] - r_z[0]) / float(z[4] - z[0]) * 1000.0
    assert 4.0 < dr_km < 5.2


def test_linear_eos_and_a_scalar_only_call():
    eos = P.linear_eos(rho0=1000.0, alpha=2e-4, beta=8e-4, ct0=10.0, sa0=35.0)
    x = torch.tensor([35.0, 36.0], dtype=torch.float64)
    got = eos(x, torch.tensor([11.0, 10.0], dtype=torch.float64), None)
    want = jeos.linear_eos(rho0=1000.0, alpha=2e-4, beta=8e-4, ct0=10.0, sa0=35.0)(
        np.array([35.0, 36.0]), np.array([11.0, 10.0]), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="at least one tensor"):
        P.rho_teos10(30.0, 10.0, 1000.0)


def test_rho_on_the_grid(gridmetrics, so_ct):
    so, ct = so_ct
    z = np.asarray(gridmetrics.z3d)
    want = jeos.rho_teos10(so, ct, z)
    got = P.rho_teos10(torch.from_numpy(so), torch.from_numpy(ct), torch.from_numpy(z))
    assert_same(got, want, what="rho")


# --- derivatives ---------------------------------------------------------------

DERIVATIVES = [
    ("horizontal_derivative_forward", "i"), ("horizontal_derivative_forward", "j"),
    ("horizontal_derivative_backward", "i"), ("horizontal_derivative_backward", "j"),
    ("vertical_derivative_forward", None), ("vertical_derivative_backward", None),
    ("vertical_dyad_derivative", None),
    ("centered_triad_derivative", "i"), ("centered_triad_derivative", "j"),
    ("vertical_face_triad_derivative", "i"), ("vertical_face_triad_derivative", "j"),
]


@pytest.mark.parametrize("name,direction", DERIVATIVES)
def test_derivative_matches_jax(gridmetrics, pgm, wet, field, name, direction):
    args = () if direction is None else (direction,)
    want = getattr(jder, name)(field, gridmetrics, *args)
    got = getattr(pder, name)(torch.from_numpy(field), pgm, *args)
    assert_same(got, want, what=name)
    if name in ("vertical_dyad_derivative", "centered_triad_derivative",
                "vertical_face_triad_derivative"):
        want = getattr(jder, name)(field, gridmetrics, *args, wet)
        got = getattr(pder, name)(torch.from_numpy(field), pgm, *args, torch.from_numpy(wet))
        assert_same(got, want, what=f"{name} wet3d")


@pytest.mark.parametrize("direction", ["i", "j"])
def test_triad_group_values_distances_and_derivative(gridmetrics, pgm, wet, field, direction):
    jv = jder.vertical_face_triad_group_values(field, gridmetrics, direction)
    pv = pder.vertical_face_triad_group_values(torch.from_numpy(field), pgm, direction)
    assert sorted(pv) == sorted(jv)
    for tag in jv:
        assert_same(pv[tag], jv[tag], what=f"value {tag}")
    jd = jder.vertical_face_triad_group_distances(gridmetrics, direction)
    pd = pder.vertical_face_triad_group_distances(pgm, direction)
    for tag in jd:
        assert_same(pd[tag], jd[tag], what=f"distance {tag}")
    want = jder.vertical_face_triad_derivative_group(jv, gridmetrics, direction, wet)
    got = pder.vertical_face_triad_derivative_group(pv, pgm, direction, torch.from_numpy(wet))
    assert_same(got, want, what="group derivative")


def test_vertical_derivative_of_z_is_one(pgm):
    z = pgm.z3d
    for fn in (pder.vertical_derivative_forward, pder.vertical_derivative_backward):
        d = fn(z, pgm)
        ok = torch.isfinite(d)
        assert bool(ok.any())
        np.testing.assert_allclose(d[ok].numpy(), 1.0, rtol=1e-12)


def test_dyad_of_a_depth_field_at_the_surface(pgm, wet):
    """A surface wet cell has only its downward leg and still gets a slope;
    the dyad of chi = z is -1 (a d/d(height) derivative)."""
    chi = torch.where(torch.from_numpy(wet), pgm.z3d, torch.nan)
    d = pder.vertical_dyad_derivative(chi, pgm, torch.from_numpy(wet))
    surf = wet[0] & wet[1]
    np.testing.assert_allclose(d[0].numpy()[surf], -1.0, rtol=1e-12)


# --- velocities ------------------------------------------------------------------


def _cgrid_points(gm):
    vlon, vlat = np.asarray(gm.lon_vertices), np.asarray(gm.lat_vertices)
    u_lon, u_lat = jax_midpoint(vlon[1], vlat[1], vlon[2], vlat[2])
    v_lon, v_lat = jax_midpoint(vlon[2], vlat[2], vlon[3], vlat[3])
    return tuple(np.asarray(a) for a in (u_lon, u_lat, v_lon, v_lat))


def test_arakawa_classification_matches_jax(gridmetrics, pgm):
    vlon, vlat = np.asarray(gridmetrics.lon_vertices), np.asarray(gridmetrics.lat_vertices)
    lon, lat = np.asarray(gridmetrics.lon), np.asarray(gridmetrics.lat)
    cases = {"C": _cgrid_points(gridmetrics), "B": (vlon[2], vlat[2], vlon[2], vlat[2]),
             "A": (lon, lat, lon, lat)}
    for kind, pts in cases.items():
        want = jvel.getarakawagrid(*pts, gridmetrics)
        got = P.getarakawagrid(*pts, pgm)
        assert (got.kind, got.u_pos, got.v_pos) == (want.kind, want.u_pos, want.v_pos)
        assert got.kind == kind


def test_bgrid_interpolation_matches_jax(gridmetrics, pgm):
    vlon, vlat = np.asarray(gridmetrics.lon_vertices), np.asarray(gridmetrics.lat_vertices)
    rng = np.random.default_rng(42)
    u, v = rng.standard_normal(gridmetrics.shape), rng.standard_normal(gridmetrics.shape)
    u[0, 2, 3] = np.nan
    v[1, 4, 5] = -999.0
    want = jvel.interpolateontodefaultCgrid(u, vlon[2], vlat[2], v, vlon[2], vlat[2],
                                            gridmetrics, fill_value=-999.0)
    got = P.interpolateontodefaultCgrid(torch.from_numpy(u), vlon[2], vlat[2],
                                        torch.from_numpy(v), vlon[2], vlat[2], pgm,
                                        fill_value=-999.0)
    for g, w, what in zip(got, want, ("u", "u_lon", "u_lat", "v", "v_lon", "v_lat")):
        assert_same(g, w, what=what)
    c = _cgrid_points(gridmetrics)
    uu, vv = torch.from_numpy(u), torch.from_numpy(v)
    out = P.interpolateontodefaultCgrid(uu, c[0], c[1], vv, c[2], c[3], pgm)
    assert out[0] is uu and out[3] is vv  # the C-grid is the identity


@pytest.mark.parametrize("rho_kind", ["scalar", "3d"])
def test_velocity_flux_roundtrip_matches_jax(gridmetrics, pgm, so_ct, rho_kind):
    """velocity2fluxes and fluxes2velocity through both packages, on C-grid
    points (classified) and on B-grid corner velocities."""
    so, ct = so_ct
    rho = 1035.0 if rho_kind == "scalar" else np.asarray(
        jeos.rho_teos10(so, ct, np.asarray(gridmetrics.z3d)))
    prho = rho if rho_kind == "scalar" else torch.from_numpy(rho)
    rng = np.random.default_rng(43)
    u, v = 0.1 * rng.standard_normal(gridmetrics.shape), 0.1 * rng.standard_normal(gridmetrics.shape)
    vlon, vlat = np.asarray(gridmetrics.lon_vertices), np.asarray(gridmetrics.lat_vertices)
    for pts in (_cgrid_points(gridmetrics), (vlon[2], vlat[2], vlon[2], vlat[2])):
        ul, ut, vl, vt = pts
        want = jvel.velocity2fluxes(u, ul, ut, v, vl, vt, gridmetrics, rho)
        got = P.velocity2fluxes(torch.from_numpy(u), ul, ut, torch.from_numpy(v), vl, vt, pgm,
                                prho)
        for g, w in zip(got, want):
            assert_same(g, w, what="velocity2fluxes")
        want_uv = jvel.fluxes2velocity(*want, gridmetrics, rho)
        got_uv = P.fluxes2velocity(*got, pgm, prho)
        for g, w in zip(got_uv, want_uv):
            assert_same(g, w, what="fluxes2velocity")
    ok = np.isfinite(got_uv[0].numpy())
    assert ok.any()


def test_facefluxes_from_velocities_matches_jax(dataset, gridmetrics, pgm, indices):
    phi = jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                       indices=indices)
    u, v = jvel.fluxes2velocity(phi.east, phi.north, gridmetrics, 1035.0)
    u = np.where(np.isfinite(np.asarray(u)), np.asarray(u), 0.0)
    v = np.where(np.isfinite(np.asarray(v)), np.asarray(v), 0.0)
    ul, ut, vl, vt = _cgrid_points(gridmetrics)
    want = jvel.facefluxesfromvelocities(uo=u, uo_lon=ul, uo_lat=ut, vo=v, vo_lon=vl,
                                         vo_lat=vt, gridmetrics=gridmetrics, indices=indices,
                                         rho=1035.0)
    pidx = P.makeindices(pgm.v3d)
    got = P.facefluxesfromvelocities(uo=u, uo_lon=ul, uo_lat=ut, vo=v, vo_lon=vl, vo_lat=vt,
                                     gridmetrics=pgm, indices=pidx, rho=1035.0)
    for name in got._fields:
        assert_same(getattr(got, name), getattr(want, name), what=name)
        # and the resolved fluxes come back (velocity2fluxes inverts fluxes2velocity)
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(phi, name)),
                                   rtol=1e-9, atol=1e-2)


# --- GM slopes and bolus transports ---------------------------------------------


@pytest.fixture(scope="module")
def rho_grid(gridmetrics, so_ct):
    so, ct = so_ct
    return np.asarray(jeos.rho_teos10(so, ct, np.asarray(gridmetrics.z3d)))


def test_density_slopes_and_taper_match_jax(gridmetrics, pgm, wet, rho_grid):
    want = jredigm.density_slopes(rho_grid, gridmetrics, wet)
    got = P.density_slopes(torch.from_numpy(rho_grid), pgm, torch.from_numpy(wet))
    for g, w in zip(got, want):
        assert_same(g, w, what="density slope")
    s_i, s_j = (np.nan_to_num(np.asarray(w)) for w in want)
    assert_same(P.slope_taper(torch.from_numpy(s_i), torch.from_numpy(s_j)),
                jredigm.slope_taper(s_i, s_j), what="taper")


def test_potential_density_slopes_match_jax(gridmetrics, pgm, wet, so_ct):
    """rho_teos10 of each package inside the locally referenced slope. The
    bound is 1e-10 of the largest slope: each slope is a ratio of density
    differences (~1e-3 of rho), so the eos's few-ulp differences grow by
    ~1e3 through the cancellation."""
    so, ct = so_ct
    want = jredigm.potential_density_slopes(jeos.rho_teos10, so, ct, gridmetrics, wet)
    got = P.potential_density_slopes(P.rho_teos10, torch.from_numpy(so), torch.from_numpy(ct),
                                     pgm, torch.from_numpy(wet))
    for g, w in zip(got, want):
        assert_same(g, w, tol=1e-10, what="potential density slope")
        assert np.isfinite(np.asarray(w)).any()


def test_bolus_velocity_and_transports_match_jax(dataset, gridmetrics, pgm, wet, rho_grid):
    """The bolus velocity is held to 1e-10 of its largest value: it is the
    vertical difference of kappa_GM * S between neighbouring levels, two
    values of ~kappa_GM * maxslope = 6 whose difference is ~1e-7 of them,
    so the one-ulp differences of the two libraries' tanh in the taper grow
    by that cancellation (1.5e-12 seen on the tripolar grid)."""
    want_uv = jredigm.bolus_gm_velocity(rho_grid, gridmetrics, wet)
    got_uv = P.bolus_gm_velocity(torch.from_numpy(rho_grid), pgm, torch.from_numpy(wet))
    for g, w in zip(got_uv, want_uv):
        assert_same(g, w, tol=1e-10, what="bolus velocity")
    want = jredigm.add_bolus_transports(dataset.umo, dataset.vmo, rho_grid, gridmetrics, wet)
    got = P.add_bolus_transports(dataset.umo, dataset.vmo, torch.from_numpy(rho_grid), pgm,
                                 torch.from_numpy(wet))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert_same(g, w, what="umo/vmo with bolus")
    # the bolus part is not zero, and bounded by kappa_GM * maxslope / min dz
    bolus = got[0].numpy() - dataset.umo  # NaN where umo is (land)
    assert np.nanmax(np.abs(bolus)) > 0
    dz_min = float(np.nanmin(np.asarray(gridmetrics.thkcello)))
    finite_u = got_uv[0].numpy()[np.isfinite(got_uv[0].numpy())]
    assert np.abs(finite_u).max() < 600.0 * 0.01 * 2 / dz_min
