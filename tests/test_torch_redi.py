"""otmb_tpu_torch's Redi isoneutral-diffusion operator against otmb_tpu on
the CPU, in float64: every RediOperator field against the JAX package's
build_redi_operator, the plain apply (single and batched) against
otmb_tpu's redi_apply and its Pallas kernels in interpret mode, the bf16
coefficient route, the operator's invariants, redi_operator_from_numpy,
and the whole density pipeline through both packages, ending in 20 T + R
steps.

The same seeded numpy inputs go through both packages on the conftest
grids (18x14x6, both topologies)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otmb_tpu as J
import otmb_tpu_torch as P
from otmb_tpu.models.redi import _COEF_FIELDS as JAX_COEF_FIELDS
from otmb_tpu.models.redi_pallas import redi_apply_pallas, redi_apply_pallas_multi
from otmb_tpu_torch.models import redi_kernel
from otmb_tpu_torch.models.redi import _COEF_FIELDS
from otmb_tpu_torch.ops.coeffs import horizontal_diffusion_coeffs
from otmb_tpu_torch.utils.convert import gridmetrics_from_numpy, redi_operator_from_numpy

torch.set_num_threads(1)

# The bound of tests/test_redi.py:118: the plain apply against the JAX
# apply and the Pallas kernels, relative to the field's largest value.
TOL_APPLY = 1e-12
KAPPA = 600.0


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


def assert_close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want| (and equal where want is 0)."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs {err:.3e} > {tol} * {scale:.3e}"


@pytest.fixture(scope="module")
def wet(indices):
    return np.asarray(indices.wet3d)


@pytest.fixture(scope="module")
def pgm(gridmetrics):
    return port_grid(gridmetrics)


@pytest.fixture(scope="module")
def rho(gridmetrics, wet):
    """The density of tests/test_redi.py: sloped isopycnals in i and j."""
    z = np.asarray(gridmetrics.z3d)
    lon, lat = np.asarray(gridmetrics.lon), np.asarray(gridmetrics.lat)
    return np.where(wet, 1025.0 + 0.02 * z + 2e-4 * z * np.cos(2 * np.deg2rad(lon))
                    + 1e-4 * z * np.sin(np.deg2rad(lat)), np.nan)


@pytest.fixture(scope="module")
def jop(rho, gridmetrics, indices):
    return J.build_redi_operator(rho, gridmetrics, indices.wet3d, kappa_redi=KAPPA)


@pytest.fixture(scope="module")
def pop(rho, pgm, wet):
    return P.build_redi_operator(torch.from_numpy(rho), pgm, torch.from_numpy(wet),
                                 kappa_redi=KAPPA)


def random_chi(wet, seed, batch=()):
    rng = np.random.default_rng(seed)
    return np.where(wet, 1.0 + rng.standard_normal(batch + wet.shape), 0.0)


# --- the operator's fields --------------------------------------------------------


def test_coef_fields_are_the_jax_packages():
    assert _COEF_FIELDS == JAX_COEF_FIELDS
    assert redi_kernel._PLANES == ("inv_de", "inv_dn")


def test_batch_group_tally_counts_card_launches_only(pop, wet):
    """`redi_kernel.batch_groups` counts K6's batched launches on the card by
    member group; a CPU batch takes the plain version and is not counted."""
    before = dict(redi_kernel.batch_groups)
    xs = torch.from_numpy(random_chi(wet, 5, (3,)))
    no_flow = P.StencilCoeffs(*(torch.zeros(wet.shape, dtype=torch.float64)
                                for _ in P.StencilCoeffs._fields))
    got = P.redi_apply_fused_multi(pop, xs)
    step = P.euler_propagate_multi(no_flow, xs, 1.0, 1, pop.topology, redi=pop)
    assert_close(got, P.redi_apply(pop, xs), 0.0, what="CPU batch")
    assert_close(step, xs + P.redi_apply(pop, xs), 0.0, what="CPU T + R step without flow")
    assert redi_kernel.batch_groups == before


@pytest.mark.parametrize("name", _COEF_FIELDS + ("wet",))
def test_operator_field_matches_jax(jop, pop, name):
    """Each field within 1e-12 of its largest value. The slopes are ratios
    of density differences; both packages form them in one order, so they
    agree at that bound too."""
    got, want = getattr(pop, name), np.asarray(getattr(jop, name))
    if name == "wet":
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert got.dtype == torch.float64 and bool(torch.isfinite(got).all())
    assert_close(got, want, 1e-12, what=name)
    # exact zeros (the no-flux faces and land) sit where the JAX package's do
    np.testing.assert_array_equal(got.numpy() == 0, want == 0, err_msg=name)


def test_operator_topology_and_to(pop, gridmetrics):
    assert pop.topology == P.GridTopology(kind=gridmetrics.topology.kind,
                                          nx=gridmetrics.topology.nx,
                                          ny=gridmetrics.topology.ny,
                                          nz=gridmetrics.topology.nz)
    op32 = pop.to(torch.float32)
    assert all(getattr(op32, k).dtype == torch.float32 for k in _COEF_FIELDS)
    assert op32.wet.dtype == torch.bool and op32.topology == pop.topology


# --- the plain apply against the JAX apply and the Pallas kernels ------------------


@pytest.mark.parametrize("ref", ["redi_apply", "redi_apply_pallas"])
def test_apply_matches_jax(jop, pop, wet, ref):
    chi = random_chi(wet, 11)
    want = (J.redi_apply(jop, chi) if ref == "redi_apply"
            else redi_apply_pallas(jop, chi, interpret=True))
    got = P.redi_apply(pop, torch.from_numpy(chi))
    assert_close(got, want, TOL_APPLY, what=ref)
    # the wrapper takes the plain version for a CPU tensor, bit for bit
    torch.testing.assert_close(P.redi_apply_fused(pop, torch.from_numpy(chi)), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("ref", ["redi_apply", "redi_apply_pallas_multi"])
def test_batched_apply_matches_jax(jop, pop, wet, ref):
    """The plain apply broadcasts over a leading batch axis: the batched
    plain version of K6-multi."""
    chis = random_chi(wet, 14, batch=(3,))
    got = P.redi_apply(pop, torch.from_numpy(chis))
    assert got.shape == chis.shape
    if ref == "redi_apply":
        for b in range(3):
            assert_close(got[b], J.redi_apply(jop, chis[b]), TOL_APPLY, what=f"member {b}")
    else:
        assert_close(got, redi_apply_pallas_multi(jop, chis, interpret=True), TOL_APPLY,
                     what=ref)
    torch.testing.assert_close(P.redi_apply_fused_multi(pop, torch.from_numpy(chis)), got,
                               rtol=0, atol=0)
    for b in range(3):
        torch.testing.assert_close(got[b], P.redi_apply(pop, torch.from_numpy(chis[b])),
                                   rtol=0, atol=0)


def test_land_values_do_not_leak(pop, wet):
    """chi is masked by wet first: NaN or garbage on land changes nothing."""
    chi = torch.from_numpy(random_chi(wet, 12))
    dirty = torch.where(torch.from_numpy(wet), chi, torch.nan)
    torch.testing.assert_close(P.redi_apply_fused(pop, dirty), P.redi_apply(pop, chi),
                               rtol=0, atol=0)
    big = torch.where(torch.from_numpy(wet), chi, 1e30)
    torch.testing.assert_close(P.redi_apply(pop, big), P.redi_apply(pop, chi), rtol=0, atol=0)


def test_bf16_route_matches_jax(jop, pop, wet):
    """bf16 coefficient streams: the same rounded values as the JAX
    package's cast; the apply in f32 matches its bf16 Pallas route at the
    bound of tests/test_redi.py:239 and the exact f64 apply within the bf16
    level of :242."""
    jb = J.redi_operator_to_bf16(jop)
    pb = P.redi_operator_to_bf16(pop)
    for k in _COEF_FIELDS:
        assert getattr(pb, k).dtype == torch.bfloat16
        np.testing.assert_array_equal(getattr(pb, k).float().numpy(),
                                      np.asarray(getattr(jb, k).astype(jnp.float32)), err_msg=k)
    chi = random_chi(wet, 16).astype(np.float32)
    got = P.redi_apply_fused(pb, torch.from_numpy(chi))
    assert got.dtype == torch.float32
    ref = np.asarray(redi_apply_pallas(jb, chi, interpret=True))
    assert_close(got, ref, 1e-5, what="bf16 vs Pallas bf16")
    exact = np.asarray(J.redi_apply(jop, chi.astype(np.float64)))
    assert_close(got, exact, 3e-2, what="bf16 vs exact")


def test_wrapper_rejects_what_the_kernel_does_not_take(pop, wet):
    chi = torch.from_numpy(random_chi(wet, 13))
    with pytest.raises(TypeError, match="no kernel"):
        P.redi_apply_fused(pop, chi.to(torch.float16))
    with pytest.raises(TypeError, match="no kernel"):
        P.redi_apply_fused(pop.to(torch.float32), chi)  # (f32, f64) is not a pair of K6
    with pytest.raises(ValueError, match="expected"):
        P.redi_apply_fused(pop, chi[:, :, :-1])
    with pytest.raises(ValueError, match="expected"):
        P.redi_apply_fused_multi(pop, chi)
    with pytest.raises(ValueError, match="contiguous"):
        P.redi_apply_fused(pop, chi.transpose(1, 2).contiguous().transpose(1, 2))


# --- invariants (tests/test_redi.py) -------------------------------------------------


def test_conserves_tracer(pop, pgm, wet):
    chi = torch.from_numpy(random_chi(wet, 0))
    tend = P.redi_apply_fused(pop, chi)
    assert bool(torch.isfinite(tend).all()) and bool((tend[~torch.from_numpy(wet)] == 0).all())
    v = torch.where(torch.from_numpy(wet), pgm.v3d, 0.0)
    total = float((tend * v).sum())
    assert abs(total) < 1e-12 * float((tend * v).abs().sum())


def test_constant_in_null_space(pop, wet):
    tend = P.redi_apply_fused(pop, torch.from_numpy(np.where(wet, 7.5, 0.0)))
    assert float(tend.abs().max()) < 1e-12


def test_linearity(pop, wet):
    x, y = (torch.from_numpy(random_chi(wet, s)) for s in (1, 2))
    lhs = P.redi_apply_fused(pop, 2.0 * x - 3.0 * y)
    rhs = 2.0 * P.redi_apply_fused(pop, x) - 3.0 * P.redi_apply_fused(pop, y)
    torch.testing.assert_close(lhs, rhs, rtol=1e-10, atol=1e-18)


def test_zero_slope_reduces_to_horizontal_diffusion(pgm, wet):
    """With a density of depth alone the slopes vanish, and R is minus the
    horizontal-diffusion stencil of the same kappa."""
    w = torch.from_numpy(wet)
    rho_z = torch.where(w, 1025.0 + 0.02 * pgm.z3d, torch.nan)
    op = P.build_redi_operator(rho_z, pgm, w, kappa_redi=500.0)
    assert float(op.s_e.abs().max()) < 1e-12 and float(op.s_ti.abs().max()) < 1e-12
    chi = torch.from_numpy(random_chi(wet, 2))
    kh = horizontal_diffusion_coeffs(pgm, w, 500.0)
    torch.testing.assert_close(P.redi_apply_fused(op, chi),
                               -P.apply_stencil(kh, chi, pgm.topology), rtol=1e-9, atol=1e-12)


def test_isoneutral_suppression(pop, pgm, wet, rho):
    """A tracer that is a function of density diffuses far less than one of
    depth alone with a gradient of the same size."""
    w = torch.from_numpy(wet)
    aligned = torch.from_numpy(np.where(wet, rho - 1025.0, 0.0))
    mis = torch.where(w, 0.02 * pgm.z3d, 0.0)
    v = torch.where(w, pgm.v3d, 0.0)
    norm = lambda t: float(torch.sqrt((t**2 * v).sum()))
    assert norm(P.redi_apply_fused(pop, aligned)) < 0.8 * norm(P.redi_apply_fused(pop, mis))


# --- carrying the JAX operator across --------------------------------------------------


def test_redi_operator_from_numpy(jop, pop, wet, gridmetrics):
    fields = {k: np.asarray(getattr(jop, k)) for k in _COEF_FIELDS}
    op = redi_operator_from_numpy(fields, jop.wet, gridmetrics.topology.kind, device="cpu")
    assert op.topology == pop.topology
    for k in _COEF_FIELDS:
        np.testing.assert_array_equal(getattr(op, k).numpy(), fields[k], err_msg=k)
    chi = random_chi(wet, 17)
    assert_close(P.redi_apply_fused(op, torch.from_numpy(chi)), J.redi_apply(jop, chi),
                 TOL_APPLY, what="carried operator")
    op32 = redi_operator_from_numpy(fields, jop.wet, gridmetrics.topology.kind, device="cpu",
                                    dtype=torch.float32)
    assert op32.ae.dtype == torch.float32


# --- the density pipeline through both packages ------------------------------------------


def _hydrography(pkg_where, wet, lat, lon, z, deg2rad, sin, cos, nan):
    """so and ct as examples/density_pipeline.py makes them."""
    so = pkg_where(wet, 35.0 + 0.3 * cos(deg2rad(lat)) * sin(deg2rad(lon)), nan)
    ct = pkg_where(wet, 20.0 - 0.004 * z - 6.0 * sin(deg2rad(lat)) ** 2, nan)
    return so, ct


def test_max_rate_bounds_the_infinity_norm(pop, wet):
    """max |R chi| <= redi_max_rate(R) * max |chi|: for sign patterns, and
    for R's diagonal read off unit vectors of a few wet cells."""
    bound = P.redi_max_rate(pop)
    assert bound > 0
    rng = np.random.default_rng(18)
    for _ in range(20):
        chi = torch.from_numpy(np.where(wet, rng.choice([-1.0, 1.0], wet.shape), 0.0))
        assert float(P.redi_apply(pop, chi).abs().max()) <= bound
    for k, j, i in np.argwhere(wet)[:: max(1, int(wet.sum()) // 20)]:
        e = torch.zeros(wet.shape, dtype=torch.float64)
        e[k, j, i] = 1.0
        assert abs(float(P.redi_apply(pop, e)[k, j, i])) <= bound


@pytest.mark.parametrize("topology", ["tripolar", "bipolar"])
def test_density_pipeline_matches_jax(topology):
    """so/ct -> TEOS-10 rho -> potential-density slopes -> GM bolus
    transports -> T with resolved plus eddy advection -> R -> 20 steps of
    chi <- chi - dt T chi + dt R chi, through each package's public API on
    its own grid, in f64: every field and the final tracers within 1e-12
    of their largest value (~5e-16 seen)."""
    jds = J.synthetic_dataset(nx=18, ny=14, nz=6, topology=topology, seed=3)
    pds = P.synthetic_dataset(nx=18, ny=14, nz=6, topology=topology, seed=3)
    kw = lambda ds: dict(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
                         lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices)
    jgm = J.makegridmetrics(**kw(jds))
    pgm = P.makegridmetrics(**kw(pds), device="cpu")
    jidx, pidx = J.makeindices(jgm.v3d), P.makeindices(pgm.v3d)
    jwet = jnp.asarray(np.asarray(jidx.wet3d))
    pwet = pidx.wet3d
    np.testing.assert_array_equal(pwet.numpy(), np.asarray(jwet))

    jso, jct = _hydrography(jnp.where, jwet, jgm.lat, jgm.lon, jgm.z3d, jnp.deg2rad, jnp.sin,
                            jnp.cos, jnp.nan)
    pso, pct = _hydrography(torch.where, pwet, pgm.lat, pgm.lon, pgm.z3d, torch.deg2rad,
                            torch.sin, torch.cos, torch.nan)
    jrho = J.rho_teos10(jso, jct, jgm.z3d)
    prho = P.rho_teos10(pso, pct, pgm.z3d)
    assert_close(torch.nan_to_num(prho), np.nan_to_num(np.asarray(jrho)), 1e-12, what="rho")

    js = J.potential_density_slopes(J.rho_teos10, jso, jct, jgm, jidx.wet3d)
    ps = P.potential_density_slopes(P.rho_teos10, pso, pct, pgm, pwet)
    for g, w in zip(ps, js):
        assert_close(torch.nan_to_num(g), np.nan_to_num(np.asarray(w)), 1e-12, what="slopes")

    jumo, jvmo = J.add_bolus_transports(jds.umo, jds.vmo, jrho, jgm, jidx.wet3d)
    pumo, pvmo = P.add_bolus_transports(pds.umo, pds.vmo, prho, pgm, pwet)
    jphi = J.facefluxesfrommasstransport(umo=jumo, vmo=jvmo, gridmetrics=jgm, indices=jidx)
    pphi = P.facefluxesfrommasstransport(umo=pumo, vmo=pvmo, gridmetrics=pgm, indices=pidx)
    jT = J.transportmatrix(phi=jphi, mlotst=jds.mlotst, gridmetrics=jgm, indices=jidx).T
    pT = P.transportmatrix(phi=pphi, mlotst=pds.mlotst, gridmetrics=pgm, indices=pidx).T
    for leg in pT._fields:
        assert_close(pT[leg], np.asarray(jT[leg]), 1e-12, what=f"T.{leg}")
    # K4 on the augmented transports builds the same T
    for leg, c in zip(pT._fields, P.assemble_T(pumo, pvmo, pds.mlotst, pgm)):
        assert_close(c, pT[leg].numpy(), 1e-12, what=f"assemble_T.{leg}")

    jR = J.build_redi_operator(jnp.where(jwet, jrho, jnp.nan), jgm, jidx.wet3d)
    pR = P.build_redi_operator(torch.where(pwet, prho, torch.nan), pgm, pwet)
    for k in _COEF_FIELDS:
        assert_close(getattr(pR, k), np.asarray(getattr(jR, k)), 1e-12, what=f"R.{k}")

    dt = 0.25 / (float(pT.diag.abs().max()) + P.redi_max_rate(pR))
    rng = np.random.default_rng(5)
    chi0 = np.where(np.asarray(jwet), 1.0 + 0.1 * rng.standard_normal(jwet.shape), 0.0)
    jchi, pchi = jnp.asarray(chi0), torch.from_numpy(chi0)
    for _ in range(20):
        jchi = (jchi - dt * J.apply_stencil(jT, jchi, jgm.topology)
                + dt * J.redi_apply(jR, jchi))
        pchi = P.euler_step(pT, pchi, dt, pgm.topology) + dt * P.redi_apply_fused(pR, pchi)
    assert bool(torch.isfinite(pchi).all())
    assert_close(pchi, np.asarray(jchi), 1e-12, what="20 T + R steps")
    # the Redi part moved the tracer, and R conserves what it moves
    no_redi = torch.from_numpy(chi0)
    for _ in range(20):
        no_redi = P.euler_step(pT, no_redi, dt, pgm.topology)
    assert float((pchi - no_redi).abs().max()) > 0
