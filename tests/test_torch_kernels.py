"""The plain PyTorch versions of the K1, K2 and K4 kernels against the
Pallas kernels they replace (run in interpret mode, as the JAX package's
own tests run them on the CPU), plus the wrappers' input checks and the
build's failure path. The CUDA kernels themselves are checked on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.assemble_pallas import assemble_T_pallas
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.ops.stencil_pallas import (
    apply_stencil_pallas,
    euler_propagate_pallas,
    euler_step_pallas,
)
from otmb_tpu.ops.tridiag_pallas import tridiag_solve_pallas
from otmb_tpu_torch import _build
from otmb_tpu_torch.ops import assemble, stencil, tridiag
from otmb_tpu_torch.utils.convert import coeffs_from_numpy, gridmetrics_from_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_T(dataset, gridmetrics, indices):
    phi = jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                       indices=indices)
    return jax_transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                               indices=indices).T


@pytest.fixture(scope="module")
def T(jax_T):
    return coeffs_from_numpy({leg: np.asarray(jax_T[leg]) for leg in jax_T._fields}, device="cpu")


@pytest.fixture(scope="module")
def chi(dataset):
    rng = np.random.default_rng(21)
    return np.where(dataset.wet3d, 1.0 + 0.1 * rng.standard_normal(dataset.umo.shape), 0.0)


def port_grid(gm, dtype=torch.float64):
    """The JAX grid metrics carried over with gridmetrics_from_numpy."""
    per_dir = lambda pd: {d: np.asarray(pd[d]) for d in ("east", "west", "north", "south")}
    return gridmetrics_from_numpy(
        **{f: np.asarray(getattr(gm, f)) for f in (
            "area2d", "v3d", "thkcello", "lon", "lat", "lon_vertices", "lat_vertices",
            "z3d", "zt")},
        edge_length=per_dir(gm.edge_length), distance_to_edge=per_dir(gm.distance_to_edge),
        distance_to_neighbour=per_dir(gm.distance_to_neighbour),
        topology=gm.topology.kind, dtype=dtype, device="cpu",
    )


# --- K1 --------------------------------------------------------------------


def test_k1_apply_matches_pallas(T, jax_T, chi, gridmetrics):
    topo = gridmetrics.topology
    want = np.asarray(apply_stencil_pallas(jax_T, chi, topo, interpret=True))
    got = P.stencil_apply(T, torch.from_numpy(chi), topo)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_k1_euler_step_matches_pallas(T, jax_T, chi, gridmetrics):
    topo = gridmetrics.topology
    dt = 100.0
    want = np.asarray(euler_step_pallas(jax_T, chi, dt, topo, interpret=True))
    got = P.euler_step(T, torch.from_numpy(chi), dt, topo)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("coef_dtype", ["float32", "bfloat16"])
def test_k1_narrow_coefficients_match_pallas(T, jax_T, chi, gridmetrics, coef_dtype):
    """f32 values with f32 or bf16 coefficient planes, f32 accumulation."""
    topo = gridmetrics.topology
    jc = type(jax_T)(*(leg.astype(getattr(jnp, coef_dtype)) for leg in jax_T))
    want = np.asarray(apply_stencil_pallas(jc, chi.astype(np.float32), topo, interpret=True))
    got = P.stencil_apply(T.to(getattr(torch, coef_dtype)),
                          torch.from_numpy(chi.astype(np.float32)), topo)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_k1_mixed_f32_f64_widens_exactly(T, chi, gridmetrics):
    """(f32 coefficients, f64 values) equals the f64 apply of the widened
    f32 operator: the defect path of the refined solve."""
    topo = gridmetrics.topology
    x = torch.from_numpy(chi)
    got = P.stencil_apply(T.to(torch.float32), x, topo)
    want = P.apply_stencil(T.to(torch.float32).to(torch.float64), x, topo)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_k1_propagate_matches_pallas(T, jax_T, chi, gridmetrics):
    topo = gridmetrics.topology
    dt = 0.25 / float(np.abs(np.asarray(jax_T.diag)).max())
    want = np.asarray(euler_propagate_pallas(jax_T, chi, dt, 7, topo, interpret=True))
    got = P.euler_propagate(T, torch.from_numpy(chi), dt, 7, topo)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


# --- K2 --------------------------------------------------------------------


def _thomas_numpy(lo, di, up, b):
    """Thomas sweep in numpy float64: every product and difference rounded
    separately (numpy does not contract a - b*c into an FMA)."""
    cps, dps = [], []
    cp_prev = dp_prev = np.zeros_like(b[0])
    for k in range(b.shape[0]):
        denom = di[k] - up[k] * cp_prev
        denom = np.where(denom != 0, denom, b.dtype.type(1))
        cp_prev = lo[k] / denom
        dp_prev = (b[k] - up[k] * dp_prev) * (b.dtype.type(1) / denom)
        cps.append(cp_prev)
        dps.append(dp_prev)
    x = np.empty_like(b)
    x_next = np.zeros_like(b[0])
    for k in range(b.shape[0] - 1, -1, -1):
        x_next = dps[k] - cps[k] * x_next
        x[k] = x_next
    return x


def test_k2_matches_pallas(jax_T, chi):
    """Bit for bit against the numpy sweep; against the Pallas kernel to
    rounding, because XLA's CPU compiler contracts b - upper*dp_prev (and
    the other a - b*c) into FMAs, which the port's kernel is built not to."""
    lo, up = np.asarray(jax_T.bottom), np.asarray(jax_T.top)
    sd = np.asarray(jax_T.diag) + 1e-7
    di = np.where(sd != 0, sd, 1.0)
    got = tridiag.tridiag_solve(*(torch.tensor(a) for a in (lo, di, up, chi)))
    np.testing.assert_array_equal(got.numpy(), _thomas_numpy(lo, di, up, chi))
    want = np.asarray(tridiag_solve_pallas(lo, di, up, chi, interpret=True))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_k2_float32_matches_pallas(jax_T, chi, dataset):
    """f32 on the ideal-age preconditioner (surface restoring at rate 1/s)."""
    lo, up = (np.asarray(a, np.float32) for a in (jax_T.bottom, jax_T.top))
    surf = np.zeros(chi.shape)
    surf[0] = np.where(dataset.wet3d[0], 1.0, 0.0)
    sd = (np.asarray(jax_T.diag) + surf).astype(np.float32)
    di = np.where(sd != 0, sd, np.float32(1.0))
    b = chi.astype(np.float32)
    got = tridiag.tridiag_solve(*(torch.tensor(a) for a in (lo, di, up, b)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _thomas_numpy(lo, di, up, b))
    want = np.asarray(tridiag_solve_pallas(lo, di, up, b, interpret=True))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k2_factor_then_solve_equals_plain(jax_T, chi, dataset, dtype):
    """The engine's pair, the factor once per system and the solve per
    right-hand side, equals tridiag_solve_plain bit for bit on a field and
    on a batch; in f64 it equals the JAX package's _tridiag_preconditioner
    to rounding (XLA contracts b - upper*dp_prev into an FMA)."""
    from otmb_tpu.models.solvers import _tridiag_preconditioner

    surf = np.zeros(chi.shape)
    surf[0] = np.where(dataset.wet3d[0], 1.0, 0.0)
    shifted = np.asarray(jax_T.diag) + surf
    t = lambda a: torch.tensor(np.asarray(a, dtype))
    lo, di, up = t(jax_T.bottom), t(np.where(shifted != 0, shifted, 1.0)), t(jax_T.top)
    bs = t(np.stack([chi, -2.0 * chi, chi ** 2]))
    cp, rden = tridiag.tridiag_factor_plain(lo, di, up)
    for b in (bs[0], bs):
        got = tridiag.tridiag_solve_factored_plain(cp, rden, up, b)
        assert torch.equal(got, tridiag.tridiag_solve_plain(lo, di, up, b))
        assert torch.equal(got, tridiag.tridiag_solve_factored(*tridiag.tridiag_factor(lo, di, up),
                                                               up, b))
    if dtype == np.float64:
        want = np.asarray(_tridiag_preconditioner(jax_T, jnp.asarray(shifted))(jnp.asarray(chi)))
        got = tridiag.tridiag_solve_factored_plain(cp, rden, up, bs[0]).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# --- K4 --------------------------------------------------------------------


def _k4_case(dataset, case):
    kw, wet3d = {}, None
    if case == "centered":
        kw["upwind"] = False
    elif case == "rho3d":
        rng = np.random.default_rng(7)
        kw["rho"] = np.where(dataset.wet3d, 1025.0 + 20.0 * rng.random(dataset.umo.shape),
                             np.nan)
    elif case == "wet_mask":
        wet3d = dataset.wet3d.copy()
        wet3d[:, wet3d.shape[1] // 2, :] = False  # a dry latitude row: new coasts
        wet3d[-1] = False  # and a shallower floor
    return kw, wet3d


@pytest.mark.parametrize("case", ["upwind", "centered", "rho3d", "wet_mask"])
def test_k4_matches_pallas(dataset, gridmetrics, case):
    kw, wet3d = _k4_case(dataset, case)
    want = assemble_T_pallas(dataset.umo, dataset.vmo, dataset.mlotst, gridmetrics,
                             wet3d=wet3d, interpret=True,
                             **{k: jnp.asarray(v) if k == "rho" else v for k, v in kw.items()})
    got = P.assemble_T(dataset.umo, dataset.vmo, dataset.mlotst, port_grid(gridmetrics),
                       wet3d=wet3d, **{k: torch.from_numpy(v) if k == "rho" else v
                                       for k, v in kw.items()})
    for leg in got._fields:
        np.testing.assert_allclose(got[leg].numpy(), np.asarray(want[leg]), rtol=1e-12,
                                   atol=1e-18, err_msg=leg)


def test_k4_float32_matches_pallas(dataset, gridmetrics):
    gm32 = port_grid(gridmetrics, torch.float32)
    import jax

    jgm32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if hasattr(x, "astype") else x, gridmetrics)
    want = assemble_T_pallas(np.nan_to_num(dataset.umo).astype(np.float32),
                             np.nan_to_num(dataset.vmo).astype(np.float32),
                             dataset.mlotst.astype(np.float32), jgm32, interpret=True)
    got = P.assemble_T(dataset.umo, dataset.vmo, dataset.mlotst, gm32)
    for leg in got._fields:
        assert got[leg].dtype == torch.float32
        np.testing.assert_allclose(got[leg].numpy(), np.asarray(want[leg]), rtol=2e-5,
                                   atol=1e-12, err_msg=leg)


def test_k4_nan_rho_on_wet_raises(dataset, gridmetrics):
    rho = np.full(dataset.umo.shape, 1035.0)
    k, j, i = np.argwhere(dataset.wet3d)[0]
    rho[k, j, i] = np.nan
    with pytest.raises(FloatingPointError, match="rho"):
        P.assemble_T(dataset.umo, dataset.vmo, dataset.mlotst, port_grid(gridmetrics),
                     rho=rho)


# --- wrappers ----------------------------------------------------------------


def _bad_call(name, T, chi, topo, gm, dataset):
    x = torch.from_numpy(chi)
    if name == "stencil_noncontiguous":
        P.stencil_apply(T, x.transpose(1, 2).contiguous().transpose(1, 2), topo)
    elif name == "stencil_half_values":
        P.stencil_apply(T, x.half(), topo)
    elif name == "stencil_mixed_coefficients":
        P.stencil_apply(T._replace(east=T.east.float()), x, topo)
    elif name == "stencil_unknown_topology":
        P.euler_step(T, x, 1.0, type(topo)("unknown", topo.nx, topo.ny, topo.nz))
    elif name == "tridiag_noncontiguous":
        P.tridiag_solve(T.bottom, T.diag, T.top.transpose(1, 2).contiguous().transpose(1, 2), x)
    elif name == "tridiag_wrong_dtype":
        P.tridiag_solve(T.bottom.half(), T.diag.half(), T.top.half(), x.half())
    elif name == "tridiag_mismatched_dtypes":
        P.tridiag_solve(T.bottom.float(), T.diag, T.top, x)
    elif name == "assemble_unknown_topology":
        import dataclasses

        bad = dataclasses.replace(gm, topology=type(topo)("unknown", topo.nx, topo.ny, topo.nz))
        P.assemble_T(dataset.umo, dataset.vmo, dataset.mlotst, bad)
    elif name == "assemble_wrong_shape":
        P.assemble_T(dataset.umo[:-1], dataset.vmo, dataset.mlotst, gm)
    elif name == "assemble_noncontiguous":
        u = torch.from_numpy(dataset.umo).transpose(1, 2).contiguous().transpose(1, 2)
        P.assemble_T(u, dataset.vmo, dataset.mlotst, gm)


@pytest.mark.parametrize("name", [
    "stencil_noncontiguous", "stencil_half_values", "stencil_mixed_coefficients",
    "stencil_unknown_topology", "tridiag_noncontiguous", "tridiag_wrong_dtype",
    "tridiag_mismatched_dtypes", "assemble_unknown_topology", "assemble_wrong_shape",
    "assemble_noncontiguous",
])
def test_wrappers_reject_bad_inputs(T, chi, gridmetrics, dataset, name):
    with pytest.raises((TypeError, ValueError)):
        _bad_call(name, T, chi, gridmetrics.topology, port_grid(gridmetrics), dataset)


def test_cpu_path_launches_nothing(T, chi, gridmetrics):
    """A CPU tensor takes the plain version and never counts a launch."""
    before = (stencil.LAUNCHES, tridiag.LAUNCHES, assemble.LAUNCHES)
    x = torch.from_numpy(chi)
    P.stencil_apply(T, x, gridmetrics.topology)
    P.tridiag_solve(T.bottom, torch.where(T.diag != 0, T.diag, 1.0), T.top, x)
    assert (stencil.LAUNCHES, tridiag.LAUNCHES, assemble.LAUNCHES) == before


def test_library_path_hashes_sources_and_flags():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path()
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {"assemble.cu", "krylov.cu",
                                                         "krylov_algebra.cu", "probe.cu",
                                                         "redi.cu", "stencil.cu",
                                                         "tridiag.cu"}
    assert not any("fast-math" in f or "fast_math" in f or "ftz" in f
                   for f in _build.NVCC_FLAGS)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise, with nothing loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("topology", ["bipolar", "tripolar"])
def test_k4_degenerate_grid_matches_pallas(topology):
    """The degenerate features of test_degenerate_grids.py through the
    plain K4 and the Pallas kernel."""
    import otmb_tpu as J
    from test_degenerate_grids import _degenerate_case

    ds = _degenerate_case(topology)
    kw = dict(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
              lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices)
    want = assemble_T_pallas(ds.umo, ds.vmo, ds.mlotst, J.makegridmetrics(**kw),
                             interpret=True)
    got = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, P.makegridmetrics(**kw, device="cpu"))
    for leg in got._fields:
        np.testing.assert_allclose(got[leg].numpy(), np.asarray(want[leg]), rtol=1e-12,
                                   atol=1e-18, err_msg=leg)
