"""otmb_tpu_torch's utilities against otmb_tpu's, on the CPU: checkpoints
(their npz files cross between the packages both ways, bit for bit), the
operator validator and the NaN-debugging flag, `cell_thickness_from_lev_bnds`,
the CMIP ingestion adapters (through the xarray stub of tests/test_io.py:
xarray is not installed), the profiling harness and the plots.

Mirrors tests/test_utils.py (its utilities), tests/test_io.py and the
validator and lev_bnds tests of tests/test_parity_extras.py.
"""

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.grid.geometry import cell_thickness_from_lev_bnds as jax_thickness
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.utils import checkpoint as JK
from otmb_tpu.utils import io as JIO
from otmb_tpu.utils.debugging import validate_operator as jax_validate
from otmb_tpu_torch.utils import checkpoint as K
from otmb_tpu_torch.utils import debugging, io, plotting, profiling
from otmb_tpu_torch.utils.convert import coeffs_from_numpy
from test_io import StubDataset, StubVariable, cmip_stub, raw  # noqa: F401  (fixtures)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_ops(dataset, gridmetrics, indices):
    phi = jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                       indices=indices)
    return jax_transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                               indices=indices)


@pytest.fixture(scope="module")
def port(dataset):
    ds = dataset
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    return gm, idx, phi, P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm,
                                           indices=idx)


def _carried(jc, dtype=torch.float64):
    return coeffs_from_numpy({leg: np.asarray(jc[leg]) for leg in jc._fields}, device="cpu",
                             dtype=dtype)


# --- reference order --------------------------------------------------------------


def test_reference_order_roundtrip():
    """tests/test_utils.py:23, on numpy arrays and on tensors."""
    rng = np.random.default_rng(0)
    a3 = rng.standard_normal((5, 6, 7))  # (nx, ny, nz) reference order
    c = io.from_reference_order(a3)
    assert c.shape == (7, 6, 5)
    np.testing.assert_array_equal(io.to_reference_order(c), a3)
    np.testing.assert_array_equal(np.asfortranarray(a3).ravel(order="F"), c.ravel(order="C"))
    np.testing.assert_array_equal(io.from_reference_order(torch.from_numpy(a3)), c)
    for arr in (rng.standard_normal((5, 6)), rng.standard_normal((4, 5, 6))):
        np.testing.assert_array_equal(io.from_reference_order(arr),
                                      JIO.from_reference_order(arr))
    with pytest.raises(ValueError, match="rank"):
        io.from_reference_order(np.zeros(3))


# --- checkpoints ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_checkpoint_roundtrip(tmp_path, jax_ops, port, dtype):
    gm, idx, _, _ = port
    T = _carried(jax_ops.T, dtype)
    chi = torch.where(idx.wet3d, 2.0, 0.0)
    path = tmp_path / "op.npz"
    K.save_operator(path, T, gm.topology, chi=chi)
    coeffs, topo, extras = K.load_operator(path, device="cpu")
    assert topo == gm.topology
    for a, b in zip(coeffs, T):
        assert a.dtype == dtype and torch.equal(a, b)
    np.testing.assert_array_equal(extras["chi"], chi.numpy())
    spath = tmp_path / "state.npz"
    K.save_state(spath, chi=chi, step=np.int64(17))
    state = K.load_state(spath)
    assert int(state["step"]) == 17 and np.array_equal(state["chi"], chi.numpy())


def test_checkpoints_cross_packages_both_ways(tmp_path, jax_ops, gridmetrics, indices, port):
    """A file otmb_tpu writes loads here, and the other way round, bit for
    bit, through the same npz keys."""
    gm, idx, _, T = port
    chi = np.where(np.asarray(indices.wet3d), 3.0, 0.0)
    jpath = tmp_path / "jax.npz"
    JK.save_operator(jpath, jax_ops.T, gridmetrics.topology, chi=chi)
    coeffs, topo, extras = K.load_operator(jpath, device="cpu")
    assert (topo.kind, topo.nx, topo.ny, topo.nz) == (
        gridmetrics.topology.kind, gridmetrics.topology.nx, gridmetrics.topology.ny,
        gridmetrics.topology.nz)
    for leg in coeffs._fields:
        assert np.array_equal(coeffs[leg].numpy(), np.asarray(jax_ops.T[leg]), equal_nan=True)
    np.testing.assert_array_equal(extras["chi"], chi)

    ppath = tmp_path / "port.npz"
    K.save_operator(ppath, T.T, gm.topology, chi=torch.from_numpy(chi))
    jcoeffs, jtopo, jextras = JK.load_operator(ppath)
    assert jtopo == gridmetrics.topology
    for leg in jcoeffs._fields:
        assert np.array_equal(np.asarray(jcoeffs[leg]), T.T[leg].numpy())
    np.testing.assert_array_equal(jextras["chi"], chi)
    with np.load(ppath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)


def test_load_operator_defaults_to_the_card(tmp_path, port, monkeypatch):
    gm, _, _, T = port
    path = tmp_path / "op.npz"
    K.save_operator(path, T.T, gm.topology)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        K.load_operator(path)


# --- validation and debugging -----------------------------------------------------


def test_validate_operator_matches_jax(dataset, gridmetrics, indices, jax_ops, port):
    """tests/test_parity_extras.py:61, and the fields equal otmb_tpu's."""
    gm, idx, phi, ops = port
    val = P.validate_operator(ops.T, gm.v3d, idx.wet3d, gm.topology)
    ref = jax_validate(jax_ops.T, gridmetrics.v3d, indices.wet3d, gridmetrics.topology)
    assert val.ok_upwind
    assert (val.finite, val.diag_positive, val.offdiag_nonpositive, val.land_zero) == (
        ref.finite, ref.diag_positive, ref.offdiag_nonpositive, ref.land_zero)
    assert val.tau_div_s == pytest.approx(ref.tau_div_s, rel=1e-6)
    assert val.tau_vol_s / (1e6 * 365.25 * 24 * 3600) > 1e4
    # centred advection breaks the upwind sign structure: the validator notices
    ops_c = P.transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gm, indices=idx,
                              upwind=False)
    assert not P.validate_operator(ops_c.T, gm.v3d, idx.wet3d, gm.topology).offdiag_nonpositive


def test_nan_debugging_is_a_module_flag():
    assert debugging.NAN_DEBUG is False
    try:
        P.enable_nan_debugging()
        assert debugging.NAN_DEBUG is True
    finally:
        P.enable_nan_debugging(False)
    assert debugging.NAN_DEBUG is False


# --- geometry ----------------------------------------------------------------------


def test_lev_bnds_thickness():
    """tests/test_parity_extras.py:42, and equal to otmb_tpu's."""
    bnds = np.array([[0.0, 10.0, 25.0], [10.0, 25.0, 45.0]])  # (2, nz)
    t = P.cell_thickness_from_lev_bnds(bnds, 4, 5, device="cpu")
    assert t.shape == (3, 4, 5) and t.dtype == torch.float64
    np.testing.assert_allclose(t[:, 0, 0].numpy(), [10.0, 15.0, 20.0])
    np.testing.assert_array_equal(P.cell_thickness_from_lev_bnds(bnds.T, 4, 5, device="cpu"), t)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jax_thickness(bnds, 4, 5)))
    f32 = torch.tensor(bnds, dtype=torch.float32)
    assert P.cell_thickness_from_lev_bnds(f32, 4, 5).dtype == torch.float32
    with pytest.raises(ValueError, match="lev_bnds"):
        P.cell_thickness_from_lev_bnds(np.zeros((3, 3)), 4, 5, device="cpu")


# --- ingestion (tests/test_io.py, through its stub) ------------------------------------


def _direct(raw):
    return P.makegridmetrics(areacello=raw.areacello, volcello=raw.volcello, lon=raw.lon,
                             lat=raw.lat, lev=raw.lev, lon_vertices=raw.lon_vertices,
                             lat_vertices=raw.lat_vertices, device="cpu")


def test_gridmetrics_from_xarray_matches_direct(raw, cmip_stub):
    volcello_ds, areacello_ds, _, _ = cmip_stub
    gm_x = io.gridmetrics_from_xarray(volcello_ds, areacello_ds, device="cpu")
    gm = _direct(raw)
    assert gm_x.topology == gm.topology
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for name in ("v3d", "thkcello", "z3d"):
        same(getattr(gm_x, name), getattr(gm, name))
    for d in ("east", "west", "north", "south"):
        same(gm_x.edge_length[d], gm.edge_length[d])
        same(gm_x.distance_to_neighbour[d], gm.distance_to_neighbour[d])
    jgm = JIO.gridmetrics_from_xarray(volcello_ds, areacello_ds)
    np.testing.assert_array_equal(gm_x.v3d.numpy(), np.asarray(jgm.v3d))
    np.testing.assert_array_equal(gm_x.z3d.numpy(), np.asarray(jgm.z3d))


def test_fill_value_becomes_nan_land(raw, cmip_stub):
    volcello_ds, areacello_ds, _, _ = cmip_stub
    gm_x = io.gridmetrics_from_xarray(volcello_ds, areacello_ds, device="cpu")
    np.testing.assert_array_equal(P.makeindices(gm_x.v3d).wet3d.numpy(), raw.wet3d)


def test_transports_from_xarray_roundtrip(raw, cmip_stub):
    volcello_ds, areacello_ds, umo_ds, vmo_ds = cmip_stub
    umo, vmo, fill = io.transports_from_xarray(umo_ds, vmo_ds, time_index=0, device="cpu")
    ju, jv, jfill = JIO.transports_from_xarray(umo_ds, vmo_ds, time_index=0)
    assert fill == jfill == 1e20 and umo.shape == raw.umo.shape
    np.testing.assert_array_equal(umo.numpy(), ju)
    np.testing.assert_array_equal(vmo.numpy(), jv)
    gm = io.gridmetrics_from_xarray(volcello_ds, areacello_ds, device="cpu")
    idx = P.makeindices(gm.v3d)
    phi_x = P.facefluxesfrommasstransport(umo=umo, vmo=vmo, gridmetrics=gm, indices=idx,
                                          fill_value=fill)
    phi = P.facefluxesfrommasstransport(umo=raw.umo, vmo=raw.vmo, gridmetrics=_direct(raw),
                                        indices=idx)
    for leg in phi._fields:
        assert torch.equal(getattr(phi_x, leg), getattr(phi, leg)), leg
    umo1, _, _ = io.transports_from_xarray(umo_ds, vmo_ds, time_index=1, device="cpu")
    assert not torch.equal(umo1, umo)


def test_missing_variable_raises_keyerror(cmip_stub):
    volcello_ds, areacello_ds, _, _ = cmip_stub
    broken = StubDataset({k: v for k, v in volcello_ds.variables.items()
                          if "verticies" not in k})
    with pytest.raises(KeyError, match="vertices_longitude"):
        io.gridmetrics_from_xarray(broken, areacello_ds, device="cpu")


def test_reference_order_involution(raw):
    for arr in (raw.volcello, raw.areacello, raw.lon_vertices):
        np.testing.assert_array_equal(io.from_reference_order(io.to_reference_order(arr)), arr)
    nz, ny, nx = raw.volcello.shape
    assert io.to_reference_order(raw.volcello).shape == (nx, ny, nz)
    assert io.to_reference_order(raw.lon_vertices).shape == (4, nx, ny)


def test_ingestion_defaults_to_the_card_and_open_dataset_needs_xarray(cmip_stub, monkeypatch):
    volcello_ds, areacello_ds, umo_ds, vmo_ds = cmip_stub
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        io.gridmetrics_from_xarray(volcello_ds, areacello_ds)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        io.transports_from_xarray(umo_ds, vmo_ds)
    try:
        import xarray  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="xarray is required"):
            io.open_dataset("missing.nc")


# --- profiling ---------------------------------------------------------------------


def test_profiling_harness(port):
    """tests/test_utils.py:56: a roofline report of the Euler step, timed on
    the CPU here (the report says so) against a given rate."""
    gm, idx, _, ops = port
    chi = torch.where(idx.wet3d, 1.0, 0.0).double()
    step = lambda c: c - 100.0 * P.apply_stencil(ops.T, c, gm.topology)
    rep = profiling.roofline_report(step, chi, profiling.stencil_bytes(gm.topology.shape3d, 8),
                                    nsteps=10, peak_gbps=50.0)
    assert rep.seconds_per_step > 0 and rep.achieved_gbps > 0
    assert rep.fraction_of_peak == pytest.approx(rep.achieved_gbps / 50.0)
    assert rep.device == "cpu" and "steps/s" in str(rep) and "on cpu" in str(rep)
    rep0 = P.roofline_report(step, chi, 1000, nsteps=2)
    assert rep0.peak_gbps is None and rep0.fraction_of_peak is None
    assert profiling.stencil_bytes((2, 3, 4)) == 9 * 24 * 4
    with pytest.raises(ValueError, match="CUDA"):
        profiling.probe_gbps("cpu")


def test_halo_comm_model_takes_its_rates():
    topo = P.GridTopology("tripolar", 360, 300, 50)
    m = profiling.halo_comm_model(topo, (2, 2), link_gbps=450.0, mem_gbps=3000.0)
    assert m["halo_bytes_per_step"] == 2 * (180 + 150) * 50 * 4
    assert m["interior_bytes_per_step"] == 9 * 50 * 150 * 180 * 4
    assert m["t_comm_s"] == pytest.approx(m["halo_bytes_per_step"] / 450e9)
    assert 0 < m["scaling_efficiency_serial"] <= m["scaling_efficiency_overlapped"] <= 1
    with pytest.raises(TypeError):
        profiling.halo_comm_model(topo, (2, 2))


def test_trace_and_kernel_times(tmp_path, port):
    gm, idx, _, ops = port
    chi = torch.where(idx.wet3d, 1.0, 0.0).double()
    times = profiling.trace_kernel_times([lambda: P.apply_stencil(ops.T, chi, gm.topology)],
                                         logdir=str(tmp_path))
    assert times and all(n >= 1 and avg >= 0 for n, avg in times.values())
    assert (tmp_path / "trace.json").exists()
    assert profiling.kernel_time_us(times, "aten::mul") > 0
    assert profiling.kernel_time_us(times, "no such kernel") is None
    assert profiling.kernel_time_us({"a_k": (1, 2.0), "b_k": (3, 6.0)}, "_k") == 5.0
    with profiling.trace(str(tmp_path / "t")):
        P.apply_stencil(ops.T, chi, gm.topology)
    assert (tmp_path / "t" / "trace.json").exists()


# --- plots ---------------------------------------------------------------------------


def test_plots(tmp_path, port):
    pytest.importorskip("matplotlib")
    gm, idx, _, ops = port
    field = torch.where(idx.wet3d, gm.z3d, torch.nan)
    out = plotting.plot_surface(field[0], gm, title="z", path=str(tmp_path / "s.png"))
    assert out.endswith("s.png") and (tmp_path / "s.png").stat().st_size > 0
    out = plotting.plot_zonal_section(field, gm, path=str(tmp_path / "z.png"))
    assert (tmp_path / "z.png").stat().st_size > 0
    assert plotting.plot_surface(field[0].numpy()) is not None
