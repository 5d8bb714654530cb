"""otmb_tpu_torch grid layer against otmb_tpu: synthetic data, metrics,
indices and the topology's neighbour semantics, in float64 on the CPU."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.grid import topology as jtopo
from otmb_tpu.utils.synthetic import synthetic_dataset as jax_synthetic_dataset
from otmb_tpu_torch.grid import topology as ptopo

torch.set_num_threads(1)

DIRECTIONS = ("east", "west", "north", "south", "top", "bottom")
GRID_FIELDS = ("area2d", "v3d", "thkcello", "lon", "lat", "lon_vertices",
               "lat_vertices", "z3d", "zt")
PER_DIRECTION = ("edge_length", "distance_to_edge", "distance_to_neighbour")


def grid_kwargs(ds):
    return dict(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
                lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices)


@pytest.fixture(scope="module")
def port_grid(dataset):
    gm = P.makegridmetrics(**grid_kwargs(dataset), device="cpu")
    return gm, P.makeindices(gm.v3d)


@pytest.fixture(scope="module")
def field(gridmetrics):
    rng = np.random.default_rng(11)
    return rng.standard_normal(gridmetrics.shape)


def test_synthetic_dataset_bit_identical(topology_kind):
    a = jax_synthetic_dataset(nx=18, ny=14, nz=6, topology=topology_kind, seed=3)
    b = P.synthetic_dataset(nx=18, ny=14, nz=6, topology=topology_kind, seed=3)
    for name in ("areacello", "volcello", "lon", "lat", "lev", "lon_vertices",
                 "lat_vertices", "umo", "vmo", "mlotst", "wet3d"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)


def test_gridmetrics_match_jax(port_grid, gridmetrics):
    gm, _ = port_grid
    assert gm.topology.kind == gridmetrics.topology.kind
    assert gm.topology.shape3d == gridmetrics.topology.shape3d
    for name in GRID_FIELDS:
        got = getattr(gm, name)
        assert got.dtype == torch.float64, name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(gridmetrics, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    for name in PER_DIRECTION:
        for d in ("east", "west", "north", "south"):
            np.testing.assert_allclose(getattr(gm, name)[d].numpy(),
                                       np.asarray(getattr(gridmetrics, name)[d]),
                                       rtol=1e-12, atol=0, err_msg=f"{name}.{d}")


def test_indices_match_jax(port_grid, indices):
    _, idx = port_grid
    np.testing.assert_array_equal(idx.wet3d.numpy(), np.asarray(indices.wet3d))
    assert idx.nwet == indices.nwet
    np.testing.assert_array_equal(idx.lwet, indices.lwet)
    np.testing.assert_array_equal(idx.lwet3d, indices.lwet3d)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_neighbor_values_match_jax(gridmetrics, field, direction):
    topo = gridmetrics.topology
    want = np.asarray(jtopo.neighbor_values(jnp.asarray(field), direction, topo, fill=-7.0))
    got = ptopo.neighbor_values(torch.from_numpy(field), direction, topo, fill=-7.0)
    np.testing.assert_array_equal(got.numpy(), want)
    valid = ptopo.neighbor_valid(direction, topo)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jtopo.neighbor_valid(direction, topo)))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_scatter_to_neighbor_matches_jax_and_is_adjoint(gridmetrics, field, direction):
    topo = gridmetrics.topology
    x = torch.from_numpy(field)
    want = np.asarray(jtopo.scatter_to_neighbor(jnp.asarray(field), direction, topo))
    got = ptopo.scatter_to_neighbor(x, direction, topo)
    np.testing.assert_array_equal(got.numpy(), want)
    y = torch.from_numpy(np.random.default_rng(12).standard_normal(field.shape))
    lhs = float((ptopo.neighbor_values(x, direction, topo, fill=0.0) * y).sum())
    rhs = float((x * ptopo.scatter_to_neighbor(y, direction, topo)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


@pytest.mark.parametrize("n", [-2, -1, 1, 2])
@pytest.mark.parametrize("axis", ["i", "j", "k"])
def test_shift_values_match_jax(gridmetrics, field, axis, n):
    topo = gridmetrics.topology
    want = np.asarray(jtopo.shift_values(jnp.asarray(field), axis, n, topo, fill=-3.0))
    got = ptopo.shift_values(torch.from_numpy(field), axis, n, topo, fill=-3.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scrambled_north_edge_is_unknown(dataset):
    bad_vlat = dataset.lat_vertices.copy()
    nx = bad_vlat.shape[-1]
    bad_vlat[2:, -1, :] = 55.0 + np.arange(nx) * 0.37
    with pytest.warns(UserWarning, match="Unknown grid topology"):
        t = P.detect_topology(dataset.lon_vertices, bad_vlat, 4)
    assert t.kind == "unknown"
    with pytest.raises(ValueError, match="Unknown grid type"):
        ptopo.neighbor_values(torch.zeros(4, 3, nx), "north", t)


def test_makegridmetrics_unknown_topology(dataset):
    kw = grid_kwargs(dataset)
    kw["lat_vertices"] = kw["lat_vertices"].copy()
    kw["lat_vertices"][2:, -1, :] = 55.0 + np.arange(kw["lat_vertices"].shape[-1]) * 0.37
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="Unknown grid type"):
        P.makegridmetrics(**kw, device="cpu")


def test_makegridmetrics_float32_and_vertex_order(dataset, gridmetrics):
    """A permuted vertex order is canonicalised, and dtype is honoured."""
    kw = grid_kwargs(dataset)
    perm = [2, 0, 3, 1]
    kw["lon_vertices"] = dataset.lon_vertices[perm]
    kw["lat_vertices"] = dataset.lat_vertices[perm]
    gm = P.makegridmetrics(**kw, dtype=torch.float32, device="cpu")
    assert gm.v3d.dtype == torch.float32
    np.testing.assert_allclose(gm.edge_length.east.numpy(),
                               np.asarray(gridmetrics.edge_length.east), rtol=1e-5)


def test_wet_vector_roundtrip(port_grid):
    gm, idx = port_grid
    v = P.wet_vector(gm.v3d, idx)
    assert v.shape == (idx.nwet,) and np.isfinite(v).all()
    back = P.as3d(v, idx.wet3d)
    np.testing.assert_array_equal(np.isfinite(back), idx.wet3d.numpy())
    np.testing.assert_array_equal(back[idx.wet3d.numpy()], v)
    surf = idx.wet3d[0].numpy()
    s2 = P.as2d(np.arange(surf.sum(), dtype=float), idx.wet3d)
    assert np.isnan(s2[~surf]).all() and (s2[surf] == np.arange(surf.sum())).all()
    with pytest.raises(ValueError):
        P.as3d(v[:-1], idx.wet3d)


def test_import_does_not_load_jax():
    """The port imports neither jax nor otmb_tpu (modules loaded before the
    import, e.g. by a site hook, do not count)."""
    repo = str(Path(__file__).resolve().parents[1])
    code = (
        "import sys; sys.path.insert(0, %r); before = set(sys.modules)\n"
        "import otmb_tpu_torch, otmb_tpu_torch.utils.convert, otmb_tpu_torch.physics.eos\n"
        "import otmb_tpu_torch.ops.derivatives, otmb_tpu_torch.ops.velocities\n"
        "import otmb_tpu_torch.models.redigm, otmb_tpu_torch.models.redi\n"
        "import otmb_tpu_torch.models.redi_kernel, otmb_tpu_torch.parallel\n"
        "import otmb_tpu_torch.ops.autodiff, otmb_tpu_torch.utils.coarsen\n"
        "import otmb_tpu_torch.utils.checkpoint, otmb_tpu_torch.utils.debugging\n"
        "import otmb_tpu_torch.utils.io, otmb_tpu_torch.utils.plotting\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'otmb_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % repo
    )
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _entry_points(dataset):
    """Each entry point that makes tensors from host data, called without
    `device=` unless `device` is given."""
    from otmb_tpu_torch.utils.convert import (
        coeffs_from_numpy,
        gridmetrics_from_numpy,
        redi_operator_from_numpy,
    )

    shape, plane = dataset.umo.shape, dataset.umo.shape[1:]
    per_dir = {d: np.ones(plane) for d in ("east", "west", "north", "south")}
    legs = {leg: np.zeros(shape) for leg in P.StencilCoeffs._fields}
    fields = {name: np.zeros(plane if name in ("inv_de", "inv_dn") else shape)
              for name in P.RediOperator.__dataclass_fields__ if name not in ("wet", "topology")}
    return {
        "makegridmetrics": lambda **kw: P.makegridmetrics(**grid_kwargs(dataset), **kw),
        "dma_peak_probe": lambda **kw: P.dma_peak_probe(nstreams=1, mbytes=1, **kw),
        "coeffs_from_numpy": lambda **kw: coeffs_from_numpy(legs, **kw),
        "gridmetrics_from_numpy": lambda **kw: gridmetrics_from_numpy(
            area2d=np.ones(plane), v3d=np.ones(shape), thkcello=np.ones(shape),
            lon=np.zeros(plane), lat=np.zeros(plane), lon_vertices=np.zeros((4, *plane)),
            lat_vertices=np.zeros((4, *plane)), z3d=np.ones(shape), zt=np.ones(shape[0]),
            edge_length=per_dir, distance_to_edge=per_dir, distance_to_neighbour=per_dir,
            topology="bipolar", **kw),
        "redi_operator_from_numpy": lambda **kw: redi_operator_from_numpy(
            fields, dataset.wet3d, "bipolar", **kw),
    }


ENTRY_POINTS = ("makegridmetrics", "dma_peak_probe", "coeffs_from_numpy",
                "gridmetrics_from_numpy", "redi_operator_from_numpy")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_default_device_raises_without_cuda(dataset, monkeypatch, name):
    """device=None means the current CUDA device; without one the entry
    point raises and says to pass device="cpu", instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points(dataset)[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_cpu_runs_on_the_cpu(dataset, name):
    out = _entry_points(dataset)[name](device="cpu")
    if name == "dma_peak_probe":
        out = out[0]()  # the thunk's probe call
    values = (out,) if isinstance(out, torch.Tensor) else (
        out if isinstance(out, tuple) else tuple(vars(out).values()))
    tensors = [t for t in values if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
