"""`synthetic_device_case`, the benchmark's case generator, against the JAX
package's at 24x16x8 (seed 0, f64, both topologies): the wet mask and the
topology equal, every 3D field, mlotst and the 2D metrics within 1e-12 of
each array's largest value, NaN on the same cells; the port's plain
assembly on it against `assemble_transport` on the JAX case; its grid
against `synthetic_dataset` + `makegridmetrics`; and its rules: only
O(ny * nx) host arrays cross to the device, and without `device=` it needs
a CUDA device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.models.transport import assemble_transport as jax_assemble_transport
from otmb_tpu.utils.synthetic import synthetic_device_case as jax_synthetic_device_case

torch.set_num_threads(1)

NX, NY, NZ = 24, 16, 8
RTOL = 1e-12
FIELDS_3D = ("v3d", "thkcello", "z3d")
FIELDS_2D = ("area2d", "lon", "lat", "lon_vertices", "lat_vertices", "zt")
PER_DIRECTION = ("edge_length", "distance_to_edge", "distance_to_neighbour")
DIRECTIONS = ("east", "west", "north", "south")


@pytest.fixture(scope="module", params=["tripolar", "bipolar"])
def cases(request):
    want = jax_synthetic_device_case(NX, NY, NZ, topology=request.param, dtype=jnp.float64,
                                     seed=0)
    got = P.synthetic_device_case(NX, NY, NZ, topology=request.param, dtype=torch.float64,
                                  seed=0, device="cpu")
    return got, want


def _close(got: torch.Tensor, want, what: str):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.nanmax(np.abs(want)),
                               equal_nan=True, err_msg=what)


def test_wet_and_topology_equal(cases):
    (gm, wet, *_), (jgm, jwet, *_) = cases
    np.testing.assert_array_equal(wet.numpy(), np.asarray(jwet))
    assert gm.topology.kind == jgm.topology.kind
    assert gm.topology.shape3d == (NZ, NY, NX) == tuple(jgm.topology.shape3d)


@pytest.mark.parametrize("name", ("umo", "vmo", "mlotst") + FIELDS_3D)
def test_fields(cases, name):
    (gm, _, umo, vmo, mlotst), (jgm, _, jumo, jvmo, jmlotst) = cases
    own = dict(umo=(umo, jumo), vmo=(vmo, jvmo), mlotst=(mlotst, jmlotst))
    got, want = own[name] if name in own else (getattr(gm, name), getattr(jgm, name))
    _close(got, want, name)


@pytest.mark.parametrize("name", FIELDS_2D + PER_DIRECTION)
def test_metrics(cases, name):
    (gm, *_), (jgm, *_) = cases
    if name in PER_DIRECTION:
        for d in DIRECTIONS:
            _close(getattr(gm, name)[d], getattr(jgm, name)[d], f"{name}.{d}")
    else:
        _close(getattr(gm, name), getattr(jgm, name), name)


def test_assembly_matches(cases):
    """The port's plain assembly on the port's case against the JAX
    package's `assemble_transport` on the JAX case, every operator and leg."""
    (gm, wet, umo, vmo, mlotst), (jgm, jwet, jumo, jvmo, jmlotst) = cases
    got = P.assemble_transport(umo, vmo, mlotst, gm, wet)
    want = jax_assemble_transport(jumo, jvmo, jmlotst, jgm, jwet)
    for op in ("T", "Tadv", "TkH", "TkVML", "TkVdeep"):
        for leg in P.StencilCoeffs._fields:
            _close(getattr(getattr(got, op), leg), getattr(getattr(want, op), leg),
                   f"{op}.{leg}")


def test_grid_matches_the_host_dataset(cases):
    """The wet mask equals `synthetic_dataset`'s for the same seed (its
    first draws are the seafloor's), and the volumes and depths equal
    `makegridmetrics`'s on it."""
    (gm, wet, *_), _ = cases
    ds = P.synthetic_dataset(NX, NY, NZ, topology=gm.topology.kind, seed=0)
    host = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                             lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                             lat_vertices=ds.lat_vertices, device="cpu")
    np.testing.assert_array_equal(wet.numpy(), ds.wet3d)
    for name in ("v3d", "z3d", "area2d"):
        _close(getattr(gm, name), getattr(host, name).numpy(), name)


def test_only_2d_host_arrays_cross(monkeypatch):
    """Every host array the generator hands to torch holds at most
    4 * ny * nx values (the vertices): no (nz, ny, nx) field is made on the
    host."""
    sizes = []
    as_tensor = torch.as_tensor

    def spy(data, *args, **kwargs):
        sizes.append(np.size(data))
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", spy)
    P.synthetic_device_case(NX, NY, 3 * NZ, device="cpu")
    assert sizes and max(sizes) <= 4 * NY * NX


def test_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.synthetic_device_case(NX, NY, NZ)
    with pytest.raises(ValueError, match="even"):
        P.synthetic_device_case(NX + 1, NY, NZ, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        P.synthetic_device_case(NX, NY, NZ, topology="dipolar", device="cpu")
