"""The sharded stencil's flat halo buffers and the assembly's preparation,
in one process on the CPU (no messages).

  * `HaloExchange` and the plain pack (`halo._pack_plain`, K7's pack on a
    CPU tensor): the flat send buffer holds `_halo_lines` line for line, in
    that order, on every shard of grids with a bottom, middle and top shard
    row, on both topologies, for one tracer and a batch; the halos K7 reads
    are views of the receive buffer, of the send buffer where a shard is its
    own neighbour, and None where no neighbour exists.
  * The plain edge entry (`halo_kernel._edge` on a CPU tensor, that is
    `halo._boundary_patch`) reading from a filled receive buffer equals
    `_boundary_patch` on the lines `halo._exchange` delivers (zeros for a
    missing neighbour) bit for bit; and the bulk on null halos plus the
    edge equals the stencil on the true halos to rounding (1e-12 of max,
    f64: only the order of the edge cells' sums differs).
  * `ops.assemble._residents` and `_levels` (the prep entry's plain version)
    against the JAX package's `_prep_kpack_residents` in f64 on the same
    seeded grid, bit for bit: both evaluate the same IEEE operations.
"""

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.ops.assemble import _levels, _residents
from otmb_tpu_torch.ops.coeffs import StencilCoeffs
from otmb_tpu_torch.parallel import halo, halo_kernel
from otmb_tpu_torch.parallel.mesh import ProcessGrid

torch.set_num_threads(1)

KINDS = ("tripolar", "bipolar")
# (ny_dev, nx_dev) on the 16x8 grid: bottom, middle and top shard rows; one
# grid column (a shard is its own x neighbour); an odd nx_dev (the middle
# shard is its own fold partner)
SHAPES = ((4, 2), (2, 1), (1, 4), (2, 2), (4, 1))
ODD_SHAPES = ((1, 3), (2, 3))  # on a 12-wide grid
NX, NY, NZ, BATCH = 16, 8, 6, 3
NX_ODD = 12
SIDES = ("east", "west", "north", "south")


def _case(kind, nx=NX, ny=NY, nz=NZ):
    ds = P.synthetic_dataset(nx=nx, ny=ny, nz=nz, topology=kind, seed=3)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    T = P.assemble_transport(ds.umo, ds.vmo, ds.mlotst, gm, idx.wet3d).T
    rng = np.random.default_rng(11)
    chis = torch.where(idx.wet3d, torch.from_numpy(rng.standard_normal((BATCH,) + gm.shape)), 0.0)
    return ds, gm, T, chis


def _shards(shape, ny, nx):
    for rank in range(shape[0] * shape[1]):
        g = ProcessGrid(shape, rank, torch.device("cpu"), "gloo")
        (j0, i0), (ny_l, nx_l) = g.offset(ny, nx), g.local_shape(ny, nx)
        yield g, lambda f, j0=j0, i0=i0, a=ny_l, b=nx_l: f[..., j0:j0 + a, i0:i0 + b].contiguous()


def _cut(f, g, topo, side):
    """The line of field `f` beyond shard `g`'s `side` (None where no
    neighbour exists)."""
    ny, nx = topo.ny, topo.nx
    (j0, i0), (ny_l, nx_l) = g.offset(ny, nx), g.local_shape(ny, nx)
    j1, i1 = j0 + ny_l, i0 + nx_l
    if side == "east":
        return f[..., j0:j1, i1 % nx].contiguous()
    if side == "west":
        return f[..., j0:j1, (i0 - 1) % nx].contiguous()
    if side == "south":
        return f[..., j0 - 1, i0:i1].contiguous() if j0 > 0 else None
    if j1 < ny:
        return f[..., j1, i0:i1].contiguous()
    if topo.is_tripolar:
        return torch.flip(f[..., ny - 1, nx - i1:nx - i0], dims=(-1,)).contiguous()
    return None


def _fill_recv(plan, lines):
    """Land `lines` (east, west, north, south; None: not received) in the
    plan's receive buffer, as the messages would."""
    for h, line in zip(plan.halos, lines):
        if line is not None and h is not None:
            h.copy_(line)


@pytest.mark.parametrize("batch", [False, True], ids=["field", "batch"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_pack_holds_halo_lines(kind, shape, batch):
    _, gm, _, chis = _case(kind)
    topo = gm.topology
    x = chis if batch else chis[0]
    for g, sl in _shards(shape, topo.ny, topo.nx):
        x_l = sl(x)
        plan = halo.HaloExchange(x_l, topo, g)
        plan.send.fill_(float("nan"))
        halo_kernel._pack(plan, x_l, topo)
        want = halo._halo_lines(x_l, topo)
        assert plan.fold == (topo.is_tripolar and g.is_top)
        assert len(plan.lines) == 4 + plan.fold
        flat = []
        for got, line in zip(plan.lines, want):
            torch.testing.assert_close(got, line, rtol=0, atol=0)
            flat.append(line.reshape(-1))
        torch.testing.assert_close(plan.send, torch.cat(flat), rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES + ODD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_halos_are_views_of_the_buffers(kind, shape):
    """Where each halo K7 reads comes from: the receive buffer, the send
    buffer (the shard is its own neighbour), or nowhere (None)."""
    _, gm, _, chis = _case(kind, nx=NX_ODD)
    topo = gm.topology
    for g, sl in _shards(shape, topo.ny, topo.nx):
        plan = halo.HaloExchange(sl(chis[0]), topo, g)
        east, west, north, south = plan.halos
        in_recv = lambda t: t is not None and t.untyped_storage().data_ptr() == \
            plan.recv.untyped_storage().data_ptr()
        assert (south is None) == (g.south is None)
        assert in_recv(south) or south is None
        if g.nx_dev > 1:
            assert in_recv(east) and in_recv(west)
        else:
            assert east.data_ptr() == plan.lines[0].data_ptr()  # its own west column
            assert west.data_ptr() == plan.lines[1].data_ptr()
        if g.north is not None:
            assert in_recv(north)
        elif not topo.is_tripolar:
            assert north is None
        elif g.mirror == g.rank:
            assert north.data_ptr() == plan.lines[4].data_ptr()  # its own fold line
        else:
            assert in_recv(north)


@pytest.mark.parametrize("dt", [None, 0.5], ids=["apply", "step"])
@pytest.mark.parametrize("batch", [False, True], ids=["field", "batch"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_edge_from_recv_buffer_equals_boundary_patch(kind, shape, batch, dt):
    _, gm, T, chis = _case(kind)
    topo = gm.topology
    x = chis if batch else chis[0]
    scale = 1.0 if dt is None else -dt / float(T.diag.abs().max())
    for g, sl in _shards(shape, topo.ny, topo.nx):
        T_l, x_l = StencilCoeffs(*(sl(leg) for leg in T)), sl(x)
        lines = tuple(_cut(x, g, topo, s) for s in SIDES)
        plan = halo.HaloExchange(x_l, topo, g)
        halo_kernel._pack(plan, x_l, topo)
        _fill_recv(plan, lines)
        for h, line in zip(plan.halos, lines):
            if line is None:
                assert h is None
            else:
                torch.testing.assert_close(h, line, rtol=0, atol=0)
        bulk = halo_kernel._bulk(T_l, x_l, halo_kernel._NO_HALOS, None)
        zeros = (torch.zeros_like(x_l[..., 0]), torch.zeros_like(x_l[..., 0]),
                 torch.zeros_like(x_l[..., 0, :]), torch.zeros_like(x_l[..., 0, :]))
        delivered = tuple(z if line is None else line for line, z in zip(lines, zeros))
        got = halo_kernel._edge(T_l, bulk.clone(), plan.halos, scale)
        want = halo._boundary_patch(T_l, bulk.clone(), delivered, scale)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if scale == 1.0:  # bulk plus edge is the stencil on the true halos, to rounding
            exact = halo._local_stencil(T_l, x_l, lines)
            err = float((got - exact).abs().max())
            assert err <= 1e-12 * float(exact.abs().max()), err


@pytest.mark.parametrize("kind", KINDS)
def test_residents_and_levels_equal_jax_prep(kind):
    from otmb_tpu.ops.assemble_pallas import _prep_kpack_residents

    ds, gm, _, _ = _case(kind, nx=18, ny=14, nz=6)
    ml = torch.as_tensor(ds.mlotst, dtype=torch.float64)
    kappas = (P.KAPPA_H_DEFAULT, P.KAPPA_VML_DEFAULT, P.KAPPA_VDEEP_DEFAULT)
    res = _residents(gm, ml, kappas[0])
    lev = _levels(gm.zt, kappas[1], kappas[2])
    n = lambda t: t.numpy()
    per_dir = lambda pd: {d: n(pd[d]) for d in SIDES}
    kpack, residents = _prep_kpack_residents(
        n(ml), n(gm.area2d), per_dir(gm.edge_length), per_dir(gm.distance_to_neighbour),
        n(gm.zt), np.dtype(np.float64), *kappas, gm.shape[0], gm.shape[2])
    np.testing.assert_array_equal(lev.numpy(), np.asarray(kpack)[:, :6, 0])
    assert len(residents) == res.shape[0]
    for got, want in zip(res.numpy(), residents):
        np.testing.assert_array_equal(got, np.asarray(want))
