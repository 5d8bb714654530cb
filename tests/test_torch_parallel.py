"""otmb_tpu_torch.parallel on the CPU: gloo ranks against the JAX package.

Ranks are spawned once per process-grid shape, (2, 2) and (1, 4), in a
module fixture. Each runs the port's sharded path on both topologies of
tests/test_sharding.py's 16x8x6 grid (seed 3): the apply and the
propagation (overlap off and on, one tracer and a batch), T' on shards, the
assembly (scalar and 3D rho, upwind and centred), Redi, the solves (forward
and transpose, BiCGStab(1) and (2)) and the refined ideal age and
sequestration time, and gathers the results. The main process holds them
against the JAX package's sharded functions on a virtual mesh of the same
shape (Pallas in interpret mode) and against its single-device functions,
with the JAX package's own tolerances (tests/test_sharding.py), and
against the port's single-device functions, exactly where the port is
exact. Every JAX import is inside a function: the ranks import this module
and never load JAX.

Also: the grid helpers (factorisation, peers, nx_dev = 2, an odd nx_dev
whose middle shard is its own fold partner, shard and gather as
inverses), and the engine's jitter parity on shards.
"""

import dataclasses

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.models.redi import _COEF_FIELDS
from otmb_tpu_torch.models.solvers import _jitter_rhat
from otmb_tpu_torch.parallel import (
    assemble_T_halo,
    euler_propagate_halo,
    euler_propagate_halo_multi,
    gather_field,
    redi_apply_halo,
    redi_shard,
    shard_field,
    shard_pytree,
    solve_shifted_halo,
    spawn_grid,
    stencil_apply_halo,
    stencil_apply_halo_multi,
    transpose_coeffs_halo,
)
from otmb_tpu_torch.parallel.mesh import ProcessGrid, _factor2d, all_reduce_sum
from otmb_tpu_torch.utils.convert import (
    coeffs_from_numpy,
    gridmetrics_from_numpy,
    redi_operator_from_numpy,
)

torch.set_num_threads(1)

KINDS = ("tripolar", "bipolar")
SHAPES = ((2, 2), (1, 4))
NX, NY, NZ = 16, 8, 6
DT, NSTEPS, BATCH = 250.0, 8, 3
SHIFT = 1e-4
SOLVES = [(alg, tr) for alg in ("bicgstab", "bicgstab2") for tr in (False, True)]
ASSEMBLY = [(rho3d, upwind) for rho3d in (False, True) for upwind in (True, False)]
# The JAX package's sharded assembly costs ~9 s a call in interpret mode:
# each (grid shape, topology) holds one variant against it, together all
# four (the JAX package holds its sharded assembly equal to its
# single-device one for all four, tests/test_sharding.py:497-533); every
# variant is held against its single-device one.
JAX_SHARDED_ASSEMBLY = {((2, 2), "tripolar"): (False, True), ((2, 2), "bipolar"): (True, False),
                        ((1, 4), "tripolar"): (False, False), ((1, 4), "bipolar"): (True, True)}
GM_FIELDS = ("area2d", "v3d", "thkcello", "lon", "lat", "lon_vertices", "lat_vertices",
             "z3d", "zt")


# ----------------------------------------------------------------------------
# Inputs: the JAX package's grid, operator and Redi operator, as numpy.


def _jax_case(kind, nx=NX):
    """The seeded case through the JAX package: its objects (for the main
    process) and their numpy fields (for the ranks)."""
    from otmb_tpu.grid.geometry import makegridmetrics
    from otmb_tpu.grid.indices import makeindices
    from otmb_tpu.models.redi import build_redi_operator
    from otmb_tpu.models.transport import transportmatrix
    from otmb_tpu.ops.fluxes import facefluxesfrommasstransport
    from otmb_tpu.utils.synthetic import synthetic_dataset

    ds = synthetic_dataset(nx=nx, ny=NY, nz=NZ, topology=kind, seed=3)
    gm = makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                         lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                         lat_vertices=ds.lat_vertices)
    idx = makeindices(gm.v3d)
    phi = facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    ops = transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx)
    wet = np.asarray(idx.wet3d)
    z, lon = np.asarray(gm.z3d), np.asarray(gm.lon)
    rho3d = np.where(wet, 1025.0 + 0.02 * z + 2e-4 * z * np.cos(2 * np.deg2rad(lon)), np.nan)
    op = build_redi_operator(rho3d, gm, idx.wet3d)
    rng = np.random.default_rng(13)
    surf = np.zeros(wet.shape)
    surf[0] = 1.0
    per_dir = lambda pd: {d: np.asarray(pd[d]) for d in ("east", "west", "north", "south")}
    data = dict(
        kind=kind, wet=wet, umo=np.asarray(ds.umo), vmo=np.asarray(ds.vmo),
        mlotst=np.asarray(ds.mlotst), rho3d=rho3d,
        legs={leg: np.asarray(ops.T[leg]) for leg in ops.T._fields},
        gm=dict({f: np.asarray(getattr(gm, f)) for f in GM_FIELDS},
                edge_length=per_dir(gm.edge_length),
                distance_to_edge=per_dir(gm.distance_to_edge),
                distance_to_neighbour=per_dir(gm.distance_to_neighbour)),
        redi={name: np.asarray(getattr(op, name)) for name in _COEF_FIELDS},
        chi=np.where(wet, rng.standard_normal(wet.shape), 0.0),
        chis=np.where(wet[None], rng.standard_normal((BATCH,) + wet.shape), 0.0),
        b=np.where(wet, rng.standard_normal(wet.shape), 0.0),
        surf=np.where(wet, surf, 0.0),
    )
    return dict(ds=ds, gm=gm, idx=idx, T=ops.T, op=op), data


def _port_objects(data):
    """The port's grid, operator and Redi operator from the numpy fields."""
    gm = gridmetrics_from_numpy(**data["gm"], topology=data["kind"], device="cpu")
    T = coeffs_from_numpy(data["legs"], device="cpu")
    R = redi_operator_from_numpy(data["redi"], data["wet"], data["kind"], device="cpu")
    return gm, T, R


# ----------------------------------------------------------------------------
# The ranks.


def _builds(grid, fn):
    """fn() on this rank, with its `_system` and `tridiag_factor` calls
    counted: (fn's result, [systems, factors] summed over the ranks)."""
    counts = [0, 0]
    real = S._system, S.tridiag_factor

    def counted(i):
        def wrapped(*args, **kwargs):
            counts[i] += 1
            return real[i](*args, **kwargs)
        return wrapped

    S._system, S.tridiag_factor = counted(0), counted(1)
    try:
        out = fn()
    finally:
        S._system, S.tridiag_factor = real
    return out, all_reduce_sum(torch.tensor(counts), grid).tolist()


def _rank_case(grid, data):
    """The port's sharded path on this rank for one case; gathered results."""
    gm, T, R = _port_objects(data)
    topo = gm.topology
    t = lambda name: torch.from_numpy(data[name])
    sh = lambda x: shard_pytree(x, grid, topo.shape2d)
    g = lambda x: gather_field(x, grid).numpy()
    chi, chis, b, surf = t("chi"), t("chis"), t("b"), t("surf")
    out = {}
    for ov in (False, True):
        out["apply", ov] = g(stencil_apply_halo(sh(T), sh(chi), topo, grid, overlap=ov))
        out["apply_multi", ov] = g(stencil_apply_halo_multi(sh(T), sh(chis), topo, grid,
                                                            overlap=ov))
        out["prop", ov] = g(euler_propagate_halo(sh(T), sh(chi), DT, NSTEPS, topo, grid,
                                                 overlap=ov))
        out["prop_multi", ov] = g(euler_propagate_halo_multi(sh(T), sh(chis), DT, NSTEPS, topo,
                                                             grid, overlap=ov))
    out["transpose"] = np.stack([g(leg) for leg in transpose_coeffs_halo(sh(T), topo, grid)])
    gms = sh(gm)
    for rho3d, upwind in ASSEMBLY:
        legs = assemble_T_halo(sh(t("umo")), sh(t("vmo")), sh(t("mlotst")), gms, grid,
                               rho=sh(t("rho3d")) if rho3d else 1035.0, upwind=upwind)
        out["assemble", rho3d, upwind] = np.stack([g(leg) for leg in legs])
    out["redi"] = g(redi_apply_halo(redi_shard(sh(R), grid), sh(chi), grid))
    for alg, tr in SOLVES:
        stats = {}
        x, res = solve_shifted_halo(sh(T), sh(b), topo, grid, shift=SHIFT, extra_diag=sh(surf),
                                    tol=1e-10, chunk=20, transpose=tr, algorithm=alg,
                                    stats=stats)
        out["solve", alg, tr] = (g(x), res, stats["stop"], stats["iters"])
    wet = torch.from_numpy(data["wet"])
    T32 = T.to(torch.float32)
    stats = {}
    (age, res), out["builds", "age"] = _builds(grid, lambda: P.ideal_age(
        sh(T32), sh(wet), topo, tol=1e-9, refine=True, grid=grid, stats=stats))
    out["age"] = (g(age), res)
    out["passes", "age"] = len(stats["passes"])
    stats = {}
    (seq, res), out["builds", "seq"] = _builds(grid, lambda: P.sequestration_time(
        sh(T32), sh(wet), topo, tol=1e-9, refine=True, grid=grid, algorithm="bicgstab2",
        stats=stats))
    out["seq"] = (g(seq), res)
    out["passes", "seq"] = len(stats["passes"])
    out["roundtrip"] = all(torch.equal(gather_field(shard_field(x, grid), grid), x)
                           for x in (chi, chis, wet, gm.lon, gm.lon_vertices, T.east))
    return out


def _rank_main(grid, cases):
    out = {data["kind"]: _rank_case(grid, data) for data in cases}
    return out if grid.rank == 0 else None


def _rank_odd(grid, data):
    """An odd nx_dev: the middle shard of the top row is its own fold
    partner. The sharded apply, propagation, T', Redi and assembly against
    the port's single-device path."""
    gm, T, R = _port_objects(data)
    topo = gm.topology
    sh = lambda x: shard_pytree(x, grid, topo.shape2d)
    g = lambda x: gather_field(x, grid)
    chi = torch.from_numpy(data["chi"])
    legs = assemble_T_halo(sh(torch.from_numpy(data["umo"])), sh(torch.from_numpy(data["vmo"])),
                           sh(torch.from_numpy(data["mlotst"])), sh(gm), grid)
    ref_legs = P.assemble_T(data["umo"], data["vmo"], data["mlotst"], gm)
    return {
        "apply": torch.equal(g(stencil_apply_halo(sh(T), sh(chi), topo, grid)),
                             P.apply_stencil(T, chi, topo)),
        "prop": torch.equal(g(euler_propagate_halo(sh(T), sh(chi), DT, NSTEPS, topo, grid,
                                                   overlap=False)),
                            P.euler_propagate(T, chi, DT, NSTEPS, topo)),
        "transpose": all(torch.equal(g(a), b) for a, b in
                         zip(transpose_coeffs_halo(sh(T), topo, grid),
                             P.transpose_coeffs(T, topo))),
        "redi": torch.equal(g(redi_apply_halo(sh(R), sh(chi), grid)), P.redi_apply(R, chi)),
        "assemble": max(float((g(a) - b).abs().max() / b.abs().max())
                        for a, b in zip(legs, ref_legs)),
    }


# ----------------------------------------------------------------------------
# Fixtures.


@pytest.fixture(scope="module")
def cases():
    return {kind: _jax_case(kind) for kind in KINDS}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def port(request, cases):
    """One spawn of gloo ranks per grid shape; rank 0's gathered results."""
    shape = request.param
    out = spawn_grid(_rank_main, shape, ([data for _, data in cases.values()],),
                     device="cpu", timeout_s=600)[0]
    return shape, out


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from otmb_tpu.parallel.mesh import make_grid_mesh

    return {shape: make_grid_mesh(jax.devices()[:4], shape) for shape in SHAPES}


def _sharded(mesh, x):
    import jax
    from otmb_tpu.parallel.mesh import sharding_for

    return jax.device_put(x, sharding_for(mesh, x))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _port_single(data):
    gm, T, R = _port_objects(data)
    return gm, gm.topology, T, R


# ----------------------------------------------------------------------------
# The sharded path against both packages.


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("overlap", [False, True])
def test_apply(port, cases, jax_mesh, kind, overlap):
    from otmb_tpu.ops.apply import apply_stencil
    from otmb_tpu.parallel.halo_pallas import apply_stencil_halo_pallas

    shape, out = port
    jx, data = cases[kind]
    got = out[kind]["apply", overlap]
    _, topo, T, _ = _port_single(data)
    mine = P.apply_stencil(T, torch.from_numpy(data["chi"]), topo).numpy()
    mesh = jax_mesh[shape]
    theirs = apply_stencil_halo_pallas(shard_jax(mesh, jx["T"]), _sharded(mesh, data["chi"]),
                                       jx["gm"].topology, mesh, interpret=True, overlap=overlap)
    single = apply_stencil(jx["T"], data["chi"], jx["gm"].topology)
    if overlap:  # the edge cells' sums in another order (test_sharding.py:210-213)
        _close(got, mine, 1e-12, 1e-13, "port single")
    else:  # K7's plain version is apply_stencil's arithmetic
        np.testing.assert_array_equal(got, mine)
    _close(got, theirs, 1e-12, 1e-12, "JAX sharded")
    _close(got, single, 1e-12, 1e-12, "JAX single")


def shard_jax(mesh, tree):
    from otmb_tpu.parallel.mesh import shard_pytree as jax_shard_pytree

    return jax_shard_pytree(mesh, tree)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("overlap", [False, True])
def test_apply_multi(port, cases, jax_mesh, kind, overlap):
    import jax
    from otmb_tpu.parallel.halo_pallas import apply_stencil_halo_pallas_multi

    shape, out = port
    jx, data = cases[kind]
    got = out[kind]["apply_multi", overlap]
    _, topo, T, _ = _port_single(data)
    mine = P.apply_stencil(T, torch.from_numpy(data["chis"]), topo).numpy()
    mesh = jax_mesh[shape]
    chis = jax.device_put(data["chis"], jax.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, None, "y", "x")))
    theirs = apply_stencil_halo_pallas_multi(shard_jax(mesh, jx["T"]), chis, jx["gm"].topology,
                                             mesh, interpret=True, overlap=overlap)
    if overlap:
        _close(got, mine, 1e-12, 1e-13, "port single")
    else:  # each member as K7 on one tracer, and as the plain apply
        np.testing.assert_array_equal(got, mine)
    _close(got, theirs, 1e-12, 1e-12, "JAX sharded")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("overlap", [False, True])
def test_propagate(port, cases, jax_mesh, kind, overlap):
    from otmb_tpu.models.solvers import explicit_euler_propagate
    from otmb_tpu.parallel.halo_pallas import euler_propagate_halo_pallas

    shape, out = port
    jx, data = cases[kind]
    got = out[kind]["prop", overlap]
    _, topo, T, _ = _port_single(data)
    mine = P.euler_propagate(T, torch.from_numpy(data["chi"]), DT, NSTEPS, topo).numpy()
    mesh = jax_mesh[shape]
    topo_j = jx["gm"].topology
    theirs = euler_propagate_halo_pallas(shard_jax(mesh, jx["T"]), _sharded(mesh, data["chi"]),
                                         DT, NSTEPS, topo_j, mesh, interpret=True,
                                         overlap=overlap)
    single = explicit_euler_propagate(jx["T"], data["chi"], DT, NSTEPS, topo_j)
    if overlap:  # tests/test_sharding.py:202-205
        _close(got, mine, 1e-11, 1e-11, "port single")
    else:
        np.testing.assert_array_equal(got, mine)
    _close(got, theirs, 1e-11, 1e-11, "JAX sharded")
    _close(got, single, 1e-11, 1e-11, "JAX single")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("overlap", [False, True])
def test_propagate_multi(port, cases, jax_mesh, kind, overlap):
    import jax
    from otmb_tpu.parallel.halo_pallas import euler_propagate_halo_pallas_multi

    shape, out = port
    jx, data = cases[kind]
    got = out[kind]["prop_multi", overlap]
    _, topo, T, _ = _port_single(data)
    mine = P.euler_propagate_multi(T, torch.from_numpy(data["chis"]), DT, NSTEPS, topo).numpy()
    mesh = jax_mesh[shape]
    chis = jax.device_put(data["chis"], jax.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, None, "y", "x")))
    theirs = euler_propagate_halo_pallas_multi(shard_jax(mesh, jx["T"]), chis, DT, NSTEPS,
                                               jx["gm"].topology, mesh, interpret=True,
                                               overlap=overlap)
    if overlap:
        _close(got, mine, 1e-11, 1e-11, "port single")
    else:
        np.testing.assert_array_equal(got, mine)
    _close(got, theirs, 1e-11, 1e-11, "JAX sharded")


@pytest.mark.parametrize("kind", KINDS)
def test_transpose_coeffs(port, cases, kind):
    """T' on shards is the slice of the whole field's T', bit for bit."""
    _, out = port
    _, data = cases[kind]
    _, topo, T, _ = _port_single(data)
    want = np.stack([leg.numpy() for leg in P.transpose_coeffs(T, topo)])
    np.testing.assert_array_equal(out[kind]["transpose"], want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rho3d,upwind", ASSEMBLY,
                         ids=[f"{'rho3d' if r else 'rho'}-{'upwind' if u else 'centred'}"
                              for r, u in ASSEMBLY])
def test_assembly(port, cases, jax_mesh, kind, rho3d, upwind):
    """The sharded assembly against JAX's Pallas assembly (single device; and
    sharded for one variant per grid shape and topology) and the port's single-device
    plain assembly, which forms masses and face areas in another order."""
    from otmb_tpu.ops.assemble_pallas import assemble_T_pallas
    from otmb_tpu.parallel.assemble_halo import assemble_T_halo_pallas

    shape, out = port
    jx, data = cases[kind]
    got = out[kind]["assemble", rho3d, upwind]
    rho = data["rho3d"] if rho3d else 1035.0
    ds, gm = jx["ds"], jx["gm"]
    single = assemble_T_pallas(ds.umo, ds.vmo, ds.mlotst, gm, rho=rho, upwind=upwind,
                               interpret=True)
    pgm, _, _, _ = _port_single(data)
    mine = P.assemble_T(data["umo"], data["vmo"], data["mlotst"], pgm,
                        rho=torch.from_numpy(data["rho3d"]) if rho3d else rho, upwind=upwind)
    legs = list(single._fields)
    for n, leg in enumerate(legs):
        scale = float(np.abs(np.asarray(single[leg])).max())
        _close(got[n], single[leg], 0, 1e-13 * scale, f"JAX single {leg}")
        _close(got[n], mine[leg].numpy(), 0, 1e-13 * scale, f"port single {leg}")
    if JAX_SHARDED_ASSEMBLY[shape, kind] == (rho3d, upwind):
        mesh = jax_mesh[shape]
        args = [_sharded(mesh, np.asarray(a)) for a in (ds.umo, ds.vmo, ds.mlotst)]
        theirs = assemble_T_halo_pallas(*args, shard_jax(mesh, gm), mesh, rho=rho,
                                        upwind=upwind, interpret=True)
        for n, leg in enumerate(legs):
            scale = float(np.abs(np.asarray(theirs[leg])).max())
            _close(got[n], theirs[leg], 0, 1e-13 * scale, f"JAX sharded {leg}")


@pytest.mark.parametrize("kind", KINDS)
def test_redi(port, cases, jax_mesh, kind):
    from otmb_tpu.models.redi import redi_apply
    from otmb_tpu.parallel.redi_halo import redi_apply_halo_pallas

    shape, out = port
    jx, data = cases[kind]
    got = out[kind]["redi"]
    _, _, _, R = _port_single(data)
    np.testing.assert_array_equal(got, P.redi_apply(R, torch.from_numpy(data["chi"])).numpy())
    mesh = jax_mesh[shape]
    theirs = redi_apply_halo_pallas(shard_jax(mesh, jx["op"]), _sharded(mesh, data["chi"]),
                                    mesh, interpret=True)
    _close(got, theirs, 1e-13, 1e-20, "JAX sharded")  # tests/test_sharding.py:581-582
    _close(got, redi_apply(jx["op"], data["chi"]), 1e-12, 1e-13, "JAX single")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("algorithm,transpose", SOLVES,
                         ids=[f"{a}-{'transpose' if t else 'forward'}" for a, t in SOLVES])
def test_solve(port, cases, jax_mesh, kind, algorithm, transpose):
    """The sharded engine against the JAX package's sharded chunked engine
    and its single-device solve (tests/test_sharding.py:726-744)."""
    from otmb_tpu.models.solvers import solve_shifted
    from otmb_tpu.parallel.solve_halo_chunked import solve_shifted_halo_chunked

    shape, out = port
    jx, data = cases[kind]
    x, res, stop, iters = out[kind]["solve", algorithm, transpose]
    assert res < 1e-8 and stop == "converged" and 0 < iters <= 2000
    wet = data["wet"]
    topo = jx["gm"].topology
    ref, _ = solve_shifted(jx["T"], data["b"], topo, shift=SHIFT, extra_diag=data["surf"],
                           tol=1e-11, transpose=transpose)
    mesh = jax_mesh[shape]
    theirs, res_j = solve_shifted_halo_chunked(
        shard_jax(mesh, jx["T"]), _sharded(mesh, data["b"]), topo, mesh, shift=SHIFT,
        extra_diag=_sharded(mesh, data["surf"]), tol=1e-10, chunk=20, transpose=transpose,
        algorithm=algorithm)
    assert float(res_j) < 1e-8
    _close(x[wet], np.asarray(ref)[wet], 1e-5, 1e-7, "JAX single")
    _close(x[wet], np.asarray(theirs)[wet], 1e-5, 1e-7, "JAX sharded")


@pytest.mark.parametrize("kind", KINDS)
def test_refined_age(port, cases, jax_mesh, kind):
    """ideal_age(grid=) with f32 inner solves and f64 defects on shards,
    against the JAX package's refined mesh solve and its f64 solve
    (tests/test_sharding.py:463-494)."""
    import jax
    from otmb_tpu.models.solvers import ideal_age

    shape, out = port
    jx, data = cases[kind]
    age, res = out[kind]["age"]
    wet = data["wet"]
    assert res < 1e-9
    assert np.isnan(age[~wet]).all() and (age[wet] > 0).all()
    topo = jx["gm"].topology
    ref, _ = ideal_age(jx["T"], jx["idx"].wet3d, topo, tol=1e-11)
    mesh = jax_mesh[shape]
    c32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), jx["T"])
    theirs, res_j = ideal_age(shard_jax(mesh, c32), _sharded(mesh, wet), topo, tol=1e-9,
                              refine=True, apply_impl="pallas", mesh=mesh)
    assert float(res_j) < 1e-9
    _close(age[wet], np.asarray(ref)[wet], 1e-3, 1.0, "JAX f64")
    _close(age[wet], np.asarray(theirs)[wet], 1e-3, 1.0, "JAX sharded refined")


@pytest.mark.parametrize("kind", KINDS)
def test_refined_sequestration(port, cases, kind):
    """sequestration_time(grid=), refined with BiCGStab(2) inner solves on
    T' of the shards, against the JAX package's f64 sequestration time."""
    from otmb_tpu.models.solvers import sequestration_time

    _, out = port
    jx, data = cases[kind]
    seq, res = out[kind]["seq"]
    wet = data["wet"]
    assert res < 1e-9
    ref, _ = sequestration_time(jx["T"], jx["idx"].wet3d, jx["gm"].topology, tol=1e-11)
    _close(seq[wet], np.asarray(ref)[wet], 1e-3, 1.0, "JAX f64")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("solve", ["age", "seq"])
def test_a_sharded_refinement_builds_one_system(port, kind, solve):
    """A refined solve on a process grid builds one system and one Thomas
    factor on each rank, which its passes share, and its f64 defects use
    the same shard field."""
    shape, out = port
    ranks = shape[0] * shape[1]
    assert out[kind]["passes", solve] >= 2
    assert out[kind]["builds", solve] == [ranks, ranks]


def test_shard_and_gather_are_inverses(port):
    _, out = port
    assert all(out[kind]["roundtrip"] for kind in KINDS)


def test_odd_nx_dev_self_mirror():
    """(1, 3) on an 18x8x6 tripolar grid: the middle shard of the top row is
    its own fold partner and sends itself nothing; every sharded result
    equals the port's single-device one (the assembly to rounding)."""
    _, data = _jax_case("tripolar", nx=18)
    out = spawn_grid(_rank_odd, (1, 3), (data,), device="cpu", timeout_s=300)
    for r in out:
        assert r["apply"] and r["prop"] and r["transpose"] and r["redi"], r
        assert r["assemble"] <= 1e-13, r


def _rank_device(grid):
    return str(grid.device)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_ranks_default_to_the_card():
    """A grid made without `device=` is on the current CUDA device under
    gloo too, so without a card its ranks raise rather than run on the
    host; `device="cpu"` puts them there."""
    with pytest.raises(Exception, match="no CUDA device"):
        spawn_grid(_rank_device, (1, 1), timeout_s=120)
    assert spawn_grid(_rank_device, (1, 2), device="cpu", timeout_s=120) == ["cpu", "cpu"]


# ----------------------------------------------------------------------------
# The grid helpers, without ranks.


def test_factor2d():
    assert [_factor2d(n) for n in (1, 2, 4, 6, 8, 12, 7)] == [
        (1, 1), (1, 2), (2, 2), (2, 3), (2, 4), (3, 4), (1, 7)]


def test_peers_of_a_2x4_grid():
    g = lambda r: ProcessGrid((2, 4), r, torch.device("cpu"), "gloo")
    # x innermost, periodic in x, open in y, mirror (y, nx_dev - 1 - x)
    assert (g(0).y, g(0).x, g(5).y, g(5).x) == (0, 0, 1, 1)
    assert (g(0).east, g(0).west, g(3).east, g(4).west) == (1, 3, 0, 7)
    assert (g(1).north, g(1).south, g(5).north, g(5).south) == (5, None, None, 1)
    assert [g(r).mirror for r in range(4, 8)] == [7, 6, 5, 4]
    assert not g(0).is_top and g(4).is_top
    assert g(6).offset(8, 16) == (4, 8) and g(6).local_shape(8, 16) == (4, 4)
    with pytest.raises(ValueError):
        g(0).local_shape(9, 16)


def test_peers_two_columns_and_odd_columns():
    two = ProcessGrid((1, 2), 0, torch.device("cpu"), "gloo")
    assert two.east == two.west == two.mirror == 1  # one peer both ways
    odd = [ProcessGrid((1, 3), r, torch.device("cpu"), "gloo") for r in range(3)]
    assert [p.mirror for p in odd] == [2, 1, 0]  # the middle shard mirrors itself
    one = ProcessGrid((2, 1), 1, torch.device("cpu"), "gloo")
    assert one.east == one.west == one.mirror == 1 and one.south == 0
    assert not ProcessGrid((1, 4), 0, torch.device("cuda", 0), "nccl").host_staged
    assert ProcessGrid((1, 4), 0, torch.device("cuda", 0), "gloo").host_staged


def test_shard_pytree_keeps_the_global_topology():
    ds = P.synthetic_dataset(nx=NX, ny=NY, nz=NZ, topology="tripolar", seed=3)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    g = ProcessGrid((2, 2), 3, torch.device("cpu"), "gloo")
    s = shard_pytree(gm, g, gm.topology.shape2d)
    assert s.topology == gm.topology and torch.equal(s.zt, gm.zt)
    for got, want in ((s.v3d, gm.v3d[:, 4:, 8:]), (s.area2d, gm.area2d[4:, 8:])):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(s.lon_vertices, gm.lon_vertices[:, 4:, 8:])
    assert torch.equal(s.edge_length.north, gm.edge_length.north[4:, 8:])
    assert dataclasses.is_dataclass(s) and s.v3d.is_contiguous()


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4), (1, 3)])
def test_jitter_parity_on_shards(shape):
    """A jittered shadow vector built on a shard (with its global offset) is
    the slice of the one built on the whole field, for every jitter axis:
    the shards here start at odd j and i."""
    nz, ny, nx = 4, 5 * shape[0], 9 * shape[1]
    r = torch.from_numpy(np.random.default_rng(2).standard_normal((nz, ny, nx)))
    for jitter in (1, 2, 3, 4):
        whole = _jitter_rhat(r, jitter)
        for rank in range(shape[0] * shape[1]):
            g = ProcessGrid(shape, rank, torch.device("cpu"), "gloo")
            (j0, i0), (ny_l, nx_l) = g.offset(ny, nx), g.local_shape(ny, nx)
            part = _jitter_rhat(r[:, j0:j0 + ny_l, i0:i0 + nx_l], jitter, (j0, i0))
            assert torch.equal(part, whole[:, j0:j0 + ny_l, i0:i0 + nx_l]), (jitter, rank)
    # on one device the offset is 0 and nothing changes
    assert torch.equal(_jitter_rhat(r, 2, (0, 0)), _jitter_rhat(r, 2))
