"""The batched solve on a process grid, on the CPU: gloo ranks, spawned once
for the module on a (2, 2) grid, run `solve_shifted_multi(grid=)`,
`solve_shifted_chunked_multi(grid=, algorithm="bicgstab2")` and
`water_mass_fractions(grid=)` on their shards of the 16x8x6 sharding grid
(both topologies, T and T'), and each computes the single-device batched
results itself; the main process holds every shard to them and to the
JAX package's `solve_shifted_multi` on a (2, 2) mesh of the conftest's
virtual CPU devices (GSPMD over the jnp matvec, the inputs placed as its
multi-chip check places them, `__graft_entry__.py:308-318`).

The batched solves run in f64 to tol 1e-12 on a batch of random fields,
which the residual resolves: every solve lands within 1e-14 of the
converged solution, so the shards sit within TOL_TIGHT of each member's
largest value (`tests/test_torch_parallel_ad.py`'s bound). The band
dyes of `water_mass_fractions` at tol 1e-12 are not resolved in the
interior (the dye stopping rule, its docstring): on this grid the port's
single-device, its sharded and the JAX package's iterates all meet
1e-12 yet sit 2e-7 to 5e-5 of each member's largest value from the
converged partition, each in its own place. So the port solves the dyes
to tol 1e-14, where its iterates sit within 2e-10 of a direct solve of
the same system, and the JAX package's solve runs to tol 1e-17, below
its rounding floor (~1.5e-16), where its recurrence stops within 6e-10
of the direct solve (at tol 1e-14 it stops 4e-6 from it); all are held
at TOL_TIGHT; at tol 1e-6 the sharded fractions are held to the single-device ones at
the bound of the JAX package's own sharded batched check
(`__graft_entry__.py:319-327`), the check this one mirrors. The batched
residuals on a grid are
the whole field's (all-reduced), the same on every rank; a batch whose
members diverge takes its jittered restarts on the grid, whose shadow
vectors are slices of the whole field's.
"""

import warnings

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.parallel import gather_field, shard_pytree, spawn_grid

torch.set_num_threads(1)

KINDS = ("tripolar", "bipolar")
NX, NY, NZ = 16, 8, 6
SHAPE = (2, 2)
REGIONS = 3
TOL = 1e-12
TOL_TIGHT = 1e-8
# The band dyes converge at this tol (the dye stopping rule); the JAX
# package's solve of them converges only when asked for a tol below its
# rounding floor, where its recurrence runs until it stops.
TOL_DYE = 1e-14
TOL_DYE_JAX = 1e-17
# The JAX package's sharded batched check: its tol, and its bound against
# the single-device solve (__graft_entry__.py:292-327): rtol, and atol over
# each member's largest value.
TOL_REF = 1e-6
RTOL_DYE, ATOL_DYE = 1e-2, 1e-4
FRACTION_SLACK = 1e-3
SOLVES = ("multi", "chunked_multi")


def _case(kind):
    ds = P.synthetic_dataset(nx=NX, ny=NY, nz=NZ, topology=kind, seed=3)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    T = P.transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx).T
    return gm.topology, T, idx.wet3d


def _bands():
    masks = np.zeros((REGIONS, NY, NX), bool)
    for r in range(REGIONS):
        masks[r, r * NY // REGIONS:(r + 1) * NY // REGIONS] = True
    return masks


def _rhs(wet):
    """The band dyes' right-hand sides (R, nz, ny, nx) and the surface
    restoring diagonal."""
    surf = torch.where(wet & (torch.arange(NZ).view(-1, 1, 1) == 0), 1.0, 0.0).double()
    masks = torch.from_numpy(_bands())
    return torch.where(wet[None] & masks[:, None], surf[None], 0.0), surf


def _random(wet, seed, members=3):
    return torch.where(wet, torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (members,) + tuple(wet.shape))), 0.0)


def _skew(T, wet):
    """The exactly skew f32 operator of tests/test_torch_chunked.py: BiCGStab
    goes non-finite in its first chunk."""
    w = wet.double()
    z = torch.zeros_like(T.diag)
    return T._replace(diag=z, east=z + w, west=z - w, north=z, south=z, top=z,
                      bottom=z).to(torch.float32)


def _direct(T, topo, bs, surf, wet):
    """The dyes by a dense direct solve of (T + M) x = b on the wet cells."""
    n = wet.numel()
    eye = torch.eye(n, dtype=torch.float64).reshape((n,) + tuple(wet.shape))
    A = (P.apply_stencil(T, eye, topo) + surf * eye).reshape(n, n).T
    w = wet.reshape(-1)
    x = torch.full((len(bs), n), torch.nan, dtype=torch.float64)
    x[:, w] = torch.linalg.solve(A[w][:, w], bs.reshape(len(bs), n)[:, w].T).T
    return x.reshape(bs.shape)


def _residuals(T, xs, bs, surf, topo, transpose):
    """||A x_b - b_b|| / ||b_b|| on the whole field, in f64."""
    A = P.transpose_coeffs(T, topo) if transpose else T
    r = P.apply_stencil(A, xs, topo) + surf * xs - bs
    return (torch.linalg.vector_norm(r.flatten(1), dim=1)
            / torch.linalg.vector_norm(bs.flatten(1), dim=1))


def _rank(grid):
    out = {}
    for kind in KINDS:
        topo, T, wet = _case(kind)
        sh = lambda x: shard_pytree(x, grid, topo.shape2d)
        _, surf = _rhs(wet)
        bs = _random(wet, 7)
        for transpose in (False, True):
            kw = dict(extra_diag=surf, tol=TOL, transpose=transpose)
            kw_l = dict(kw, extra_diag=sh(surf), grid=grid)
            for name, solve, extra in (
                    ("multi", P.solve_shifted_multi, {}),
                    ("chunked_multi", P.solve_shifted_chunked_multi,
                     {"algorithm": "bicgstab2"})):
                xs, res = solve(T, bs, topo, **kw, **extra)
                stats = {}
                xs_l, res_l = solve(sh(T), sh(bs), topo, stats=stats, **kw_l, **extra)
                out[kind, name, transpose] = dict(x=gather_field(xs_l, grid), res=res_l, ref=xs,
                                                  ref_res=res, stats=stats)
                # cut after two matvec pairs, far above the rounding floor:
                # the returned residuals against the whole field's
                xs_l, res_l = solve(sh(T), sh(bs), topo, maxiter=2, **kw_l, **extra)
                out[kind, name, transpose].update(loose=res_l, recomputed=_residuals(
                    T, gather_field(xs_l, grid), bs, surf, topo, transpose))
        # the fractions with the global masks, sliced on each rank: converged,
        # and at the tol of the JAX package's own sharded check
        for key, tol in (("fractions", TOL_DYE), ("fractions_ref_tol", TOL_REF)):
            fr, res = P.water_mass_fractions(T, wet, topo, _bands(), tol=tol)
            fr_l, res_l = P.water_mass_fractions(sh(T), sh(wet), topo, _bands(), tol=tol,
                                                 grid=grid)
            out[kind, key] = dict(x=gather_field(fr_l, grid), res=res_l, ref=fr, ref_res=res)
        # a batch whose members diverge: jittered restarts on the grid
        b2 = _random(wet, 5, 2).float()
        skw = dict(tol=1e-6, chunk=10, maxiter=200, max_restarts=0, early_stop=False,
                   max_diverge_restarts=2)
        st, st_l = {}, {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, res = P.solve_shifted_chunked_multi(_skew(T, wet), b2, topo, stats=st, **skw)
            _, res_l = P.solve_shifted_chunked_multi(sh(_skew(T, wet)), sh(b2), topo, stats=st_l,
                                                     grid=grid, **skw)
        jitter = max(float((S._jitter_rhat(sh(b2), j, grid.offset(NY, NX))
                            - sh(S._jitter_rhat(b2, j))).abs().max()) for j in range(1, 6))
        out[kind, "diverge"] = dict(res=res_l, ref_res=res, stats=st_l, ref_stats=st,
                                    jitter=jitter)
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_grid(_rank, SHAPE, device="cpu", timeout_s=600)


def _gap(got, ref):
    """max |got - ref| of each member, over its largest |ref| (wet cells)."""
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), finite)
    d = torch.where(finite, got - ref, 0.0).flatten(1).abs().max(dim=1).values
    scale = torch.where(finite, ref, 0.0).flatten(1).abs().max(dim=1).values
    return d / scale


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("solve", SOLVES)
def test_sharded_batch_matches_single_device(ranks, kind, transpose, solve):
    for out in ranks:
        r = out[kind, solve, transpose]
        assert float(r["res"].max()) <= TOL and float(r["ref_res"].max()) <= TOL
        assert r["stats"]["stop"] == "converged"
        assert float(_gap(r["x"], r["ref"]).max()) <= TOL_TIGHT


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("solve", SOLVES)
def test_sharded_batch_residuals_are_the_whole_fields(ranks, kind, transpose, solve):
    """Every rank returns the same (B,) residuals, and they are the whole
    field's ||A x - b|| / ||b|| (one all-reduce of the (B,) sums), not a
    shard's: in a solve cut after two matvec pairs, far above the rounding
    floor, they equal the whole field's recomputed from the gathered x."""
    r0 = ranks[0][kind, solve, transpose]
    for out in ranks:
        r = out[kind, solve, transpose]
        assert torch.equal(r["res"], r0["res"]) and torch.equal(r["loose"], r0["loose"])
        assert float(r["loose"].min()) > 1e3 * TOL
        np.testing.assert_allclose(r["loose"].numpy(), r["recomputed"].numpy(), rtol=1e-6)


def _close_dyes(got, ref):
    """The JAX package's bound for its sharded batched solve, per member on
    wet cells."""
    for g, w in zip(got, ref):
        wet = torch.isfinite(w)
        np.testing.assert_allclose(g[wet].numpy(), w[wet].numpy(), rtol=RTOL_DYE,
                                   atol=ATOL_DYE * float(w[wet].abs().max()))


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_fractions_match_single_device(ranks, kind):
    """The converged band partition, sharded against one device."""
    for out in ranks:
        r = out[kind, "fractions"]
        assert float(r["res"].max()) <= TOL_DYE and float(r["ref_res"].max()) <= TOL_DYE
        assert torch.equal(r["res"], ranks[0][kind, "fractions"]["res"])
        assert float(_gap(r["x"], r["ref"]).max()) <= TOL_TIGHT
        wet = torch.isfinite(r["x"][0])
        s = r["x"].sum(dim=0)[wet]
        assert float((s - 1.0).abs().max()) <= FRACTION_SLACK


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_fractions_match_direct_solve(ranks, kind):
    """The converged band partition, sharded, against a dense direct solve
    of the same dyes: the global masks sliced by each rank's offset and the
    surface diagonal on its shard give the whole field's system."""
    topo, T, wet = _case(kind)
    bs, surf = _rhs(wet)
    exact = _direct(T, topo, bs, surf, wet)
    for out in ranks:
        assert float(_gap(out[kind, "fractions"]["x"], exact).max()) <= TOL_TIGHT


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_fractions_at_reference_tol(ranks, kind):
    """The JAX package's own sharded batched check: at tol 1e-6 the
    sharded fractions against one device's, at its bound."""
    for out in ranks:
        r = out[kind, "fractions_ref_tol"]
        assert float(r["res"].max()) <= TOL_REF and float(r["ref_res"].max()) <= TOL_REF
        assert torch.equal(r["res"], ranks[0][kind, "fractions_ref_tol"]["res"])
        _close_dyes(r["x"], r["ref"])


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_batch_jittered_restarts(ranks, kind):
    """The diverging batch takes jittered restarts on the grid as on one
    device, every rank the same; its best iterates keep the residuals at
    most ||b||; a shard's jittered shadow vectors are the whole batch's,
    sliced."""
    decisions = lambda st: {k: v for k, v in st.items() if k != "chunk_s"}
    st0 = decisions(ranks[0][kind, "diverge"]["stats"])
    for out in ranks:
        r = out[kind, "diverge"]
        assert r["jitter"] == 0.0
        assert decisions(r["stats"]) == st0
        assert r["stats"]["diverge_restarts"] >= 1 and r["ref_stats"]["diverge_restarts"] >= 1
        assert float(r["res"].max()) <= 1.0 + 1e-5


def test_sharded_fractions_take_global_masks():
    """On a grid, `water_mass_fractions` takes the global (R, ny, nx)
    partition; a shard-sized one is refused."""
    import otmb_tpu_torch.parallel.mesh as M

    topo, T, wet = _case("tripolar")
    grid = M.ProcessGrid(SHAPE, 3, torch.device("cpu"), "gloo")
    sh = lambda x: shard_pytree(x, grid, topo.shape2d)
    with pytest.raises(ValueError, match="global"):
        P.water_mass_fractions(sh(T), sh(wet), topo, _bands()[:, :NY // 2, :NX // 2], grid=grid)


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from otmb_tpu.parallel.mesh import make_grid_mesh

    return make_grid_mesh(jax.devices()[:4], SHAPE)


def _jax_multi(mesh, T, topo, bs, surf, transpose, tol=TOL):
    """The JAX package's solve_shifted_multi on `mesh`, GSPMD over its jnp
    matvec, the inputs placed as __graft_entry__.py:308-318 places them."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    from otmb_tpu.grid.topology import GridTopology
    from otmb_tpu.models.solvers import solve_shifted_multi
    from otmb_tpu.ops.coeffs import StencilCoeffs
    from otmb_tpu.parallel.mesh import shard_pytree as jax_shard_pytree
    from otmb_tpu.parallel.mesh import sharding_for

    coeffs = jax_shard_pytree(mesh, StencilCoeffs(*(leg.numpy() for leg in T)))
    bs_sh = jax.device_put(bs.numpy(), NamedSharding(mesh, PartitionSpec(None, None, "y", "x")))
    surf_sh = jax.device_put(surf.numpy(), sharding_for(mesh, surf.numpy()))
    jtopo = GridTopology(kind=topo.kind, nx=topo.nx, ny=topo.ny, nz=topo.nz)
    xs, res = solve_shifted_multi(coeffs, bs_sh, jtopo, extra_diag=surf_sh, tol=tol,
                                  transpose=transpose, apply_impl="jnp")
    assert float(np.max(np.asarray(res))) <= max(tol, TOL_DYE)
    return torch.from_numpy(np.array(xs))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("transpose", [False, True])
def test_sharded_batch_matches_jax_gspmd(ranks, jax_mesh, kind, transpose):
    """The port's sharded batch against the JAX package's GSPMD solve of the
    same batch on a (2, 2) mesh, on the same operator."""
    topo, T, wet = _case(kind)
    _, surf = _rhs(wet)
    theirs = _jax_multi(jax_mesh, T, topo, _random(wet, 7), surf, transpose)
    for solve in SOLVES:
        assert float(_gap(ranks[0][kind, solve, transpose]["x"], theirs).max()) <= TOL_TIGHT


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_fractions_match_jax_gspmd(ranks, jax_mesh, kind):
    """The converged band partition: the port's sharded fractions against
    the JAX package's GSPMD solve of the same dyes."""
    topo, T, wet = _case(kind)
    bs, surf = _rhs(wet)
    theirs = _jax_multi(jax_mesh, T, topo, bs, surf, False, tol=TOL_DYE_JAX)
    for out in ranks:
        assert float(_gap(out[kind, "fractions"]["x"],
                          torch.where(wet[None], theirs, torch.nan)).max()) <= TOL_TIGHT
