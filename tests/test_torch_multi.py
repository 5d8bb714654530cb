"""otmb_tpu_torch's batched-tracer path on the CPU, against otmb_tpu's: the
plain versions of the multi-tracer stencil K5 (against the Pallas multi
kernels in interpret mode, as the JAX package's own tests run them) and of
the batched Thomas solve K2, the batched Krylov engine
(`solve_shifted_multi`, `solve_shifted_chunked_multi`) and
`water_mass_fractions`. The same seeded numpy inputs go through both
packages in float64.

Missing neighbours read 0 in the port, while the Pallas multi kernel clamps
j-1 at the south edge and k+1 at the floor and, on a bipolar grid, reads
row ny-1 itself above the top row; the random legs below are zeroed there,
as a real operator's are.

Also tests for two faults of the reference's batched engine that the port
does not carry: a jittered BiCGStab(1) member restart that seeds rho with
<r, r>, and a member whose recurrence went non-finite escaping every exit
once the divergence exits are dormant. The CUDA kernels themselves are
checked on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.models import solvers as J
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.apply import transpose_coeffs as jax_transpose_coeffs
from otmb_tpu.ops.coeffs import StencilCoeffs as JaxCoeffs
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.ops.stencil_pallas import (
    apply_stencil_pallas_multi,
    euler_propagate_pallas_multi,
    euler_step_pallas_multi,
)
from otmb_tpu.ops.tridiag_pallas import tridiag_solve_pallas
from otmb_tpu_torch import _build
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.ops.tridiag import tridiag_solve_plain
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

LEGS = ("diag", "east", "west", "north", "south", "top", "bottom")


@pytest.fixture(scope="module")
def jax_T(dataset, gridmetrics, indices):
    phi = jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                       indices=indices)
    return jax_transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                               indices=indices).T


@pytest.fixture(scope="module")
def T(jax_T):
    """The JAX operator, carried over: both packages solve the same system."""
    return coeffs_from_numpy({leg: np.asarray(jax_T[leg]) for leg in jax_T._fields}, device="cpu")


@pytest.fixture(scope="module")
def topo(gridmetrics):
    t = gridmetrics.topology
    return P.GridTopology(t.kind, t.nx, t.ny, t.nz)


@pytest.fixture(scope="module")
def wet(indices):
    return torch.from_numpy(np.array(indices.wet3d))


def _batch(wet, seed, n, dtype=torch.float64):
    """n random fields on the wet cells, (n, nz, ny, nx)."""
    rng = np.random.default_rng(seed)
    w = wet.numpy()
    return torch.from_numpy(np.where(w[None], rng.standard_normal((n,) + w.shape), 0.0)).to(dtype)


def _random_legs(wet, kind, seed):
    """Random legs, zero on land and across every missing neighbour."""
    rng = np.random.default_rng(seed)
    w = wet.numpy().astype(np.float64)
    legs = {"diag": w * (2.0 + rng.random(w.shape))}
    for leg in LEGS[1:]:
        legs[leg] = 0.1 * w * rng.standard_normal(w.shape)
    legs["bottom"][-1] = 0.0
    legs["top"][0] = 0.0
    legs["south"][:, 0] = 0.0
    if kind == "bipolar":
        legs["north"][:, -1] = 0.0
    return legs


def _skew(T, wet, diag):
    """A skew-dominant f32 operator (east +1, west -1)."""
    w = wet.double()
    z = torch.zeros_like(T.diag)
    return T._replace(diag=z + diag * w, east=z + w, west=z - w, north=z, south=z, top=z,
                      bottom=z).to(torch.float32)


def _surf(wet, dtype=torch.float64):
    s = torch.zeros(wet.shape, dtype=dtype)
    s[0] = 1.0
    return torch.where(wet, s, 0.0)


def _close(got, want, rel):
    """max |got - want| within rel of max |want|."""
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= rel * np.abs(want).max()


# --- K5 and the batched K2 --------------------------------------------------------


@pytest.mark.parametrize("op", ["T", "T'"])
@pytest.mark.parametrize("fn", ["apply", "euler_step", "euler_propagate"])
def test_k5_plain_matches_pallas_multi(gridmetrics, topo, wet, op, fn):
    """stencil_apply_multi, euler_step_multi and euler_propagate_multi on the
    CPU against the Pallas multi kernels (interpret mode), within 1e-12 of
    the field's max; each member also equals the single-tracer K1 entry."""
    legs = _random_legs(wet, topo.kind, seed=31)
    jc, pc = JaxCoeffs(**legs), coeffs_from_numpy(legs, device="cpu")
    if op == "T'":
        jc, pc = jax_transpose_coeffs(jc, gridmetrics.topology), P.transpose_coeffs(pc, topo)
    chis = _batch(wet, 32, 3)
    dt = 0.25 / float(pc.diag.abs().max())
    jtopo = gridmetrics.topology
    if fn == "apply":
        want = apply_stencil_pallas_multi(jc, chis.numpy(), jtopo, interpret=True)
        got = P.stencil_apply_multi(pc, chis, topo)
        single = [P.stencil_apply(pc, c, topo) for c in chis]
    elif fn == "euler_step":
        want = euler_step_pallas_multi(jc, chis.numpy(), dt, jtopo, interpret=True)
        got = P.euler_step_multi(pc, chis, dt, topo)
        single = [P.euler_step(pc, c, dt, topo) for c in chis]
    else:
        want = euler_propagate_pallas_multi(jc, chis.numpy(), dt, 5, jtopo, interpret=True)
        got = P.euler_propagate_multi(pc, chis, dt, 5, topo)
        single = [P.euler_propagate(pc, c, dt, 5, topo) for c in chis]
    assert got.shape == chis.shape and got.dtype == torch.float64
    _close(got.numpy(), want, 1e-12)
    for g, s in zip(got, single):
        assert torch.equal(g, s)


def test_k5_narrow_coefficients(topo, wet):
    """(bf16, f32), (f32, f32) and (f32, f64) batches equal the K1 entry
    member by member."""
    pc = coeffs_from_numpy(_random_legs(wet, topo.kind, seed=33), device="cpu")
    chis = _batch(wet, 34, 2)
    for ctype, vtype in ((torch.bfloat16, torch.float32), (torch.float32, torch.float32),
                         (torch.float32, torch.float64)):
        c, x = pc.to(ctype), chis.to(vtype)
        got = P.stencil_apply_multi(c, x, topo)
        assert got.dtype == vtype
        for g, xm in zip(got, x):
            assert torch.equal(g, P.stencil_apply(c, xm, topo))


def test_batched_thomas_matches_per_member_and_pallas(jax_T, wet):
    """The batched plain Thomas solve equals the per-member solve bit for
    bit, and the vmapped Pallas kernel within 1e-12 (XLA contracts its
    recurrence into FMAs, which the port's kernel is built not to)."""
    lo, up = np.asarray(jax_T.bottom), np.asarray(jax_T.top)
    sd = np.asarray(jax_T.diag) + _surf(wet).numpy()
    di = np.where(sd != 0, sd, 1.0)
    legs = tuple(torch.tensor(a) for a in (lo, di, up))
    bs = _batch(wet, 35, 4)
    got = P.tridiag_solve(*legs, bs)
    assert got.shape == bs.shape
    for g, b in zip(got, bs):
        assert torch.equal(g, tridiag_solve_plain(*legs, b))
    want = jax.vmap(lambda v: tridiag_solve_pallas(lo, di, up, v, interpret=True))(bs.numpy())
    _close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("name", ["three_d", "zero_members", "wrong_shape", "noncontiguous",
                                  "half_values", "k1_given_a_batch", "thomas_batched_legs"])
def test_batched_wrappers_reject_bad_inputs(T, topo, wet, name):
    chis = _batch(wet, 36, 2)
    with pytest.raises((TypeError, ValueError)):
        if name == "three_d":
            P.stencil_apply_multi(T, chis[0], topo)
        elif name == "zero_members":
            P.euler_step_multi(T, chis[:0], 1.0, topo)
        elif name == "wrong_shape":
            P.euler_propagate_multi(T, chis[:, :-1], 1.0, 2, topo)
        elif name == "noncontiguous":
            P.stencil_apply_multi(T, chis.transpose(2, 3).contiguous().transpose(2, 3), topo)
        elif name == "half_values":
            P.stencil_apply_multi(T, chis.half(), topo)
        elif name == "k1_given_a_batch":
            P.stencil_apply(T, chis, topo)
        else:
            P.tridiag_solve(T.bottom[None], T.diag[None], T.top[None], chis)


def test_cpu_batches_launch_nothing(T, topo, wet):
    counted = lambda: tuple(_build.calls(_build.KERNELS[k]) for k in ("K1", "K5", "K2"))
    before = counted()
    chis = _batch(wet, 37, 2)
    P.euler_propagate_multi(T, chis, 1.0, 2, topo)
    P.tridiag_solve(T.bottom, torch.where(T.diag != 0, T.diag, 1.0), T.top, chis)
    assert counted() == before


# --- the batched engine -------------------------------------------------------------


@pytest.mark.parametrize("transpose", [False, True])
def test_solve_shifted_multi_matches_reference(jax_T, T, topo, wet, gridmetrics, transpose):
    """Lockstep BiCGStab against otmb_tpu's `solve_shifted_multi` (jnp
    matvec) and the port's per-member `solve_shifted`, forward and
    transpose."""
    bs = _batch(wet, 19, 3)
    xs, res = P.solve_shifted_multi(T, bs, topo, shift=1e-4, tol=1e-12, transpose=transpose)
    assert res.shape == (3,) and res.dtype == torch.float64
    assert float(res.max()) < 1e-10
    xj, rj = J.solve_shifted_multi(jax_T, bs.numpy(), gridmetrics.topology, shift=1e-4,
                                   tol=1e-12, transpose=transpose, apply_impl="jnp")
    assert float(np.max(np.asarray(rj))) < 1e-10
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), rtol=1e-7, atol=1e-9)
    for m in range(3):
        ref, rres = P.solve_shifted(T, bs[m], topo, shift=1e-4, tol=1e-12, transpose=transpose)
        assert rres < 1e-10
        np.testing.assert_allclose(xs[m].numpy(), ref.numpy(), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2"])
@pytest.mark.parametrize("transpose", [False, True])
def test_chunked_multi_matches_reference(jax_T, T, topo, wet, gridmetrics, transpose,
                                         algorithm):
    """Both algorithms against otmb_tpu's `solve_shifted_chunked_multi`
    (Pallas multi kernels in interpret mode) and against each other."""
    bs = _batch(wet, 61, 2)
    kw = dict(shift=1e-4, tol=1e-12, chunk=8, transpose=transpose, algorithm=algorithm)
    stats = {}
    xs, res = P.solve_shifted_chunked_multi(T, bs, topo, stats=stats, **kw)
    xj, rj = J.solve_shifted_chunked_multi(jax_T, bs.numpy(), gridmetrics.topology, **kw)
    assert float(res.max()) < 1e-10 and float(np.max(np.asarray(rj))) < 1e-10
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-9)
    x1, _ = P.solve_shifted_multi(T, bs, topo, shift=1e-4, tol=1e-12, transpose=transpose)
    np.testing.assert_allclose(xs.numpy(), x1.numpy(), rtol=1e-6, atol=1e-9)
    assert stats["stop"] == "converged" and stats["restarts"] == 0
    assert stats["end_rel"] <= 1e-12 and len(stats["chunk_s"]) >= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2"])
def test_batch_of_one_is_the_field_solve(T, topo, wet, algorithm, dtype):
    """One engine serves fields and batches: a batch of one gives the
    unfused field solve's iterate, residual and stats bit for bit."""
    b = _batch(wet, 62, 1, dtype)
    kw = dict(extra_diag=_surf(wet, dtype), tol=1e-10, algorithm=algorithm)
    st1, stb = {}, {}
    x, res = P.solve_shifted_chunked(T.to(dtype), b[0], topo, fused=False, stats=st1, **kw)
    xs, rs = P.solve_shifted_chunked_multi(T.to(dtype), b, topo, stats=stb, **kw)
    assert torch.equal(xs[0], x) and float(rs[0]) == res and res < 1e-5
    st1.pop("chunk_s"), stb.pop("chunk_s")
    assert st1 == stb and st1["stop"] == "converged"


def test_chunked_multi_bicgstab2_skew(T, topo, wet):
    """Per-member BiCGStab(2) with the Jacobi M converges the skew-dominant
    system that stalls BiCGStab(1), for every member at once."""
    w = wet.double()
    z = torch.zeros_like(T.diag)
    skew = T._replace(diag=z + 1e-2 * w, east=z + w, west=z - w, north=z, south=z, top=z,
                      bottom=z)
    bs = _batch(wet, 6, 2)
    kw = dict(tol=1e-10, maxiter=400, chunk=20, preconditioner="jacobi", early_stop=False,
              max_restarts=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, res1 = P.solve_shifted_chunked_multi(skew, bs, topo, **kw)
        _, res2 = P.solve_shifted_chunked_multi(skew, bs, topo, algorithm="bicgstab2", **kw)
    assert float(res2.max()) < 1e-6
    assert float(res2.max()) < 1e-3 * float(res1.min())


def test_chunked_multi_per_member_restart_and_stats(T, topo, wet):
    """A skew f32 operator: the stalled members are restarted (a stall
    restart of the batch budget), both members exit early, stats are
    filled, and the best iterates protect the residuals."""
    bs = _batch(wet, 5, 2, torch.float32)
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, res = P.solve_shifted_chunked_multi(_skew(T, wet, 1e-6), bs, topo, tol=1e-300,
                                               maxiter=3000, chunk=10, preconditioner="jacobi",
                                               max_restarts=1, stats=stats)
    assert stats["stop"] in ("diverged", "stall")
    assert stats["iters"] < 1500
    assert stats["restarts"] >= 1
    assert float(res.max()) <= 1.0 + 1e-5 and stats["end_rel"] <= 1.0 + 1e-5


def test_chunked_multi_rejects_bad_arguments(T, topo, wet):
    with pytest.raises(ValueError, match="B, nz, ny, nx"):
        P.solve_shifted_chunked_multi(T, wet.double(), topo)
    with pytest.raises(ValueError, match="algorithm"):
        P.solve_shifted_chunked_multi(T, wet.double()[None], topo, algorithm="gmres")
    with pytest.raises(ValueError, match="algorithm"):
        P.water_mass_fractions(T, wet, topo, np.ones((1,) + tuple(wet.shape[1:]), bool),
                               algorithm="gmres")


# --- water-mass fractions ---------------------------------------------------------


def _bands(ny, nx, n):
    i = np.arange(nx)
    edges = [nx * r // n for r in range(n + 1)]
    return np.stack([np.broadcast_to((i >= lo) & (i < hi), (ny, nx))
                     for lo, hi in zip(edges[:-1], edges[1:])])


@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2"])
def test_water_mass_fractions_partition(jax_T, T, topo, wet, indices, gridmetrics, algorithm):
    """Fractions from a three-band surface partition: against otmb_tpu's,
    each in [0, ~1], and by linearity their sum equals the all-surface dye
    solve (tests/test_solvers.py's partition test)."""
    masks = _bands(topo.ny, topo.nx, 3)
    stats = {}
    fr, res = P.water_mass_fractions(T, wet, topo, masks, tol=1e-13, algorithm=algorithm,
                                     stats=stats)
    assert fr.shape == (3,) + tuple(wet.shape) and res.shape == (3,)
    assert float(res.max()) < 1e-11 and stats["iters"] > 0
    w = wet.numpy()
    assert bool(torch.isnan(fr[:, ~wet]).all())
    frv = fr.numpy()[:, w]
    assert frv.min() > -1e-6 and frv.max() < 1.0 + 1e-4
    fj, rj = J.water_mass_fractions(jax_T, indices.wet3d, gridmetrics.topology, masks,
                                    tol=1e-13, apply_impl="jnp")
    assert float(np.max(np.asarray(rj))) < 1e-11
    # Two Krylov solves to a relative residual of 1e-13 may differ by up to
    # ||A^-1|| * 1e-13 * ||b||, ~1e-3 here (||A^-1|| is the age scale, ~1e9
    # s); they agree far better than that.
    np.testing.assert_allclose(frv, np.asarray(fj)[:, w], rtol=0, atol=1e-4)
    surf = _surf(wet)
    ref, rres = P.solve_shifted(T, surf, topo, extra_diag=surf, tol=1e-13)
    assert rres < 1e-11
    np.testing.assert_allclose(frv.sum(axis=0), ref.numpy()[w], rtol=1e-3, atol=1e-3)


def test_water_mass_fractions_dry_region(T, topo, wet):
    """A region with no wet surface cell gives zeros and residual 0, beside
    a region that covers the whole surface."""
    ny, nx = topo.ny, topo.nx
    masks = np.zeros((2, ny, nx), bool)
    masks[0] = ~wet[0].numpy()  # only land
    masks[1] = True
    fr, res = P.water_mass_fractions(T, wet, topo, masks, tol=1e-12)
    w = wet.numpy()
    assert float(res[0]) == 0.0 and float(res[1]) < 1e-10
    assert bool((fr[0].numpy()[w] == 0).all())
    assert fr[1].numpy()[w].min() > 0.9


# --- the reference faults the port does not carry -------------------------------------


def test_jittered_member_restart_seeds_rho_from_rhat(jax_T, T, topo, wet, gridmetrics):
    """The batched BiCGStab(1) restart seeds each masked member's rho with
    <rhat, r> for its jittered rhat and passes the other members through;
    the reference's `_mr_restart_members` seeds <r, r>."""
    bs = _batch(wet, 9, 3, torch.float32)
    x = 0.3 * _batch(wet, 10, 3, torch.float32)
    sys_ = S._system(T, torch.float32, topo)
    state = S._initial_state(sys_, "bicgstab", bs)
    mask = [True, False, True]
    for jitter in (1, 2, 3):
        st = S._restart_members(sys_, "bicgstab", None, state, x, bs, mask, jitter)
        for m in range(3):
            if mask[m]:
                dot = lambda u, v: torch.dot(u[m].flatten(), v[m].flatten())
                assert torch.equal(st.rho[m], dot(st.rhat, st.r))
                assert not torch.equal(st.rho[m], dot(st.r, st.r))
                assert torch.equal(st.x[m], x[m])
            else:
                assert all(torch.equal(a[m], b[m]) for a, b in zip(st, state))
    jc = jax.tree_util.tree_map(lambda a: a.astype(np.float32), jax_T)
    jstate = tuple(jnp.asarray(np.asarray(a)) for a in state)
    jst = J._mr_restart_members(jc, jstate, x.numpy(), bs.numpy(), jnp.asarray(mask),
                                gridmetrics.topology, True, 1)
    r, rhat, rho = (np.asarray(a, np.float64) for a in (jst[1], jst[3], jst[4]))
    assert rho[0] == pytest.approx(float(r[0].ravel() @ r[0].ravel()), rel=1e-5)
    assert abs(rho[0] - float(rhat[0].ravel() @ r[0].ravel())) > 1e-3 * abs(rho[0])


def _scripted(monkeypatch, wet, bs, script):
    """Both engines' BiCGStab(2) chunks replaced by a scripted recurrence:
    member m's squared residual after `pairs` matvec pairs is
    script(m, pairs) * ||b_m||^2. Returns a runner of either engine."""
    bn2 = [float(torch.dot(b.flatten(), b.flatten())) for b in bs]
    nwet = float(wet.sum())
    done = {"port": 0, "jax": 0}

    def port_cycles(sys_, step, st, ncycles):
        done["port"] += 2 * ncycles
        v = [math.sqrt(script(m, done["port"]) * bn2[m] / nwet) for m in range(len(bs))]
        r = torch.stack([torch.where(wet, torch.tensor(x, dtype=bs.dtype), 0.0) for x in v])
        return st._replace(r=r)

    def jax_chunk(c_l, mc_l, md_l, state, ncycles, *args):
        done["jax"] += 2 * ncycles
        return state, np.array([script(m, done["jax"]) * bn2[m] for m in range(len(bs))])

    monkeypatch.setattr(S, "_bicgstab2_cycles", port_cycles)
    monkeypatch.setattr(J, "_mr_chunk2", jax_chunk)
    return done


def test_nonfinite_member_stops_where_the_reference_runs_on(jax_T, T, topo, wet, gridmetrics,
                                                             monkeypatch):
    """Member 0 sits at 40x its starting residual for 30 pairs, then
    converges; member 1 at 40x for 20 pairs, then NaN. After two chunks
    neither has progress and no jittered restart is left, so the
    divergence exits go dormant. The port gives up on member 1 at its NaN
    read and stops when member 0 converges; otmb_tpu runs out maxiter."""
    bs = _batch(wet, 5, 2, torch.float32)
    nan = float("nan")
    script = lambda m, pairs: ((40.0 if pairs <= 30 else 1e-14) if m == 0
                               else (40.0 if pairs <= 20 else nan))
    _scripted(monkeypatch, wet, bs, script)
    kw = dict(tol=1e-6, chunk=10, maxiter=200, max_restarts=0, max_diverge_restarts=0,
              algorithm="bicgstab2", early_stop=False)
    stats, jstats = {}, {}
    _, res = P.solve_shifted_chunked_multi(T.to(torch.float32), bs, topo, stats=stats, **kw)
    J.solve_shifted_chunked_multi(jax.tree_util.tree_map(lambda a: a.astype(np.float32), jax_T),
                                  bs.numpy(), gridmetrics.topology, stats=jstats, **kw)
    assert stats["stop"] == "diverged" and stats["iters"] == 40
    assert float(res[1]) == pytest.approx(1.0)  # its best iterate: x0 = 0
    assert jstats["stop"] == "maxiter" and jstats["iters"] == 200


def test_converged_member_stays_done_after_its_recurrence_breaks(jax_T, T, topo, wet,
                                                                 gridmetrics, monkeypatch):
    """Member 0 meets tol after 10 pairs and its recurrence goes NaN after;
    member 1 converges after 120. The port keeps member 0 done: no jittered
    restart, no divergence exit, stop "converged" at 120 pairs. otmb_tpu
    counts the NaN member active again, spends its jittered restarts on it
    and ends the solve as "diverged"."""
    bs = _batch(wet, 7, 2, torch.float32)
    script = lambda m, pairs: ((0.25 if pairs < 10 else 1e-14 if pairs == 10 else float("nan"))
                               if m == 0 else 0.5 * 0.1 ** (pairs / 10))
    _scripted(monkeypatch, wet, bs, script)
    kw = dict(tol=1e-6, chunk=10, maxiter=200, algorithm="bicgstab2", early_stop=False)
    stats, jstats = {}, {}
    P.solve_shifted_chunked_multi(T.to(torch.float32), bs, topo, stats=stats, **kw)
    J.solve_shifted_chunked_multi(jax.tree_util.tree_map(lambda a: a.astype(np.float32), jax_T),
                                  bs.numpy(), gridmetrics.topology, stats=jstats, **kw)
    assert stats["stop"] == "converged" and stats["iters"] == 120
    assert stats["diverge_restarts"] == 0 and stats["restarts"] == 0
    assert jstats["stop"] == "diverged" and jstats["diverge_restarts"] == 2


# --- the stopping rule of the dye systems, in both packages ----------------------------


@pytest.fixture(scope="module")
def mid_grid():
    """A 72x60x12 tripolar grid and its operator, in both packages: large
    enough that the surface restoring rows dominate the dye systems'
    relative residual, as at 1 degree."""
    from otmb_tpu.grid.geometry import makegridmetrics
    from otmb_tpu.grid.indices import makeindices
    from otmb_tpu.utils.synthetic import synthetic_dataset

    ds = synthetic_dataset(nx=72, ny=60, nz=12, topology="tripolar", seed=3)
    gm = makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat,
                         lev=ds.lev, lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices)
    idx = makeindices(gm.v3d)
    phi = jax_faceflux(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    jT = jax_transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx).T
    T = coeffs_from_numpy({leg: np.asarray(jT[leg]) for leg in jT._fields}, device="cpu")
    t = gm.topology
    topo = P.GridTopology(t.kind, t.nx, t.ny, t.nz)
    wet = torch.from_numpy(np.array(idx.wet3d))
    surf = _surf(wet)
    dye, res = P.solve_shifted(T, surf, topo, extra_diag=surf, tol=1e-14)
    assert res < 1e-13
    return jT, T, gm.topology, topo, idx.wet3d, wet, dye


@pytest.mark.parametrize("tol", [1e-4, 1e-8, 1e-13])
def test_fractions_resolve_the_interior_only_when_converged(mid_grid, tol):
    """Four latitude-band fractions from both packages at one tol, against
    the converged all-surface dye. b is 1/s on the surface rows, beside
    interior legs ~1e-4/s, so the relative residual hardly weighs the
    interior: at tol 1e-4 (the JAX bench's) and 1e-8 both packages meet
    tol while their fractions' sum misses the dye by more than 0.5 and the
    fractions leave [-1e-3, 1 + 1e-3]; at 1e-13 both lie in that range and
    sum to the dye within 1e-3 (at 1e-12 otmb_tpu's sum misses it by
    0.00099)."""
    jT, T, jtopo, topo, jwet, wet, dye = mid_grid
    masks = np.zeros((4, topo.ny, topo.nx), bool)
    for r in range(4):
        masks[r, r * topo.ny // 4:(r + 1) * topo.ny // 4] = True
    fr, res = P.water_mass_fractions(T, wet, topo, masks, tol=tol)
    fj, rj = J.water_mass_fractions(jT, jwet, jtopo, masks, tol=tol, apply_impl="jnp")
    w = wet.numpy()
    for name, f, r in (("port", fr.numpy(), res.numpy()), ("otmb_tpu", np.asarray(fj),
                                                           np.asarray(rj))):
        assert r.max() <= tol, name
        fw = f[:, w]
        miss = np.abs(fw.sum(axis=0) - dye.numpy()[w]).max()
        in_range = fw.min() >= -1e-3 and fw.max() <= 1.0 + 1e-3
        if tol < 1e-10:
            assert in_range and miss <= 1e-3, (name, fw.min(), fw.max(), miss)
        else:
            assert not in_range and miss > 0.5, (name, fw.min(), fw.max(), miss)
