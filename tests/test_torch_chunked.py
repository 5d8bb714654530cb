"""otmb_tpu_torch's Krylov engine (`solve_shifted_chunked`, BiCGStab(1) and
BiCGStab(2), fused and unfused), its refinement route and
`sequestration_time`, against otmb_tpu's versions and against scipy direct
solves, on the CPU. Solutions are held to the tolerance asked for, not to
the reference's Krylov trajectory, which rounds differently.

Mirrors the chunked-engine, BiCGStab(2), refinement and sequestration
tests of tests/test_solvers.py, and adds a test for each of three faults
of the reference engine that the port does not carry: a refinement that
repeats a stalled pass, a non-finite recurrence that runs out maxiter once
the divergence exit is spent, and a jittered BiCGStab(1) restart whose rho
is <r, r> instead of <rhat, r>.
"""

import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import otmb_tpu_torch as P
from otmb_tpu.grid.indices import wet_vector
from otmb_tpu.models import solvers as J
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.utils.sparse_export import coeffs_to_scipy
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)


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


def _surf(wet, dtype=torch.float64):
    s = torch.zeros(wet.shape, dtype=dtype)
    s[0] = 1.0
    return torch.where(wet, s, 0.0)


def _direct(jax_T, indices, topo, b, shift=0.0, extra=None, transpose=False):
    """scipy's direct solve of (shift I + D_extra + T) x = b (T' when
    `transpose`), on the wet cells."""
    mat = coeffs_to_scipy(jax_T, indices, topo)
    a = (mat.T if transpose else mat) + shift * sp.identity(mat.shape[0])
    if extra is not None:
        a = a + sp.diags(wet_vector(np.asarray(extra), indices))
    return spla.spsolve(a.tocsc(), wet_vector(np.asarray(b), indices))


def _rand_b(wet, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return torch.where(wet, torch.from_numpy(rng.standard_normal(tuple(wet.shape))), 0.0).to(dtype)


def _skew(T, wet, diag):
    """A skew-dominant f32 operator (east +1, west -1): the eigenvalue pairs
    that stall BiCGStab(1); with diag = 0 it is exactly skew on the wet
    cells, and BiCGStab's <rhat, A r> starts at rounding level."""
    w = wet.double()
    z = torch.zeros_like(T.diag)
    return T._replace(diag=z + diag * w, east=z + w, west=z - w, north=z, south=z, top=z,
                      bottom=z).to(torch.float32)


def _jax_skew(jax_T, indices, diag):
    import jax.numpy as jnp

    w = jnp.asarray(np.asarray(indices.wet3d).astype(np.float32))
    z = jnp.zeros_like(jax_T.diag, dtype=jnp.float32)
    return jax_T._replace(diag=z + diag * w, east=z + w, west=z - w, north=z, south=z,
                          top=z, bottom=z)


def _c32(jax_T):
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), jax_T)


# --- the engine --------------------------------------------------------------


@pytest.mark.parametrize("transpose", [False, True])
def test_chunked_matches_whole_solve(T, jax_T, topo, wet, indices, gridmetrics, transpose):
    """The engine solves to the tolerance and solution of solve_shifted, of
    otmb_tpu's chunked engine and of the direct solve."""
    b = _rand_b(wet, 29)
    x_ch, res_ch = P.solve_shifted_chunked(T, b, topo, shift=1e-4, tol=1e-12,
                                           transpose=transpose, chunk=7)
    x_ref, res_ref = P.solve_shifted(T, b, topo, shift=1e-4, tol=1e-12, transpose=transpose)
    x_j, res_j = J.solve_shifted_chunked(jax_T, b.numpy(), gridmetrics.topology, shift=1e-4,
                                         tol=1e-12, transpose=transpose, chunk=7)
    assert res_ch < 1e-10 and res_ref < 1e-10 and float(res_j) < 1e-10
    np.testing.assert_allclose(x_ch.numpy(), x_ref.numpy(), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(x_ch.numpy(), np.asarray(x_j), rtol=1e-7, atol=1e-9)
    direct = _direct(jax_T, indices, gridmetrics.topology, b, shift=1e-4, transpose=transpose)
    np.testing.assert_allclose(x_ch.numpy()[wet.numpy()], direct, rtol=1e-7, atol=1e-9)


def test_chunked_maxiter_cap(T, topo, wet):
    """The loop respects maxiter (a chunk of 4, then the 2 left) and returns
    the honest residual."""
    stats = {}
    _, res = P.solve_shifted_chunked(T, wet.double(), topo, shift=1e-9, tol=1e-15, maxiter=6,
                                     chunk=4, stats=stats)
    assert res > 0.0
    assert stats["iters"] == 6 and stats["stop"] == "maxiter"
    assert len(stats["chunk_s"]) == 2


def test_chunked_stagnation_stop(T, topo, wet):
    """A 3-chunk window with <2 % of gain stops the solve, with a warning,
    long before maxiter."""
    b = _rand_b(wet, 5, torch.float32)
    stats = {}
    with pytest.warns(UserWarning, match="improved <2%"):
        _, res = P.solve_shifted_chunked(_skew(T, wet, 1e-6), b, topo, tol=1e-300,
                                         maxiter=100_000, chunk=10, preconditioner="jacobi",
                                         stats=stats)
    assert 0.0 < res < 1.0
    assert stats["stop"] == "stall" and stats["iters"] < 100_000


def test_chunked_best_iterate_on_divergence(T, topo, wet):
    """With early_stop off and the recurrence blowing up, the returned
    iterate is never worse than x0 = 0."""
    b = _rand_b(wet, 5, torch.float32)
    _, res = P.solve_shifted_chunked(_skew(T, wet, 1e-6), b, topo, tol=1e-300, maxiter=300,
                                     chunk=10, preconditioner="jacobi", early_stop=False)
    assert 0.0 < res <= 1.0 + 1e-5


@pytest.mark.parametrize("transpose", [False, True])
def test_bicgstab2_matches_bicgstab(T, jax_T, topo, wet, indices, gridmetrics, transpose):
    """BiCGStab(2) (y-space, 2D polish) solves the same system to the same
    solution as BiCGStab(1), as otmb_tpu's BiCGStab(2) and as the direct
    solve."""
    b = _rand_b(wet, 53)
    kw = dict(shift=1e-4, tol=1e-12, chunk=8, transpose=transpose)
    x1, r1 = P.solve_shifted_chunked(T, b, topo, **kw)
    x2, r2 = P.solve_shifted_chunked(T, b, topo, algorithm="bicgstab2", **kw)
    xj, rj = J.solve_shifted_chunked(jax_T, b.numpy(), gridmetrics.topology,
                                     algorithm="bicgstab2", **kw)
    assert r1 < 1e-10 and r2 < 1e-10 and float(rj) < 1e-10
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(x2.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-9)
    direct = _direct(jax_T, indices, gridmetrics.topology, b, shift=1e-4, transpose=transpose)
    np.testing.assert_allclose(x2.numpy()[wet.numpy()], direct, rtol=1e-6, atol=1e-9)


def test_bicgstab2_beats_bicgstab_on_skew_system(T, topo, wet):
    """BiCGStab(1) stalls on the skew-dominant system; BiCGStab(2) solves it
    within the same matvec budget."""
    b = _rand_b(wet, 5)
    w = wet.double()
    z = torch.zeros_like(T.diag)
    skew = T._replace(diag=z + 1e-2 * w, east=z + w, west=z - w, north=z, south=z, top=z,
                      bottom=z)
    kw = dict(tol=1e-10, maxiter=400, chunk=20, preconditioner="jacobi", early_stop=False,
              max_restarts=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, res1 = P.solve_shifted_chunked(skew, b, topo, **kw)
        _, res2 = P.solve_shifted_chunked(skew, b, topo, algorithm="bicgstab2", **kw)
    assert res2 < 1e-6
    assert res2 < 1e-3 * res1


def test_chunked_divergence_exit_stops_early(T, topo, wet):
    """The divergence exit (with max_restarts=0, the refinement's inner
    configuration) ends a diverging solve long before maxiter, with the
    best iterate."""
    b = _rand_b(wet, 5, torch.float32)
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, res = P.solve_shifted_chunked(_skew(T, wet, 1e-6), b, topo, tol=1e-300,
                                         maxiter=3000, chunk=10, preconditioner="jacobi",
                                         max_restarts=0, stats=stats)
    assert stats["stop"] in ("diverged", "stall")
    assert stats["iters"] < 1000
    assert 0.0 < res <= 1.0 + 1e-5
    assert stats["end_rel"] <= 1.0 + 1e-5


def test_chunked_stats_on_convergence(T, topo, wet):
    b = _rand_b(wet, 11, torch.float32)
    stats = {}
    _, res = P.solve_shifted_chunked(T.to(torch.float32), b, topo, shift=1e-3, tol=1e-5,
                                     chunk=25, stats=stats)
    assert stats["stop"] == "converged"
    assert 0 < stats["iters"] <= 2000
    assert stats["restarts"] == 0 and stats["diverge_restarts"] == 0
    assert stats["start_rel"] == 1.0 and stats["end_rel"] <= 1e-5
    # the first chunk is read after 1, 3, 7, 15 and 25 iterations, the rest every 25
    assert stats["iters"] in (1, 3, 7, 15) or stats["iters"] % 25 == 0
    assert len(stats["chunk_s"]) == -(-stats["iters"] // 25)
    assert res < 1e-4


@pytest.mark.parametrize("transpose", [False, True])
def test_bicgstab2_fused_matches_composition(T, topo, wet, transpose):
    """The fused Krylov step (K3's plain version here) reaches the solution
    of the separate passes; only the dots round differently."""
    b = _rand_b(wet, 77, torch.float32)
    kw = dict(shift=1e-3, tol=1e-6, chunk=20, algorithm="bicgstab2", transpose=transpose)
    c32 = T.to(torch.float32)
    xf, rf = P.solve_shifted_chunked(c32, b, topo, fused=True, **kw)
    xc, rc = P.solve_shifted_chunked(c32, b, topo, fused=False, **kw)
    assert rf < 1e-5 and rc < 1e-5
    scale = float(xc.abs().max())
    np.testing.assert_allclose(xf.numpy(), xc.numpy(), atol=2e-4 * scale, rtol=0)


def test_fused_needs_the_thomas_preconditioner(T, topo, wet):
    with pytest.raises(ValueError, match="tridiag"):
        P.solve_shifted_chunked(T, wet.double(), topo, algorithm="bicgstab2", fused=True,
                                preconditioner="jacobi")
    with pytest.raises(ValueError, match="algorithm"):
        P.solve_shifted_chunked(T, wet.double(), topo, algorithm="cg")


@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2"])
def test_diverge_restarts_break_deterministic_blowup(T, topo, wet, algorithm):
    """A diverging solve whose best iterate is x0 gets jittered restarts
    from a budget of its own even with max_restarts=0; with that budget at
    0 it exits at once. The exactly skew system goes non-finite in the
    first chunk (the reference's test uses a raw f32 age system, which the
    port's BiCGStab(1) converges)."""
    b = _rand_b(wet, 5, torch.float32)
    kw = dict(tol=1e-6, chunk=10, maxiter=2000, max_restarts=0, algorithm=algorithm,
              early_stop=False)
    skew = _skew(T, wet, 0.0)
    stats, st0 = {}, {}
    _, res = P.solve_shifted_chunked(skew, b, topo, max_diverge_restarts=2, stats=stats, **kw)
    assert stats["diverge_restarts"] >= 1
    assert res <= 1.0 + 1e-5
    P.solve_shifted_chunked(skew, b, topo, max_diverge_restarts=0, stats=st0, **kw)
    assert st0["diverge_restarts"] == 0
    assert st0["iters"] <= stats["iters"]


def test_jitter_rhat_matches_jax(wet):
    """The same +-10 % modulation, cycling k, j, i with the restart ordinal."""
    r = _rand_b(wet, 3)
    for jitter in range(5):
        want = np.asarray(J._jitter_rhat(r.numpy(), jitter))
        np.testing.assert_array_equal(S._jitter_rhat(r, jitter).numpy(), want)


# --- refinement ----------------------------------------------------------------


@pytest.fixture(scope="module")
def age64(T, topo, wet):
    """The f64 ideal age, the reference for the refined f32 solves."""
    gamma, res = P.ideal_age(T, wet, topo, tol=1e-10)
    assert res < 1e-9
    return gamma


@pytest.mark.parametrize("inner", ["bicgstab", "bicgstab2"])
def test_ir_survives_diverging_inner_solve_and_retries_the_revert(T, topo, wet, age64, inner,
                                                                  monkeypatch):
    """A pass whose inner solve returns garbage is reverted to the best
    iterate, and that reverted pass keeps its one retry (it starts no
    better than the pass before it, which would otherwise stop the loop);
    the refinement still converges."""
    real = S._solve
    calls = {"n": 0}

    def sabotaged(sys_, b, **kw):
        calls["n"] += 1
        x, res = real(sys_, b, **kw)
        if calls["n"] == 2:  # the second inner pass returns garbage
            return torch.where(b != 0, 1e6, 0.0).to(b.dtype), 1e6
        return x, res

    monkeypatch.setattr(S, "_solve", sabotaged)
    stats = {}
    x, rel = P.solve_shifted_ir(T.to(torch.float32), wet.float(), topo,
                                extra_diag=_surf(wet, torch.float32), tol=1e-9,
                                max_refinements=12, inner_algorithm=inner, stats=stats)
    assert calls["n"] >= 3
    assert rel < 1e-9
    passes = stats["passes"]
    k = next(i for i, p in enumerate(passes) if p["reverted"])
    assert passes[k]["rel_start"] >= 0.9 * passes[k - 1]["rel_start"]  # no better than before
    assert "stagnated" not in passes[k] and passes[k]["inner_iters"] > 0  # it was retried
    np.testing.assert_allclose(x.numpy()[wet.numpy()], age64.numpy()[wet.numpy()], rtol=1e-3,
                               atol=1.0)


@pytest.mark.parametrize("inner", ["bicgstab2", "bicgstab"])
def test_ir_inner_path(jax_T, T, topo, wet, indices, gridmetrics, age64, inner):
    """The production refinement: f32 inner solves (BiCGStab(2) through the
    engine with max_restarts=0 and a 600-pair pass budget, or BiCGStab(1)),
    f64 defects; against the f64 age, otmb_tpu's f64 age and the direct
    solve."""
    stats = {}
    x, rel = P.solve_shifted_ir(T.to(torch.float32), wet.float(), topo,
                                extra_diag=_surf(wet, torch.float32), tol=1e-9,
                                inner_algorithm=inner, stats=stats)
    assert rel < 1e-9
    w = wet.numpy()
    np.testing.assert_allclose(x.numpy()[w], age64.numpy()[w], rtol=1e-3, atol=1.0)
    ref, _ = J.ideal_age(jax_T, indices.wet3d, gridmetrics.topology, tol=1e-10)
    np.testing.assert_allclose(x.numpy()[w], np.asarray(ref)[w], rtol=1e-3, atol=1.0)
    direct = _direct(jax_T, indices, gridmetrics.topology, wet.double(),
                     extra=_surf(wet).numpy())
    np.testing.assert_allclose(x.numpy()[w], direct, rtol=1e-3, atol=1.0)
    for p in stats["passes"]:
        assert p["inner_restarts"] == 0
        assert 0 < p["inner_iters"] <= (600 if inner == "bicgstab2" else 2000)
        assert p["inner_stop"] in ("converged", "stall", "maxiter", "diverged")
        assert len(p["inner_chunk_s"]) >= 1 and p["inner_end_rel"] >= 0.0


@pytest.mark.parametrize("inner", ["bicgstab", "bicgstab2"])
def test_ir_stats_per_pass(T, topo, wet, inner):
    stats = {}
    _, rel = P.solve_shifted_ir(T.to(torch.float32), wet.float(), topo,
                                extra_diag=_surf(wet, torch.float32), tol=1e-9,
                                inner_algorithm=inner, stats=stats)
    assert rel < 1e-9
    assert stats["refinements"] == len(stats["passes"]) >= 1
    assert stats["rel_final"] == rel
    p0 = stats["passes"][0]
    assert p0["rel_start"] == 1.0 and p0["reverted"] is False
    rels = [p["rel_start"] for p in stats["passes"]]
    assert rels == sorted(rels, reverse=True)


def test_ir_dynamic_pass_tolerance(T, topo, wet, monkeypatch):
    """Each pass asks its inner solve for max(inner_tol, 0.5 tol / rel), at
    most 0.9, and records it."""
    real = S._solve
    seen = []

    def recording(sys_, b, **kw):
        seen.append(kw.get("tol"))
        return real(sys_, b, **kw)

    monkeypatch.setattr(S, "_solve", recording)
    stats = {}
    tol = 1e-9
    _, rel = P.solve_shifted_ir(T.to(torch.float32), wet.float(), topo,
                                extra_diag=_surf(wet, torch.float32), tol=tol, inner_tol=1e-4,
                                inner_algorithm="bicgstab2", stats=stats)
    assert rel < tol
    assert len(stats["passes"]) == len(seen) >= 2
    for p, t in zip(stats["passes"], seen):
        expect = min(0.9, max(1e-4, 0.5 * tol / p["rel_start"]))
        assert t == pytest.approx(expect) and p["inner_tol"] == pytest.approx(expect)


# --- sequestration time --------------------------------------------------------------


def test_sequestration_matches_jax_and_direct(jax_T, T, topo, wet, indices, gridmetrics):
    gamma, res = P.sequestration_time(T, wet, topo, tol=1e-10)
    assert res < 1e-9
    w = wet.numpy()
    assert np.isfinite(gamma.numpy()[w]).all() and bool(torch.isnan(gamma[~wet]).all())
    ref, _ = J.sequestration_time(jax_T, indices.wet3d, gridmetrics.topology, tol=1e-10)
    np.testing.assert_allclose(gamma.numpy()[w], np.asarray(ref)[w], rtol=1e-6, atol=1e-4)
    direct = _direct(jax_T, indices, gridmetrics.topology, wet.double(),
                     extra=_surf(wet).numpy(), transpose=True)
    np.testing.assert_allclose(gamma.numpy()[w], direct, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("algorithm", ["bicgstab", "bicgstab2"])
def test_sequestration_time_iterative_refinement(jax_T, T, topo, wet, indices, gridmetrics,
                                                 algorithm):
    """The refined transpose solve reaches below the f32 floor through
    either inner algorithm, and matches otmb_tpu's refined solve."""
    stats = {}
    gd, res = P.sequestration_time(T.to(torch.float32), wet, topo, tol=1e-9, refine=True,
                                   algorithm=algorithm, stats=stats)
    assert res < 1e-9 and gd.dtype == torch.float64
    w = wet.numpy()
    assert np.isfinite(gd.numpy()[w]).all()
    ref, jres = J.sequestration_time(_c32(jax_T), indices.wet3d, gridmetrics.topology,
                                     tol=1e-9, refine=True)
    assert float(jres) < 1e-9
    np.testing.assert_allclose(gd.numpy()[w], np.asarray(ref)[w], rtol=1e-6, atol=1e-4)


def test_sequestration_bicgstab2_matches_bicgstab(T, topo, wet):
    ref, _ = P.sequestration_time(T, wet, topo, tol=1e-10)
    out, res = P.sequestration_time(T, wet, topo, tol=1e-10, algorithm="bicgstab2")
    assert res < 1e-9
    w = wet.numpy()
    np.testing.assert_allclose(out.numpy()[w], ref.numpy()[w], rtol=1e-6, atol=1e-4)


def test_ideal_age_bicgstab2_matches_bicgstab(T, topo, wet, age64):
    out, res = P.ideal_age(T, wet, topo, tol=1e-10, algorithm="bicgstab2")
    assert res < 1e-9
    w = wet.numpy()
    np.testing.assert_allclose(out.numpy()[w], age64.numpy()[w], rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="algorithm"):
        P.ideal_age(T, wet, topo, algorithm="cg")


# --- the reference faults the port does not carry ------------------------------


@pytest.mark.parametrize("inner", ["bicgstab", "bicgstab2"])
def test_ir_stops_at_the_first_stalled_pass(jax_T, T, topo, wet, gridmetrics, inner):
    """Inner solves with no budget cannot contract the defect: the passes
    log ends at the first unimproved pass, which is not a revert, with
    stagnated: True. The reference repeats that pass once more."""
    b = wet.float()
    stats = {}
    with pytest.warns(UserWarning, match="stagnated"):
        x, res = P.solve_shifted_ir(T.to(torch.float32), b, topo, shift=1e-3, tol=1e-9,
                                    maxiter=0, inner_algorithm=inner, stats=stats)
    passes = stats["passes"]
    assert [p.get("stagnated", False) for p in passes] == [False, True]
    assert not any(p["reverted"] for p in passes)
    assert passes[-1]["rel_start"] >= 0.9 * passes[-2]["rel_start"]
    assert stats["refinements"] == 2 and res == pytest.approx(1.0) and bool((x == 0).all())
    if inner == "bicgstab":
        jstats = {}
        with pytest.warns(UserWarning, match="stagnated"):
            J.solve_shifted_ir(_c32(jax_T), b.numpy(), gridmetrics.topology, shift=1e-3,
                               tol=1e-9, maxiter=0, stats=jstats)
        assert jstats["refinements"] == 3


def test_nonfinite_recurrence_stops_after_the_jitter_budget(T, topo, wet):
    """The exactly skew system: BiCGStab(2) diverges without progress (so the
    divergence exit, its one jittered restart spent, lets it run), then goes
    non-finite. The engine stops at that chunk with stop="diverged" and the
    best iterate, x0 = 0; one chunk fewer and it would still be running."""
    b = _rand_b(wet, 5, torch.float32)
    kw = dict(tol=1e-300, chunk=10, max_restarts=0, early_stop=False,
              max_diverge_restarts=1, algorithm="bicgstab2", fused=False)
    skew = _skew(T, wet, 0.0)
    stats = {}
    x, res = P.solve_shifted_chunked(skew, b, topo, maxiter=5000, stats=stats, **kw)
    assert stats["stop"] == "diverged" and stats["diverge_restarts"] == 1
    assert stats["iters"] < 5000
    assert bool((x == 0).all()) and res == pytest.approx(1.0)
    before = {}
    P.solve_shifted_chunked(skew, b, topo, maxiter=stats["iters"] - 10, stats=before, **kw)
    assert before["stop"] == "maxiter" and before["diverge_restarts"] == 1


def test_nonfinite_recurrence_stops_where_the_reference_runs_on(jax_T, T, topo, wet, indices,
                                                                gridmetrics, monkeypatch):
    """One scripted recurrence through both engines' host logic: 40x the
    starting residual for the first 20 matvec pairs (two chunks: no
    progress, jitter budget 0, so the divergence exit goes dormant), NaN
    after. otmb_tpu runs out maxiter; the port stops at the NaN chunk."""
    b = _rand_b(wet, 5, torch.float32)
    bn2 = float(torch.dot(b.flatten(), b.flatten()))
    rn2 = lambda pairs: (40.0 if pairs <= 20 else float("nan")) * bn2
    done = {"port": 0, "jax": 0}

    def port_cycles(sys_, step, st, ncycles):
        done["port"] += 2 * ncycles
        v = torch.tensor(rn2(done["port"]), dtype=torch.float32).sqrt()
        return st._replace(r=torch.where(wet, v, 0.0) / float(wet.sum()) ** 0.5)

    def jax_chunk(c_l, mc_l, md_l, state, ncycles, *args):
        done["jax"] += 2 * ncycles
        return state, rn2(done["jax"])

    monkeypatch.setattr(S, "_bicgstab2_cycles", port_cycles)
    monkeypatch.setattr(J, "_sr_chunk2", jax_chunk)
    kw = dict(tol=1e-6, chunk=10, maxiter=200, max_restarts=0, max_diverge_restarts=0,
              algorithm="bicgstab2", fused=False)
    stats, jstats = {}, {}
    P.solve_shifted_chunked(_skew(T, wet, 0.0), b, topo, stats=stats, **kw)
    J.solve_shifted_chunked(_jax_skew(jax_T, indices, 0.0), b.numpy(), gridmetrics.topology,
                            stats=jstats, **kw)
    assert stats["stop"] == "diverged" and stats["iters"] == 30
    assert jstats["stop"] == "maxiter" and jstats["iters"] == 200


def test_jittered_restart_seeds_rho_from_rhat(jax_T, T, topo, wet, gridmetrics):
    """The BiCGStab(1) restart's rho is <rhat, r> for the jittered rhat;
    the reference seeds <r, r>."""
    b = _rand_b(wet, 9, torch.float32)
    sys_ = S._system(T, torch.float32, topo)
    x = 0.3 * _rand_b(wet, 10, torch.float32)
    for jitter in (1, 2, 3):
        st = S._restart_state(sys_, "bicgstab", None, x, b, jitter)
        assert torch.equal(st.rho, torch.dot(st.rhat.flatten(), st.r.flatten()))
        assert not torch.equal(st.rho, torch.dot(st.r.flatten(), st.r.flatten()))
    jst = J._sr_restart1(_c32(jax_T), x.numpy(), b.numpy(), gridmetrics.topology, True, 1)
    r, rhat, rho = (np.asarray(a, np.float64) for a in (jst[1], jst[3], jst[4]))
    assert rho == pytest.approx(float(r.ravel() @ r.ravel()), rel=1e-5)
    assert abs(rho - float(rhat.ravel() @ r.ravel())) > 1e-3 * abs(rho)
