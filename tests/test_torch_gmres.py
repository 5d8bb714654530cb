"""otmb_tpu_torch's GMRES(30) and implicit Euler step against otmb_tpu's
(`solve_shifted(method="gmres")`, `implicit_euler_step`) and against scipy
direct solves, in f64 on the CPU, on both topologies.

The port's GMRES is right-preconditioned and stops on the true residual
||b - A x|| <= tol ||b||; jax's is left-preconditioned and stops on the
preconditioned residual. So the tests hold solutions and each package's
own true residual, never iteration counts. At tol 1e-12 jax's own stopping
test is never met on these grids (its true residual is ~1e-15 after its
first cycles, and it then runs its whole budget of restart cycles, ~15 s a
solve), so its GMRES runs here with a budget of 20 cycles, or inside the
refined solves, whose passes ask for looser tolerances.
"""

import math

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
from otmb_tpu_torch.utils import debugging
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

# Both solves stop at a true residual near 1e-14 on these grids; the
# solutions agree to that residual times the system's conditioning.
TOL_MATCH = 1e-9


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
def topo(gridmetrics):
    t = gridmetrics.topology
    return P.GridTopology(t.kind, t.nx, t.ny, t.nz)


@pytest.fixture(scope="module")
def wet(indices):
    return torch.from_numpy(np.array(indices.wet3d))


def _surf(wet):
    s = torch.zeros(wet.shape, dtype=torch.float64)
    s[0] = 1.0
    return torch.where(wet, s, 0.0)


def _rand(wet, seed):
    rng = np.random.default_rng(seed)
    return torch.where(wet, torch.from_numpy(rng.standard_normal(tuple(wet.shape))), 0.0)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


CASES = {  # (shift, surface restoring, preconditioner)
    "shifted": (1e-5, False, "tridiag"),
    "age system": (0.0, True, "tridiag"),
    "age system, jacobi": (0.0, True, "jacobi"),  # several restart cycles
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("transpose", [False, True])
def test_gmres_matches_jax_and_direct(T, jax_T, topo, wet, indices, gridmetrics, case,
                                      transpose):
    shift, restoring, precond = CASES[case]
    b = _rand(wet, 5)
    extra = _surf(wet) if restoring else None
    stats = {}
    x, res = P.solve_shifted(T, b, topo, shift=shift, extra_diag=extra, tol=1e-12,
                             transpose=transpose, preconditioner=precond, algorithm="gmres",
                             stats=stats)
    xj, res_j = J.solve_shifted(jax_T, b.numpy(), gridmetrics.topology, shift=shift,
                                extra_diag=None if extra is None else extra.numpy(), tol=1e-12,
                                method="gmres", transpose=transpose, preconditioner=precond,
                                apply_impl="jnp", maxiter=20)
    assert res <= 1e-12 and float(res_j) <= 1e-12
    assert stats["stop"] == "converged" and stats["iters"] == 30 * stats["cycles"]
    assert _rel(x.numpy(), xj) <= TOL_MATCH
    mat = coeffs_to_scipy(jax_T, indices, gridmetrics.topology)
    a = (mat.T if transpose else mat) + shift * sp.identity(mat.shape[0])
    if extra is not None:
        a = a + sp.diags(wet_vector(extra.numpy(), indices))
    direct = spla.spsolve(a.tocsc(), wet_vector(b.numpy(), indices))
    assert _rel(x.numpy()[wet.numpy()], direct) <= TOL_MATCH


@pytest.fixture(scope="module")
def implicit_case(jax_T, wet, gridmetrics):
    """A tracer, dt far beyond the explicit CFL limit, and otmb_tpu's step
    (its BiCGStab; its GMRES gives the same step in its whole budget)."""
    rng = np.random.default_rng(2)
    chi = np.where(wet.numpy(), 1.0 + 0.1 * rng.standard_normal(tuple(wet.shape)), 0.0)
    dt = 1e5
    out_j, res_j = J.implicit_euler_step(jax_T, chi, dt, gridmetrics.topology, tol=1e-12)
    assert float(res_j) < 1e-8
    return chi, dt, np.asarray(out_j)


@pytest.mark.parametrize("algorithm", ["bicgstab", "gmres"])
def test_implicit_euler_step_matches_jax_and_direct(T, jax_T, topo, wet, indices,
                                                    gridmetrics, implicit_case, algorithm):
    """Mirrors tests/test_solvers.py:47 and holds the step to otmb_tpu's."""
    chi, dt, out_j = implicit_case
    out, res = P.implicit_euler_step(T, torch.from_numpy(chi), dt, topo, tol=1e-12,
                                     algorithm=algorithm)
    assert res <= 1e-12
    assert _rel(out.numpy(), out_j) <= TOL_MATCH
    mat = coeffs_to_scipy(jax_T, indices, gridmetrics.topology)
    direct = spla.spsolve((sp.identity(mat.shape[0]) + dt * mat).tocsc(),
                          wet_vector(chi, indices))
    assert _rel(out.numpy()[wet.numpy()], direct) <= TOL_MATCH
    # a step conserves tracer mass: v' T = 0 up to the operator's rounding
    v = np.nan_to_num(np.asarray(gridmetrics.v3d))
    assert abs((out.numpy() * v).sum() - (chi * v).sum()) <= 1e-10 * abs((chi * v).sum())


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("workload", ["ideal_age", "sequestration_time"])
def test_workloads_with_gmres_match_jax(T, jax_T, topo, wet, gridmetrics, indices, refine,
                                        workload):
    """The port's GMRES workloads, refined or not, against otmb_tpu's refined
    ones with method="gmres" (see the module docstring)."""
    stats = {}
    out, res = getattr(P, workload)(T, wet, topo, tol=1e-12, refine=refine,
                                    algorithm="gmres", stats=stats)
    ref, res_j = getattr(J, workload)(jax_T, indices.wet3d, gridmetrics.topology, tol=1e-12,
                                      refine=True, method="gmres")
    w = wet.numpy()
    assert res <= 1e-12 and float(res_j) < 1e-10
    assert np.isnan(out.numpy()[~w]).all()
    assert _rel(out.numpy()[w], np.asarray(ref)[w]) <= TOL_MATCH
    if refine:
        assert all(p["inner_stop"] in ("converged", "stall") for p in stats["passes"])


def test_refined_f32_gmres_reaches_f64_tolerance(T, topo, wet):
    """f32 inner GMRES solves with f64 defects reach 1e-10 and the f64 age
    of the f32-rounded operator."""
    c32 = T.to(torch.float32)
    ref, _ = P.ideal_age(c32.to(torch.float64), wet, topo, tol=1e-12)
    stats = {}
    out, res = P.ideal_age(c32, wet, topo, tol=1e-10, refine=True,
                           algorithm="gmres", stats=stats)
    assert res <= 1e-10 and out.dtype == torch.float64
    assert stats["refinements"] >= 2
    w = wet.numpy()
    assert _rel(out.numpy()[w], ref.numpy()[w]) <= 1e-8


def test_bf16_narrow_gmres_keeps_f32_vectors(T, topo, wet, monkeypatch):
    """bf16 coefficients: the inner GMRES runs on f32 vectors (K1's (bf16,
    f32) entry, M on f32 legs) and the refinement converges against the
    bf16-rounded operator, to the BiCGStab(1) solution of the same system."""
    seen = []
    arnoldi = S._arnoldi

    def spy(sys_, v0, m):
        seen.append((sys_.a.diag.dtype, v0.dtype, sys_.m_legs[1].dtype))
        return arnoldi(sys_, v0, m)

    monkeypatch.setattr(S, "_arnoldi", spy)
    c16 = T.to(torch.bfloat16)
    out, res = P.ideal_age(c16, wet, topo, tol=1e-10, refine=True, algorithm="gmres")
    ref, res_b = P.ideal_age(c16, wet, topo, tol=1e-10, refine=True, algorithm="bicgstab")
    assert res <= 1e-10 and res_b <= 1e-10
    assert seen and set(seen) == {(torch.bfloat16, torch.float32, torch.float32)}
    w = wet.numpy()
    assert _rel(out.numpy()[w], ref.numpy()[w]) <= 1e-8


def test_gmres_budget_cuts_the_last_cycle(T, topo, wet):
    """maxiter counts Arnoldi steps: 45 = one cycle of 30 and one of 15; the
    residual returned is the true one."""
    stats = {}
    _, res = P.solve_shifted_chunked(T, _rand(wet, 7), topo, extra_diag=_surf(wet), tol=1e-300,
                                     maxiter=45, preconditioner="jacobi", algorithm="gmres",
                                     early_stop=False, stats=stats)
    assert stats["iters"] == 45 and stats["cycles"] == 2 and stats["stop"] == "maxiter"
    assert 0.0 < res < 1e-3 and stats["end_rel"] == pytest.approx(res, rel=1e-6)


def test_gmres_stalls_at_the_f32_floor(T, topo, wet):
    """An unreachable tol in f32: three cycles without 2 % of gain stop
    the solve with a warning, long before maxiter."""
    stats = {}
    with pytest.warns(UserWarning, match="improved <2%"):
        _, res = P.solve_shifted_chunked(T.to(torch.float32), _rand(wet, 7).float(), topo,
                                         extra_diag=_surf(wet).float(), tol=1e-30,
                                         maxiter=3000, algorithm="gmres", stats=stats)
    assert stats["stop"] == "stall" and stats["iters"] < 3000
    assert res < 1e-4


def test_gmres_nonfinite_stops_and_nan_debugging_raises(T, topo, wet):
    bad = T._replace(east=torch.where(wet, T.east, 0.0).clone())
    k, j, i = (int(v[0]) for v in torch.nonzero(wet, as_tuple=True))
    bad.east[k, j, i] = float("nan")
    stats = {}
    x, res = P.solve_shifted(bad, _rand(wet, 3), topo, algorithm="gmres", stats=stats)
    # the best iterate is x0 = 0; its residual, recomputed on the NaN leg, is NaN
    assert stats["stop"] == "diverged" and stats["cycles"] == 1
    assert not bool(x.any()) and math.isnan(res)
    try:
        debugging.enable_nan_debugging()
        with pytest.raises(FloatingPointError, match="GMRES cycle"):
            P.solve_shifted(bad, _rand(wet, 3), topo, algorithm="gmres")
        with pytest.raises(FloatingPointError, match="recurrence residual"):
            P.solve_shifted(bad, _rand(wet, 3), topo, algorithm="bicgstab")
    finally:
        debugging.enable_nan_debugging(False)
    assert not debugging.NAN_DEBUG


def test_gmres_takes_fields_only(T, topo, wet):
    b = wet.double()[None].repeat(2, 1, 1, 1)
    with pytest.raises(ValueError, match="one field"):
        P.solve_shifted_chunked(T, b, topo, algorithm="gmres")
    with pytest.raises(ValueError, match="algorithm"):
        P.solve_shifted_chunked_multi(T, b, topo, algorithm="gmres")


def test_stacked_dot_is_one_projection_per_basis_vector(wet):
    V = torch.stack([_rand(wet, s) for s in range(4)])
    w = _rand(wet, 9)
    got = S._dot(V, w)
    want = torch.stack([torch.dot(v.reshape(-1), w.reshape(-1)) for v in V])
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0)


def test_arnoldi_basis_is_orthonormal(T, topo, wet):
    """Classical Gram-Schmidt with one re-orthogonalisation keeps the basis
    orthonormal to rounding, and A M V[:m] = V H (the Arnoldi relation)."""
    sys_ = S._system(T, torch.float64, topo, extra_diag=_surf(wet))
    b = _rand(wet, 11)
    V, H = S._arnoldi(sys_, b / torch.linalg.vector_norm(b), 12)
    flat = V.reshape(13, -1)
    torch.testing.assert_close(flat @ flat.T, torch.eye(13, dtype=torch.float64), rtol=0,
                               atol=1e-12)
    AMV = torch.stack([sys_.apply(sys_.M(v)) for v in V[:12]]).reshape(12, -1)
    torch.testing.assert_close(AMV.T, flat.T @ H, rtol=0, atol=1e-12 * float(AMV.abs().max()))
