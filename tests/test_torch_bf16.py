"""The bf16-narrow refined solve of otmb_tpu_torch against otmb_tpu's, on
the CPU: bf16 coefficients stream into the inner matvecs while b, the
Krylov vectors and the Thomas legs of M stay f32, and the f64 defect
correction converges against the bf16-rounded operator (the JAX package's
`narrow_vec`, `otmb_tpu/models/solvers.py:solve_shifted_ir`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import otmb_tpu_torch as P
from otmb_tpu.models.solvers import ideal_age as jax_ideal_age
from otmb_tpu.models.solvers import sequestration_time as jax_sequestration_time
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu_torch.models import solvers

torch.set_num_threads(1)

TOL = 1e-8
# Both packages refine against the same bf16-rounded operator to TOL, from
# the same f32 inner solves up to their order of operations: their answers
# agree far inside the bf16 rounding of the coefficients (2^-8 ~ 0.4 %),
# which is what separates either from the f32 solve.
TOL_REFERENCE = 1e-6
TOL_BF16_FLOOR = 1e-2

WORKLOADS = {"ideal_age": (P.ideal_age, jax_ideal_age),
             "sequestration_time": (P.sequestration_time, jax_sequestration_time)}


@pytest.fixture(scope="module")
def port(dataset):
    gm = P.makegridmetrics(
        areacello=dataset.areacello, volcello=dataset.volcello, lon=dataset.lon,
        lat=dataset.lat, lev=dataset.lev, lon_vertices=dataset.lon_vertices,
        lat_vertices=dataset.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    phi = P.facefluxesfrommasstransport(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gm,
                                        indices=idx)
    T = P.transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gm, indices=idx).T
    return gm, idx, T


@pytest.fixture(scope="module")
def jax_T_bf16(dataset, gridmetrics, indices):
    phi = jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                       indices=indices)
    T = jax_transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                            indices=indices).T
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), T)


def _mean(x, v, wet):
    return float((x[wet] * v[wet]).sum() / v[wet].sum())


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_bf16_refined_solve_matches_jax(port, jax_T_bf16, gridmetrics, indices, workload):
    """No TypeError: the port answers where the reference does, with the
    same residual bound and the same ages on the same bf16 operator."""
    gm, idx, T = port
    ours, theirs = WORKLOADS[workload]
    wet = idx.wet3d.numpy()
    v = np.where(wet, gm.v3d.numpy(), 0.0)
    stats = {}
    got, res = ours(T.to(torch.bfloat16), idx.wet3d, gm.topology, tol=TOL, refine=True,
                    stats=stats)
    ref, ref_res = theirs(jax_T_bf16, indices.wet3d, gridmetrics.topology, tol=TOL,
                          refine=True, apply_impl="jnp")
    ref = np.asarray(ref)
    assert got.dtype == torch.float64 and bool(torch.isfinite(got[idx.wet3d]).all())
    assert res <= TOL and float(ref_res) <= TOL
    assert stats["refinements"] >= 1
    g = got.numpy()
    assert abs(_mean(g, v, wet) / _mean(ref, v, wet) - 1.0) <= TOL_REFERENCE
    assert np.abs(g[wet] - ref[wet]).max() <= TOL_REFERENCE * np.abs(ref[wet]).max()
    # the bf16 floor: the rounded operator's answer against the f32 one's
    f32, _ = ours(T.to(torch.float32), idx.wet3d, gm.topology, tol=TOL, refine=True)
    assert abs(_mean(g, v, wet) / _mean(f32.numpy(), v, wet) - 1.0) <= TOL_BF16_FLOOR


@pytest.mark.parametrize("inner_algorithm", ["bicgstab", "bicgstab2"])
def test_bf16_inner_solves_run_in_f32(port, monkeypatch, inner_algorithm):
    """Every inner matvec is K1's (bf16, f32) path, every defect the (f32,
    f64) one on the widened coefficients, and M solves f32 vectors on f32
    legs (K2 has no bf16 entry); BiCGStab(2) runs unfused (K3 neither)."""
    gm, idx, T = port
    applies, thomas = set(), set()
    apply = solvers.stencil_apply
    solve = solvers.tridiag_solve_factored

    def record_apply(c, x, topo):
        applies.add((c.diag.dtype, x.dtype))
        return apply(c, x, topo)

    def record_solve(cp, rden, upper, b):
        thomas.add((cp.dtype, upper.dtype, b.dtype))
        return solve(cp, rden, upper, b)

    monkeypatch.setattr(solvers, "stencil_apply", record_apply)
    monkeypatch.setattr(solvers, "tridiag_solve_factored", record_solve)
    monkeypatch.setattr(solvers, "fused_krylov_step", None)  # K3 must not be reached
    wet = idx.wet3d
    surf = torch.zeros(gm.shape, dtype=torch.bfloat16)
    surf[0] = 1.0
    stats = {}
    x, res = solvers.solve_shifted_ir(T.to(torch.bfloat16), wet.to(torch.bfloat16),
                                      gm.topology, extra_diag=torch.where(wet, surf, 0.0),
                                      tol=TOL, stats=stats, inner_algorithm=inner_algorithm)
    assert x.dtype == torch.float64 and res <= TOL
    f32, bf16 = torch.float32, torch.bfloat16
    assert applies == {(bf16, f32), (f32, torch.float64)}
    assert thomas == {(f32, f32, f32)}
    assert all(p["inner_iters"] > 0 for p in stats["passes"])


def test_bf16_fused_solve_is_refused(port):
    gm, idx, T = port
    b = idx.wet3d.to(torch.float32)
    surf = torch.zeros(gm.shape, dtype=torch.float32)
    surf[0] = 1.0
    kw = dict(extra_diag=torch.where(idx.wet3d, surf, 0.0), algorithm="bicgstab2")
    with pytest.raises(ValueError, match="K3"):
        P.solve_shifted_chunked(T.to(torch.bfloat16), b, gm.topology, fused=True, **kw)
    x, res = P.solve_shifted_chunked(T.to(torch.bfloat16), b, gm.topology, tol=1e-4, **kw)
    assert x.dtype == torch.float32 and res <= 1e-4
