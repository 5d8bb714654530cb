"""otmb_tpu_torch's autodiff layer (`ops/autodiff.py`) against otmb_tpu's
(`jax.grad` through `apply_stencil_ad`, `euler_step_ad` and
`differentiable_solve`), against torch's own autograd through the plain
apply, and against finite differences, in f64 on the CPU, on the 12x8x5
cases of tests/test_autodiff.py (both topologies).

Mirrors its six tests; the sharded adjoint (its `:209`) is in
tests/test_torch_parallel_ad.py. Adds the autograd chain of the plain
`assemble_transport` to kappa_h, kappa_VML and kappa_Vdeep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.grid.geometry import makegridmetrics as jax_makegridmetrics
from otmb_tpu.grid.indices import makeindices as jax_makeindices
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops import autodiff as JA
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.utils.synthetic import synthetic_dataset as jax_synthetic_dataset
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

# jax.grad of the reference and the port's rules compute the same
# expressions in the same precision; the solves' adjoints agree to their
# residuals (tol 1e-13) times the systems' conditioning.
TOL_GRAD = 1e-10


@pytest.fixture(scope="module", params=["bipolar", "tripolar"])
def case(request):
    ds = jax_synthetic_dataset(nx=12, ny=8, nz=5, topology=request.param, seed=9)
    gm = jax_makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                             lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                             lat_vertices=ds.lat_vertices)
    idx = jax_makeindices(gm.v3d)
    phi = jax_faceflux(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    jT = jax_transportmatrix(phi=phi, mlotst=ds.mlotst, gridmetrics=gm, indices=idx).T
    wet = np.asarray(idx.wet3d)
    rng = np.random.default_rng(3)
    chi = np.where(wet, rng.standard_normal(gm.shape), 0.0)
    w = np.where(wet, rng.standard_normal(gm.shape), 0.0)
    t = gm.topology
    T = coeffs_from_numpy({leg: np.asarray(jT[leg]) for leg in jT._fields}, device="cpu")
    return dict(ds=ds, jT=jT, jtopo=t, T=T, topo=P.GridTopology(t.kind, t.nx, t.ny, t.nz),
                wet=wet, chi=chi, w=w)


def _leaf(c):
    return P.StencilCoeffs(*(leg.clone().requires_grad_(True) for leg in c))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(np.abs(a).max())


def _port_grads(loss, T, chi):
    c, x = _leaf(T), torch.from_numpy(chi).requires_grad_(True)
    loss(c, x).backward()
    return [leg.grad.numpy() for leg in c], x.grad.numpy()


def test_apply_grads_match_jax_and_native_autograd(case):
    T, topo, w = case["T"], case["topo"], torch.from_numpy(case["w"])
    gc, gx = _port_grads(lambda c, x: (w * P.apply_stencil_ad(c, x, topo) ** 2).sum(),
                         T, case["chi"])
    rc, rx = _port_grads(lambda c, x: (w * P.apply_stencil(c, x, topo) ** 2).sum(),
                         T, case["chi"])
    jw = jnp.asarray(case["w"])
    jc, jx = jax.grad(lambda c, x: jnp.sum(jw * JA.apply_stencil_ad(c, x, case["jtopo"], "jnp")
                                           ** 2), argnums=(0, 1))(case["jT"],
                                                                  jnp.asarray(case["chi"]))
    assert _rel(gx, rx) <= 1e-12 and _rel(gx, jx) <= TOL_GRAD
    for leg, a, b, j in zip(T._fields, gc, rc, jc):
        assert _rel(a, b) <= 1e-12, leg
        assert _rel(a, j) <= TOL_GRAD, leg


def test_euler_chain_grads_match_jax_and_native_autograd(case):
    """Gradient through a 5-step propagation loop."""
    T, topo, w = case["T"], case["topo"], torch.from_numpy(case["w"])
    dt = 200.0

    def chain(step):
        def loss(c, x):
            for _ in range(5):
                x = step(c, x)
            return (w * x ** 2).sum()
        return loss

    gc, gx = _port_grads(chain(lambda c, v: P.euler_step_ad(c, v, dt, topo)), T, case["chi"])
    rc, rx = _port_grads(chain(lambda c, v: v - dt * P.apply_stencil(c, v, topo)), T,
                         case["chi"])
    jw = jnp.asarray(case["w"])

    def jloss(c, x):
        out, _ = jax.lax.scan(lambda v, _: (JA.euler_step_ad(c, v, dt, case["jtopo"], "jnp"),
                                            None), x, None, length=5)
        return jnp.sum(jw * out ** 2)

    jc, jx = jax.grad(jloss, argnums=(0, 1))(case["jT"], jnp.asarray(case["chi"]))
    assert _rel(gx, rx) <= 1e-12 and _rel(gx, jx) <= TOL_GRAD
    for leg, a, b, j in zip(T._fields, gc, rc, jc):
        assert _rel(a, b) <= 1e-12, leg
        assert _rel(a, j) <= TOL_GRAD, leg


def test_solve_adjoint_matches_jax_and_finite_differences(case):
    T, topo, wet = case["T"], case["topo"], case["wet"]
    w = torch.from_numpy(case["w"])
    b0 = np.where(wet, 1.0, 0.0)
    shift0 = 1e-5
    solve = P.differentiable_solve(topo, tol=1e-13)

    def loss(coeffs, b, s):
        return (w * solve(coeffs, b, s, None)).sum()

    c = _leaf(T)
    b = torch.from_numpy(b0).requires_grad_(True)
    s = torch.tensor(shift0, dtype=torch.float64, requires_grad=True)
    loss(c, b, s).backward()

    jsolve = JA.differentiable_solve(case["jtopo"], tol=1e-13)
    jw = jnp.asarray(case["w"])
    jc, jb, js = jax.grad(lambda cc, bb, ss: jnp.sum(jw * jsolve(cc, bb, ss, None)),
                          argnums=(0, 1, 2))(case["jT"], jnp.asarray(b0), jnp.asarray(shift0))
    assert _rel(b.grad.numpy(), jb) <= TOL_GRAD
    assert abs(float(s.grad) - float(js)) <= TOL_GRAD * abs(float(js))
    for leg, a, j in zip(T._fields, c, jc):
        assert _rel(a.grad.numpy(), j) <= TOL_GRAD, leg

    with torch.no_grad():
        # finite differences on the shift, a few b entries, a diag and an east entry
        eps = 1e-9
        fd = (loss(T, b, shift0 + eps) - loss(T, b, shift0 - eps)) / (2 * eps)
        np.testing.assert_allclose(float(s.grad), float(fd), rtol=2e-4)
        ks, js_, is_ = np.nonzero(wet)
        rng = np.random.default_rng(0)
        for t in rng.choice(len(ks), size=3, replace=False):
            cell = (ks[t], js_[t], is_[t])
            bp, bm = b.detach().clone(), b.detach().clone()
            bp[cell] += 1e-6
            bm[cell] -= 1e-6
            fd = (loss(T, bp, shift0) - loss(T, bm, shift0)) / 2e-6
            np.testing.assert_allclose(float(b.grad[cell]), float(fd), rtol=5e-5)
        for leg in ("diag", "east"):
            arr = T[leg]
            live = torch.nonzero(arr.abs() > 1e-12)
            cell = tuple(live[rng.choice(len(live))].tolist())
            eps = max(1e-7 * abs(float(arr[cell])), 1e-13)
            plus, minus = arr.clone(), arr.clone()
            plus[cell] += eps
            minus[cell] -= eps
            fd = (loss(T._replace(**{leg: plus}), b, shift0)
                  - loss(T._replace(**{leg: minus}), b, shift0)) / (2 * eps)
            np.testing.assert_allclose(float(getattr(c, leg).grad[cell]), float(fd), rtol=1e-3)


def test_solve_adjoint_extra_diag_and_scalar(case):
    """extra_diag cotangents: the per-cell field and the scalar forms."""
    T, topo, wet = case["T"], case["topo"], case["wet"]
    w = torch.from_numpy(case["w"])
    b = torch.from_numpy(np.where(wet, 1.0, 0.0))
    surf = np.where(wet & (np.arange(wet.shape[0])[:, None, None] == 0), 1e-3, 0.0)
    solve = P.differentiable_solve(topo, tol=1e-13)
    loss = lambda e: (w * solve(T, b, 1e-5, e)).sum()

    e = torch.from_numpy(surf).requires_grad_(True)
    loss(e).backward()
    jsolve = JA.differentiable_solve(case["jtopo"], tol=1e-13)
    jw = jnp.asarray(case["w"])
    je = jax.grad(lambda ee: jnp.sum(jw * jsolve(case["jT"], jnp.asarray(b.numpy()), 1e-5,
                                                 ee)))(jnp.asarray(surf))
    assert _rel(e.grad.numpy(), je) <= TOL_GRAD
    cell = (0,) + tuple(np.argwhere(wet[0])[0])
    with torch.no_grad():
        sp_, sm = torch.from_numpy(surf.copy()), torch.from_numpy(surf.copy())
        sp_[cell] += 1e-9
        sm[cell] -= 1e-9
        fd = (loss(sp_) - loss(sm)) / 2e-9
    np.testing.assert_allclose(float(e.grad[cell]), float(fd), rtol=1e-3)

    es = torch.tensor(1e-4, dtype=torch.float64, requires_grad=True)
    loss(es).backward()
    with torch.no_grad():
        f64 = lambda v: torch.tensor(v, dtype=torch.float64)
        fd = (loss(f64(1e-4 + 1e-10)) - loss(f64(1e-4 - 1e-10))) / 2e-10
    np.testing.assert_allclose(float(es.grad), float(fd), rtol=2e-4)


def _port_case(case):
    """The port's own grid for the case, its transports and wet mask."""
    ds = case["ds"]
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    wet = P.makeindices(gm.v3d).wet3d
    umo, vmo = (torch.from_numpy(np.nan_to_num(a)) for a in (ds.umo, ds.vmo))
    return ds, gm, wet, umo, vmo


def test_kappa_calibration_gradient(case):
    """d(loss)/d(kappa_h) through the plain assembly and the implicit solve,
    against central differences (tests/test_autodiff.py:176-206)."""
    ds, gm, wet, umo, vmo = _port_case(case)
    w = torch.from_numpy(case["w"])
    b = wet.double()
    solve = P.differentiable_solve(gm.topology, tol=1e-13)

    def loss(kappa_h):
        T = P.assemble_transport(umo, vmo, ds.mlotst, gm, wet, kappa_h=kappa_h).T
        return (w * solve(T, b, 1e-5, None)).sum()

    k = torch.tensor(500.0, dtype=torch.float64, requires_grad=True)
    loss(k).backward()
    g = float(k.grad)
    with torch.no_grad():
        eps = 5.0
        fd = float((loss(torch.tensor(500.0 + eps, dtype=torch.float64))
                    - loss(torch.tensor(500.0 - eps, dtype=torch.float64)))
                   / (2 * eps))
    assert abs(g - fd) <= 2e-3 * max(abs(fd), abs(g)), (g, fd)


@pytest.mark.parametrize("kappa", ["kappa_h", "kappa_vml", "kappa_vdeep"])
def test_assemble_transport_carries_autograd_to_kappa(case, kappa):
    """The plain assembly is differentiable in each diffusivity: the autograd
    gradient of <w, T(kappa) chi> equals the exact one, the same product on
    the kappa-free operator part (T is affine in each kappa)."""
    ds, gm, wet, umo, vmo = _port_case(case)
    w, chi = torch.from_numpy(case["w"]), torch.from_numpy(case["chi"])
    k0 = {"kappa_h": 500.0, "kappa_vml": 0.1, "kappa_vdeep": 1e-5}[kappa]
    k = torch.tensor(k0, dtype=torch.float64, requires_grad=True)
    T = P.assemble_transport(umo, vmo, ds.mlotst, gm, wet, **{kappa: k}).T
    assert any(leg.requires_grad for leg in T)
    (w * P.apply_stencil(T, chi, gm.topology)).sum().backward()
    with torch.no_grad():
        at = lambda kv: (w * P.apply_stencil(P.assemble_transport(
            umo, vmo, ds.mlotst, gm, wet, **{kappa: kv}).T, chi, gm.topology)).sum()
        exact = float(at(1.0) - at(0.0))  # the slope of an affine function
    assert float(k.grad) == pytest.approx(exact, rel=1e-10)
    assert float(k.grad) != 0.0
