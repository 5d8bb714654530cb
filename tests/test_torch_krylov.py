"""The plain version of the K3 fused Krylov step against the Pallas kernel
it replaces (`otmb_tpu.ops.krylov_pallas.fused_krylov_step`, in interpret
mode, as the JAX package's own tests run it on the CPU), its wrapper's
input checks, and the plain version of the K10 bandwidth probe. The CUDA
kernels themselves are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Missing neighbours read 0 in the port (as in K1), while the Pallas kernel
clamps k+1 at the floor, j-1 at the south edge and, on a bipolar grid,
reads row ny-1 itself above the top row. Real operators have zero legs
there; the random legs below are zeroed there too, so both kernels see the
same operator.
"""

import numpy as np
import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu.grid.topology import GridTopology as JaxTopology
from otmb_tpu.ops.coeffs import StencilCoeffs as JaxCoeffs
from otmb_tpu.ops.krylov_pallas import fused_krylov_step as jax_fused_krylov_step
from otmb_tpu_torch import _build
from otmb_tpu_torch.ops import krylov
from otmb_tpu_torch.ops.krylov import fused_krylov_step_plain, krylov_scratch
from otmb_tpu_torch.ops.tridiag import tridiag_solve_plain
from otmb_tpu_torch.utils import profiling
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

LEGS = ("diag", "east", "west", "north", "south", "top", "bottom")


def _case(nz, ny, nx, kind, dtype=np.float32, seed=0, land=True):
    """Random legs, zero on land (the operator invariant) and across every
    missing neighbour; Thomas legs from the vertical legs, the diagonal
    guarded on land as the engine does; x1, x2, rhat random on wet cells."""
    rng = np.random.default_rng(seed)
    wet = np.ones((nz, ny, nx), bool)
    if land:
        wet[:, ny // 3, : nx // 4] = False          # a land strip
        wet[nz // 2:, ny // 2, nx // 2] = False     # partial column
        wet[:, 1, 1] = False                        # full land column
    w = wet.astype(dtype)
    f = lambda: (w * rng.standard_normal((nz, ny, nx))).astype(dtype)
    legs = {"diag": 2.0 + np.abs(f())}
    for leg in LEGS[1:]:
        legs[leg] = 0.1 * f()
    legs = {k: (v * w).astype(dtype) for k, v in legs.items()}
    legs["bottom"][-1] = 0.0
    legs["top"][0] = 0.0
    legs["south"][:, 0] = 0.0
    if kind == "bipolar":
        legs["north"][:, -1] = 0.0
    m = (legs["bottom"], np.where(legs["diag"] != 0, legs["diag"], dtype(1.0)), legs["top"])
    return legs, m, f(), f(), f()


def _port(legs, m, *vecs):
    dtype = torch.from_numpy(legs["diag"]).dtype
    return ((coeffs_from_numpy(legs, dtype=dtype, device="cpu"),)
            + tuple(torch.from_numpy(a.copy()) for a in (*m, *vecs)))


def _jax(legs, m, x1, x2, c2, rhat, kind, **kw):
    nz, ny, nx = x1.shape
    topo = JaxTopology(kind=kind, nx=nx, ny=ny, nz=nz)
    z, out, d = jax_fused_krylov_step(JaxCoeffs(**legs), *m, x1, x2, c2, rhat, topo,
                                      interpret=True, **kw)
    return np.asarray(z), np.asarray(out), None if d is None else float(d)


TOL = {np.float32: dict(rtol=2e-5, atol=1e-5, d_rtol=1e-4),
       # f64: the Pallas kernel sums its dot from f32 partials
       np.float64: dict(rtol=1e-12, atol=1e-12, d_rtol=1e-6)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
def test_plain_matches_pallas(kind, dtype):
    nz, ny, nx = 7, 16, 24
    legs, m, x1, x2, rhat = _case(nz, ny, nx, kind, dtype)
    c2 = dtype(-0.37)
    z_j, out_j, d_j = _jax(legs, m, x1, x2, c2, rhat, kind)
    a, *mt, x1t, x2t, rhatt = _port(legs, m, x1, x2, rhat)
    topo = P.GridTopology(kind, nx, ny, nz)
    z, out, d = P.fused_krylov_step(a, *mt, x1t, x2t, float(c2), rhatt, topo)
    tol = TOL[dtype]
    np.testing.assert_allclose(z.numpy(), z_j, rtol=tol["rtol"], atol=tol["atol"])
    np.testing.assert_allclose(out.numpy(), out_j, rtol=tol["rtol"], atol=tol["atol"])
    assert d.dtype == z.dtype and d.ndim == 0
    np.testing.assert_allclose(float(d), d_j, rtol=tol["d_rtol"])


@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
def test_plain_no_combine_no_dot_matches_pallas(kind):
    nz, ny, nx = 5, 8, 16
    legs, m, x1, _, _ = _case(nz, ny, nx, kind, seed=3)
    _, out_j, d_j = _jax(legs, m, x1, None, 0.0, None, kind, with_combine=False,
                         with_dot=False)
    a, *mt, x1t = _port(legs, m, x1)
    z, out, d = P.fused_krylov_step(a, *mt, x1t, None, 0.0, None,
                                    P.GridTopology(kind, nx, ny, nz),
                                    with_combine=False, with_dot=False)
    assert z is x1t and d is None and d_j is None
    np.testing.assert_allclose(out.numpy(), out_j, rtol=2e-5, atol=1e-5)


def test_plain_land_stays_zero():
    nz, ny, nx = 6, 16, 16
    legs, m, x1, x2, rhat = _case(nz, ny, nx, "bipolar", seed=5)
    wet = legs["diag"] != 0
    a, *mt, x1t, x2t, rhatt = _port(legs, m, x1, x2, rhat)
    _, out, _ = P.fused_krylov_step(a, *mt, x1t, x2t, 0.5, rhatt,
                                    P.GridTopology("bipolar", nx, ny, nz))
    _, out_j, _ = _jax(legs, m, x1, x2, np.float32(0.5), rhat, "bipolar", by_static=8)
    assert np.all(out.numpy()[~wet] == 0.0) and np.all(out_j[~wet] == 0.0)
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
def test_plain_is_the_port_composition(kind, dtype):
    """z and out are exactly the combination, then the port's Thomas solve,
    then its stencil apply; d is their f64 dot, rounded once; a tensor c2
    works as a number does."""
    nz, ny, nx = 4, 9, 11
    legs, m, x1, x2, rhat = _case(nz, ny, nx, kind, np.float64, seed=8)
    a, *mt, x1t, x2t, rhatt = (t.to(dtype) for t in _port(legs, m, x1, x2, rhat))
    topo = P.GridTopology(kind, nx, ny, nz)
    c2 = torch.tensor(1.25, dtype=dtype)
    z, out, d = P.fused_krylov_step(a, *mt, x1t, x2t, c2, rhatt, topo)
    want_z = x1t + c2 * x2t
    want_out = P.stencil_apply(a, P.tridiag_solve(*mt, want_z), topo)
    assert torch.equal(z, want_z) and torch.equal(out, want_out)
    assert d.item() == float(torch.dot(rhatt.double().flatten(), out.double().flatten()).to(dtype))
    z2, out2, d2 = fused_krylov_step_plain(a, *mt, x1t, x2t, 1.25, rhatt, topo)
    assert torch.equal(z2, z) and torch.equal(out2, out) and torch.equal(d2, d)


def _bad_call(name):
    nz, ny, nx = 3, 5, 6
    legs, m, x1, x2, rhat = _case(nz, ny, nx, "tripolar", np.float64, seed=2)
    a, lo, di, up, x1t, x2t, rhatt = _port(legs, m, x1, x2, rhat)
    topo = P.GridTopology("tripolar", nx, ny, nz)
    args = dict(a_coeffs=a, m_lower=lo, m_diag=di, m_upper=up, x1=x1t, x2=x2t, c2=0.5,
                rhat=rhatt, topology=topo)
    if name == "half_values":
        args = {k: (v.half() if isinstance(v, torch.Tensor) else v) for k, v in args.items()}
        args["a_coeffs"] = a.to(torch.half)
    elif name == "bf16_coefficients":
        args["a_coeffs"] = a.to(torch.bfloat16)
    elif name == "mixed_dtypes":
        args["m_diag"] = di.float()
    elif name == "wrong_shape":
        args["rhat"] = rhatt[:, :-1]
    elif name == "noncontiguous":
        args["x2"] = x2t.transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "missing_x2":
        args["x2"] = None
    elif name == "unknown_topology":
        args["topology"] = P.GridTopology("unknown", nx, ny, nz)
    P.fused_krylov_step(**args)


@pytest.mark.parametrize("name", ["half_values", "bf16_coefficients", "mixed_dtypes",
                                  "wrong_shape", "noncontiguous", "missing_x2",
                                  "unknown_topology"])
def test_wrapper_rejects_bad_inputs(name):
    with pytest.raises((TypeError, ValueError)):
        _bad_call(name)


def test_cpu_path_launches_nothing():
    legs, m, x1, x2, rhat = _case(3, 6, 8, "bipolar", np.float64, seed=4)
    before = _build.calls(_build.KERNELS["K3"])
    P.fused_krylov_step(*_port(legs, m, x1, x2)[:6], 0.1, torch.from_numpy(rhat),
                        P.GridTopology("bipolar", 8, 6, 3))
    assert _build.calls(_build.KERNELS["K3"]) == before


def test_scratch_factors_the_thomas_legs():
    """The scratch carries cp and rden = 1/denom of the Thomas forward
    sweep (on the CPU from the plain factorization): a solve from them in
    K2's order equals the plain Thomas solve bit for bit. No dp field: the
    kernel keeps dp on chip. One f64 partial per thread block of the
    narrowest tile on one row, the most blocks a launch makes."""
    nz, ny, nx = 5, 31, 61
    legs, m, x1, _, _ = _case(nz, ny, nx, "tripolar", np.float64, seed=6)
    *mt, x1t = _port(legs, m, x1)[1:]
    s = krylov_scratch(*mt)
    assert s._fields == ("cp", "rden", "partials", "legs")
    assert s.cp.shape == s.rden.shape == (nz, ny, nx)
    assert s.partials.dtype == torch.float64
    assert s.partials.numel() == (-(-nx // krylov.MIN_OWN)) * ny
    dp, dp_prev = torch.empty_like(x1t), torch.zeros_like(x1t[0])
    for k in range(nz):
        dp_prev = dp[k] = (x1t[k] - mt[2][k] * dp_prev) * s.rden[k]
    x, x_next = torch.empty_like(x1t), torch.zeros_like(x1t[0])
    for k in range(nz - 1, -1, -1):
        x_next = x[k] = dp[k] - s.cp[k] * x_next
    assert torch.equal(x, P.tridiag_solve(*mt, x1t))
    with pytest.raises(TypeError):
        krylov_scratch(*(t.half() for t in mt))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["tripolar", "bipolar"])
def test_plain_on_a_legs_matches_pallas(kind, dtype):
    """The engine's M: lower and upper are A's own bottom and top tensors,
    the diagonal A's guarded (land columns arrive with diag 0). The plain
    step on those legs against the Pallas kernel, and bit for bit against
    the composition of the plain Thomas solve and the plain stencil."""
    nz, ny, nx = 7, 16, 24
    legs, m, x1, x2, rhat = _case(nz, ny, nx, kind, dtype, seed=11)
    c2 = dtype(0.61)
    z_j, out_j, d_j = _jax(legs, m, x1, x2, c2, rhat, kind)
    a, _, _, _, x1t, x2t, rhatt = _port(legs, m, x1, x2, rhat)
    assert bool((a.diag == 0).any())
    mt = (a.bottom, torch.where(a.diag != 0, a.diag, 1.0), a.top)
    topo = P.GridTopology(kind, nx, ny, nz)
    z, out, d = P.fused_krylov_step(a, *mt, x1t, x2t, float(c2), rhatt, topo,
                                    scratch=krylov_scratch(*mt))
    tol = TOL[dtype]
    np.testing.assert_allclose(z.numpy(), z_j, rtol=tol["rtol"], atol=tol["atol"])
    np.testing.assert_allclose(out.numpy(), out_j, rtol=tol["rtol"], atol=tol["atol"])
    np.testing.assert_allclose(float(d), d_j, rtol=tol["d_rtol"])
    want = P.apply_stencil(a, tridiag_solve_plain(*mt, z), topo)
    assert torch.equal(out, want)


# --- K10 -------------------------------------------------------------------


def test_probe_plain_sum_and_traffic():
    thunk, nbytes = P.dma_peak_probe(nstreams=3, mbytes=2, device="cpu")
    assert nbytes == 4 * 2 * 1024 * 1024
    out = thunk()
    gen = torch.Generator().manual_seed(0)
    ins = [torch.randn((2, 512, 512), generator=gen) for _ in range(3)]
    assert out.dtype == torch.float32 and out.shape == (2, 512, 512)
    assert torch.equal(out, (ins[0] * 0.999 + ins[1]) + ins[2])
    before = _build.calls(_build.KERNELS["K10"])
    thunk()
    assert _build.calls(_build.KERNELS["K10"]) == before


@pytest.mark.parametrize("streams", ["none", "too_many", "f64", "mixed_shapes"])
def test_probe_rejects_bad_inputs(streams):
    x = torch.zeros(8)
    bad = {"none": [], "too_many": [x] * (profiling.MAX_STREAMS + 1), "f64": [x.double()],
           "mixed_shapes": [x, torch.zeros(4)]}[streams]
    with pytest.raises((TypeError, ValueError)):
        profiling.probe_sum(bad)
