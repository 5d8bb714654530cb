"""The BiCGStab(2) cycle's vector algebra on the CPU: the port's
`_bicgstab2_cycles`, which ends each cycle in K11 (`polish_sums`) and K12
(`polish_update`), run here through their plain versions, against the JAX
package's `_bicgstab2_cycles` (K = A o M with the Pallas Thomas solve in
interpret mode, as the JAX package's own tests run it on the CPU); the
plain K11/K12 against the eager expression sequence they replace (`_axpy`
and `_dot`); the cycle's carried <rhat, r0>; the wrappers' input checks.
The CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otmb_tpu.models import solvers as J
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.apply import apply_stencil as jax_apply_stencil
from otmb_tpu.ops.coeffs import add_coeffs as jax_add_coeffs
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu.ops.tridiag_pallas import tridiag_solve_pallas
from otmb_tpu_torch import GridTopology
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.ops import krylov_algebra as A
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

SHIFT = 1e-6
#: Horizontal transport (Tadv, TkH) made 1e4 times stronger: on the small
#: conftest grid the vertical Thomas M otherwise inverts nearly all of T,
#: K = A o M is the identity to within 1e-8 and one cycle takes the
#: residual to rounding, where every later quantity is rounding noise. The
#: stronger flow leaves K the spread of an advective operator, the regime
#: BiCGStab(2) is for.
FLOW = 1e4
#: Each array within 1e-10 of its largest value. The packages round their
#: Thomas solves (XLA contracts the Pallas recurrence into FMAs) and dots
#: differently, and BiCGStab amplifies such differences: on this system five
#: cycles carry them to 1.9e-11 at most; at shifts of 1e-5 and 1e-4, or
#: without the stronger flow, to 1e-10 and beyond, with one shared K too.
RTOL_CYCLE = 1e-10
CYCLES = (1, 2, 5)
MEMBERS = 3


@pytest.fixture(scope="module")
def jax_T(dataset, gridmetrics, indices):
    phi = jax_faceflux(umo=dataset.umo, vmo=dataset.vmo, gridmetrics=gridmetrics,
                       indices=indices)
    ops = jax_transportmatrix(phi=phi, mlotst=dataset.mlotst, gridmetrics=gridmetrics,
                              indices=indices)
    strong = lambda c: type(c)(*(FLOW * leg for leg in c))
    return jax_add_coeffs(strong(ops.Tadv), strong(ops.TkH), ops.TkVML, ops.TkVdeep)


@pytest.fixture(scope="module")
def topo(gridmetrics):
    t = gridmetrics.topology
    return GridTopology(t.kind, t.nx, t.ny, t.nz)


@pytest.fixture(scope="module")
def wet(indices):
    return np.array(indices.wet3d)


@pytest.fixture(scope="module")
def system(jax_T, topo):
    """The port's shifted system on the same T (f64, Thomas M), built as the
    engine builds it."""
    T = coeffs_from_numpy({leg: np.asarray(jax_T[leg]) for leg in jax_T._fields}, device="cpu")
    return S._system(T, torch.float64, topo, shift=SHIFT)


@pytest.fixture(scope="module")
def jax_cycles(jax_T, gridmetrics):
    """The JAX package's `_bicgstab2_cycles` on K = A o M from the same T
    and Thomas legs, one compiled program per cycle count."""
    topo = gridmetrics.topology
    a = jax_T._replace(diag=jax_T.diag + SHIFT)
    guarded = jnp.where(a.diag != 0, a.diag, 1.0)

    def K(v):
        return jax_apply_stencil(a, tridiag_solve_pallas(a.bottom, guarded, a.top, v,
                                                         interpret=True), topo)

    one = jnp.ones((), jnp.float64)
    guard = lambda d: jnp.where(d == 0, one, d)
    programs = {n: jax.jit(lambda st, n=n: J._bicgstab2_cycles(K, guard, st, n)[0])
                for n in CYCLES}
    return lambda state, n: [np.asarray(v) for v in programs[n](state)]


def _state(wet, members: int | None, seed: int = 5):
    """A seeded BiCGStab(2) state (y, r0, u0, rhat, rho0, alpha, omega):
    random fields on the wet cells, scalars away from 0 and 1."""
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    field = lambda: np.where(wet, rng.standard_normal(lead + wet.shape), 0.0)
    scalar = lambda lo, hi: rng.uniform(lo, hi, lead)
    return (0.1 * field(), field(), field(), field(), scalar(0.5, 1.5), scalar(0.2, 0.6),
            scalar(0.8, 1.2))


def _close(got, want, what: str):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL_CYCLE * scale, what


@pytest.mark.parametrize("members,fused", [(None, False), (None, True), (MEMBERS, False)])
@pytest.mark.parametrize("ncycles", CYCLES)
def test_cycles_match_reference(system, jax_cycles, wet, ncycles, members, fused):
    """`ncycles` of the port's cycle (plain K11/K12; the unfused step, or
    for a field also K3's plain version) against the JAX package's, from
    one seeded state; a batch member by member against the JAX cycle on
    that member."""
    state = _state(wet, members)
    step = (S._fused_step(system, None) if fused else S._unfused_step(system))
    got = S._bicgstab2_cycles(system, step, S._State2(*(torch.from_numpy(np.array(v))
                                                          for v in state)), ncycles)
    for m in ([None] if members is None else range(members)):
        pick = (lambda v: v) if m is None else (lambda v: v[m])
        want = jax_cycles(tuple(jnp.asarray(pick(v)) for v in state), ncycles)
        for name, g, w in zip(S._State2._fields, got, want):
            _close(pick(g.numpy()), w, f"{name}, member {m}")


def _eager_cycle_end(y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat):
    """The eager sequence K11 and K12 replace: r0 -= alpha u1, y += alpha u0,
    the five dots, the three polish updates, and the next <rhat, r0>."""
    r0 = S._axpy(r0, -alpha, u1)
    y = S._axpy(y, alpha, u0)
    sums = torch.stack([S._dot(a, b) for a, b in ((r1, r1), (r1, r2), (r2, r2), (r0, r1),
                                                  (r0, r2))], dim=-1)
    y = S._axpy(S._axpy(y, w1, r0), w2, r1)
    r0 = S._axpy(S._axpy(r0, -w1, r1), -w2, r2)
    u0 = S._axpy(S._axpy(u0, -w1, u1), -w2, u2)
    return sums, y, r0, u0, S._dot(rhat, r0)


#: Plain against eager: the updates differ by the eager chain's roundings
#: (one or two ulps of each term; the plain version rounds once, from f64),
#: the sums by the dtype the dots accumulate in (f64 in the plain version,
#: the field's in `torch.dot`); both are bounded relative to the largest
#: value, the sums relative to the sum of the terms' magnitudes.
TOL_EAGER = {torch.float64: (1e-14, 1e-13), torch.float32: (1e-6, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("members", [None, MEMBERS])
def test_plain_against_eager(wet, dtype, members):
    rng = np.random.default_rng(11)
    lead = () if members is None else (members,)
    f = lambda: torch.from_numpy(np.where(wet, rng.standard_normal(lead + wet.shape),
                                          0.0)).to(dtype)
    s = lambda: torch.from_numpy(rng.uniform(-1.0, 1.0, lead)).to(dtype)
    y, u0, r0, r1, r2, u1, u2, rhat = (f() for _ in range(8))
    alpha, w1, w2 = s(), s(), s()
    tol_upd, tol_sum = TOL_EAGER[dtype]
    want_sums, want_y, want_r0, want_u0, want_d = _eager_cycle_end(
        y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat)
    r0n, sums = A.polish_sums(r0, u1, r1, r2, alpha)
    got_y, got_r0, got_u0, got_d = A.polish_update(y, u0, r0n, r1, r2, u1, u2, alpha, w1, w2,
                                                   rhat)
    mag = lambda a, b: A.dot64(a.abs(), b.abs()).to(dtype)
    scale = torch.stack([mag(a, b) for a, b in ((r1, r1), (r1, r2), (r2, r2), (r0n, r1),
                                                (r0n, r2))], dim=-1)
    assert bool(((sums - want_sums).abs() <= tol_sum * scale).all())
    assert bool(((got_d - want_d).abs() <= tol_sum * mag(rhat, got_r0)).all())
    for got, want in ((got_y, want_y), (got_r0, want_r0), (got_u0, want_u0)):
        assert float((got - want).abs().max()) <= tol_upd * float(want.abs().max())
    no_dot = A.polish_update(y, u0, r0n, r1, r2, u1, u2, alpha, w1, w2)
    assert no_dot[3] is None
    for a, b in zip(no_dot[:3], (got_y, got_r0, got_u0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_updates_round_once():
    """The plain K12 forms each update in f64 and rounds it to the fields'
    dtype once: ((y + a u0) + w1 r0) + w2 r1 with y = 2^24 and three unit
    terms is 2^24 + 3, which f32 rounds to 2^24 + 4; added term by term in
    f32, each unit would be lost to rounding."""
    one = torch.ones((), dtype=torch.float32)
    big = torch.full((1, 1, 1), 2.0 ** 24, dtype=torch.float32)
    unit = torch.ones((1, 1, 1), dtype=torch.float32)
    zero = torch.zeros((1, 1, 1), dtype=torch.float32)
    y, r0, u0, _ = A.polish_update(big, unit, unit, unit, zero, zero, zero, one, one, one)
    assert float(y) == 2.0 ** 24 + 4
    assert float(r0) == 0.0 and float(u0) == 1.0
    r0, _ = A.polish_sums(big, unit, unit, unit, -3 * one)
    assert float(r0) == 2.0 ** 24 + 4


def test_cycle_carries_the_next_dot(system, wet, monkeypatch):
    """Inside one call the top-of-cycle <rhat, r0> is K12's: the unfused
    cycle forms 3 dots per cycle in its steps and one at the call's start;
    K12 forms the next dot in every cycle but the last."""
    calls = {"dot": 0, "next": []}
    dot = system.dot
    sys_ = system._replace(field=system.field._replace(
        dot=lambda a, b: calls.__setitem__("dot", calls["dot"] + 1) or dot(a, b)))
    update = A.polish_update

    def spy(*args):
        calls["next"].append(args[-1] is not None)
        return update(*args)

    monkeypatch.setattr(S, "polish_update", spy)
    state = S._State2(*(torch.from_numpy(np.array(v)) for v in _state(wet, None)))
    S._bicgstab2_cycles(sys_, S._unfused_step(sys_), state, 4)
    assert calls["dot"] == 3 * 4 + 1
    assert calls["next"] == [True, True, True, False]


def test_wrappers_check_their_inputs():
    f = torch.zeros((2, 3, 4), dtype=torch.float64)
    s = torch.zeros((), dtype=torch.float64)
    with pytest.raises(ValueError, match="r1"):
        A.polish_sums(f, f, torch.zeros((2, 3, 5), dtype=torch.float64), f, s)
    with pytest.raises(ValueError, match="alpha"):
        A.polish_sums(f, f, f, f, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        A.polish_sums(f, f, f, f.transpose(0, 1).contiguous().transpose(0, 1), s)
    with pytest.raises(ValueError, match="w2"):
        A.polish_update(f, f, f, f, f, f, f, s, s, s.float())
    with pytest.raises(ValueError, match="fields must be"):
        A.polish_sums(f[0], f[0], f[0], f[0], s)
    batch = torch.zeros((3, 2, 3, 4), dtype=torch.float64)
    r0, sums = A.polish_sums(batch, batch, batch, batch, torch.zeros(3, dtype=torch.float64))
    assert sums.shape == (3, A.NSUMS) and r0.shape == batch.shape
