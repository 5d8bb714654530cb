"""BiCGStab(1)'s iteration algebra on the CPU: the port's `_bicgstab_steps`,
whose vector algebra is K13's four entries (`bicg1_sums`, `bicg1_s`,
`bicg1_update`, `bicg1_p`), run here through their plain versions, against
the JAX package's `_sr_chunk1` (a field) and `_mr_chunk1` (a batch), whose
Pallas stencil and Thomas kernels run in interpret mode, as the JAX
package's own tests run them on the CPU; each plain entry against the
reference formulas in numpy; a batch of one against the field; the
wrappers' input checks. The CUDA kernels are held to the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py; the all-reduces of
a sharded iteration are counted in tests/test_torch_bicg1_sharded.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otmb_tpu.models import solvers as J
from otmb_tpu.models.transport import transportmatrix as jax_transportmatrix
from otmb_tpu.ops.coeffs import add_coeffs as jax_add_coeffs
from otmb_tpu.ops.fluxes import facefluxesfrommasstransport as jax_faceflux
from otmb_tpu_torch import GridTopology
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.ops import krylov_algebra as A
from otmb_tpu_torch.utils.convert import coeffs_from_numpy

torch.set_num_threads(1)

#: Horizontal transport made 1e4 times stronger, as in
#: tests/test_torch_algebra.py: on the small conftest grid the vertical
#: Thomas M otherwise inverts nearly all of T, and after one iteration every
#: quantity is rounding noise. With the shift at 1e-5 ten iterations
#: contract the residual 20x to 4e4x, short of rounding; at 1e-6 they meet
#: near-breakdowns (rho ~ 1e-2 of its start), where the JAX package's own
#: field and batch programs part by up to 2e-7.
SHIFT = 1e-5
FLOW = 1e4
#: Each array of the state within 1e-8 of its largest value. The packages
#: round their Thomas solves (XLA contracts the Pallas recurrence into FMAs)
#: and their dots differently, and BiCGStab amplifies such differences: on
#: this system ten iterations carry them to 6.5e-10 at most (four seeds,
#: three members each, both topologies).
RTOL_STEPS = 1e-8
NSTEPS = (1, 3, 10)
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
def jax_steps(jax_T, gridmetrics):
    """The JAX package's chunk programs on the same system, as its engine
    calls them: A with the shift in its diagonal, M from T's vertical legs
    and the shifted diagonal, the Pallas kernels in interpret mode."""
    topo = gridmetrics.topology
    shifted = jax_T.diag + SHIFT
    a = jax_T._replace(diag=shifted)

    def run(state, nsteps, batch):
        chunk = J._mr_chunk1 if batch else J._sr_chunk1
        out, _ = chunk(a, jax_T, shifted, tuple(jnp.asarray(v) for v in state), nsteps, topo,
                       "tridiag", True)
        return [np.asarray(v) for v in out]

    return run


def _state(wet, members: int | None, seed: int = 7):
    """A seeded BiCGStab(1) state (x, r, p, rhat, rho) as a Krylov pass
    starts it at an iterate x: random fields on the wet cells, p = r, rhat
    = r and rho = <rhat, r> per member. (From unrelated fields and rho the
    recurrence meets near-breakdowns within ten iterations, where the JAX
    package's own field and batch programs part by up to 6e-3.)"""
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    field = lambda: np.where(wet, rng.standard_normal(lead + wet.shape), 0.0)
    x, r = 0.1 * field(), field()
    return x, r, r.copy(), r.copy(), np.sum(r * r, axis=(-3, -2, -1))


def _close(got, want, what: str):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL_STEPS * scale, what


@pytest.mark.parametrize("members", [None, MEMBERS])
@pytest.mark.parametrize("nsteps", NSTEPS)
def test_steps_match_reference(system, jax_steps, wet, nsteps, members):
    """`nsteps` iterations of the port's BiCGStab(1) (plain K13) against the
    JAX package's chunk program from one seeded state: a field against
    `_sr_chunk1`, a batch of 3 against `_mr_chunk1`."""
    state = _state(wet, members)
    got = S._bicgstab_steps(system, S._State1(*(torch.from_numpy(np.array(v)) for v in state)),
                            nsteps)
    want = jax_steps(state, nsteps, members is not None)
    for name, g, w in zip(S._State1._fields, got, want):
        _close(g.numpy(), w, name)


def test_batch_of_one_is_the_field(system, wet):
    state = _state(wet, None)
    field = S._bicgstab_steps(system, S._State1(*(torch.from_numpy(np.array(v)) for v in state)),
                              5)
    batch = S._bicgstab_steps(system, S._State1(*(torch.from_numpy(np.array(v))[None]
                                                  for v in state)), 5)
    for f, b in zip(field, batch):
        torch.testing.assert_close(b[0], f, rtol=0, atol=0)


def _inputs(dtype, members, seed):
    """Seeded fields (nz, ny, nx) or (B, nz, ny, nx) and member scalars."""
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    field = lambda: torch.from_numpy(rng.standard_normal(lead + (3, 5, 7))).to(dtype)
    scalar = lambda: torch.from_numpy(rng.uniform(-1.5, 1.5, lead)).to(dtype)
    return field, scalar


def _np(t):
    return t.double().numpy()


def _bx(a, members):
    """A member's scalar broadcast against its fields, in numpy."""
    return a if members is None else a[:, None, None, None]


def _guard(d):
    return np.where(d == 0, 1.0, d)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("members", [None, MEMBERS])
def test_plain_entries_follow_the_reference_formulas(dtype, members):
    """Each plain entry against `_sr_chunk1`'s formulas, evaluated in numpy
    in f64 from the same stored values: the scalars in the fields' dtype,
    each update formed in f64 and rounded once, the sums f64 dots rounded
    to the fields' dtype."""
    field, scalar = _inputs(dtype, members, 31)
    x, r, p, rhat, v, phat, shat, t = (field() for _ in range(8))
    rho, dv = scalar(), scalar().unsqueeze(-1)
    rnd = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    bx = lambda a: _bx(_np(a), members)
    vdot = lambda a, b: np.sum(_np(a) * _np(b), axis=(-3, -2, -1))

    sums = A.bicg1_sums(v, rhat)
    assert sums.shape == v.shape[:-3] + (1,) and sums.dtype == dtype
    np.testing.assert_allclose(_np(sums[..., 0]), _np(rnd(vdot(rhat, v))), rtol=1e-13)
    s, alpha = A.bicg1_s(r, v, rho, dv)
    torch.testing.assert_close(alpha, rho / rnd(_guard(_np(dv[..., 0]))), rtol=0, atol=0)
    torch.testing.assert_close(s, rnd(_np(r) - bx(alpha) * _np(v)), rtol=0, atol=0)

    ts = A.bicg1_sums(t, s, with_aa=True)
    assert ts.shape == t.shape[:-3] + (2,)
    np.testing.assert_allclose(_np(ts), np.stack([_np(rnd(vdot(t, s))), _np(rnd(vdot(t, t)))],
                                                 axis=-1), rtol=1e-13)
    x1, r1, omega, rho1 = A.bicg1_update(x, phat, shat, s, t, rhat, alpha, ts)
    torch.testing.assert_close(omega, ts[..., 0] / rnd(_guard(_np(ts[..., 1]))), rtol=0, atol=0)
    torch.testing.assert_close(
        x1, rnd((_np(x) + bx(alpha) * _np(phat)) + bx(omega) * _np(shat)), rtol=0, atol=0)
    torch.testing.assert_close(r1, rnd(_np(s) - bx(omega) * _np(t)), rtol=0, atol=0)
    np.testing.assert_allclose(_np(rho1), _np(rnd(vdot(rhat, r1))), rtol=1e-13)

    p1 = A.bicg1_p(r1, p, v, rho, rho1, alpha, omega)
    beta = (rho1 / rnd(_guard(_np(rho)))) * (alpha / rnd(_guard(_np(omega))))
    torch.testing.assert_close(
        p1, rnd(_np(r1) + bx(beta) * (_np(p) - bx(omega) * _np(v))), rtol=0, atol=0)


def _loop_sum(prod: np.ndarray) -> float:
    """The sum of K13's kernels, as their loops run it: each thread's cells
    in turn, the warps' shuffle trees, warp 0's tree over the warp sums, and
    the finish kernel's threads over the blocks, then its trees."""
    n = prod.size
    nblk, tiles = min(-(-n // A.TILE), A.MAX_BLOCKS), -(-n // A.TILE)

    def warp(v):
        v = list(v)
        for off in (16, 8, 4, 2, 1):
            v = [v[i] + (v[i + off] if i + off < 32 else v[i]) for i in range(32)]
        return v[0]

    def block(v):
        sums = [warp(v[w:w + 32]) for w in range(0, len(v), 32)]
        return warp(sums + [0.0] * (32 - len(sums)))

    partials = []
    for b in range(nblk):
        acc = [0.0] * A.THREADS
        for tile in range(b, tiles, nblk):
            for q in range(A.PER):
                for t in range(A.THREADS):
                    e = tile * A.TILE + q * A.THREADS + t
                    if e < n:
                        acc[t] = acc[t] + float(prod[e])
        partials.append(block(acc))
    acc = [0.0] * A.FINISH_THREADS
    for t in range(A.FINISH_THREADS):
        for q in range(t, nblk, A.FINISH_THREADS):
            acc[t] = acc[t] + partials[q]
    return block(acc)


@pytest.mark.parametrize("n", [1, 37, 3000, A.TILE * A.MAX_BLOCKS + 1025])
def test_plain_sums_run_in_the_kernels_order(n):
    """`tree_sum` equals the kernels' loops bit for bit (also where a block
    takes two tiles and the finish threads several blocks): the plain
    sums are the kernel's, not just close to them."""
    rng = np.random.default_rng(n)
    prod = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)
    got = float(A.tree_sum(torch.from_numpy(prod).view(1, -1))[0])
    assert got == _loop_sum(prod)


def test_guards_of_zero_denominators():
    """guard(d) = 1 where d = 0: a zero <rhat, v> gives alpha = rho, a zero
    <t, t> gives omega = <t, s>, a zero rho gives beta = rho' (alpha /
    omega), and a zero omega beta = (rho' / rho) alpha; nothing becomes
    NaN."""
    f = lambda c: torch.full((2, 2, 3), c, dtype=torch.float64)
    zero, two, half = (torch.tensor(c, dtype=torch.float64) for c in (0.0, 2.0, 0.5))
    s, alpha = A.bicg1_s(f(1.0), f(3.0), two, zero.reshape(1))
    assert float(alpha) == 2.0 and bool((s == -5.0).all())
    x1, r1, omega, _ = A.bicg1_update(f(0.0), f(1.0), f(1.0), f(1.0), f(0.0), f(1.0), alpha,
                                      torch.tensor([0.5, 0.0], dtype=torch.float64))
    assert float(omega) == 0.5 and bool((x1 == 2.5).all()) and bool((r1 == 1.0).all())
    p1 = A.bicg1_p(f(1.0), f(1.0), f(1.0), zero, two, half, zero)
    # beta = (2 / 1) * (0.5 / 1) = 1, p' = 1 + 1 * (1 - 0 * 1) = 2
    assert bool((p1 == 2.0).all())
    p1 = A.bicg1_p(f(1.0), f(1.0), f(1.0), two, two, half, half)
    # beta = (2 / 2) * (0.5 / 0.5) = 1, p' = 1 + 1 * (1 - 0.5) = 1.5
    assert bool((p1 == 1.5).all())


def test_plain_updates_round_once():
    """x' = (x + alpha phat) + omega shat with x = 2^24 and two unit terms is
    2^24 + 2 in f32; added term by term in f32, each unit would be lost."""
    big = torch.full((1, 1, 1), 2.0 ** 24, dtype=torch.float32)
    unit = torch.ones((1, 1, 1), dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    x1, _, omega, _ = A.bicg1_update(big, unit, unit, unit, unit, unit, one,
                                     torch.tensor([1.0, 1.0]))
    assert float(omega) == 1.0 and float(x1) == 2.0 ** 24 + 2


def test_wrappers_check_their_inputs():
    f = torch.zeros((2, 3, 4), dtype=torch.float64)
    s = torch.zeros((), dtype=torch.float64)
    one = torch.zeros((1,), dtype=torch.float64)
    two = torch.zeros((2,), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        A.bicg1_sums(f.half(), f.half())
    with pytest.raises(TypeError, match="float32 or float64"):
        A.bicg1_p(*(f.bfloat16(),) * 3, *(s.bfloat16(),) * 4)
    with pytest.raises(ValueError, match="b is"):
        A.bicg1_sums(f, f.float())
    with pytest.raises(ValueError, match="v is"):
        A.bicg1_s(f, torch.zeros((2, 3, 5), dtype=torch.float64), s, one)
    with pytest.raises(ValueError, match="fields must be"):
        A.bicg1_sums(f[0], f[0])
    with pytest.raises(ValueError, match="dv must be"):
        A.bicg1_s(f, f, s, two)
    with pytest.raises(ValueError, match="ts must be"):
        A.bicg1_update(f, f, f, f, f, f, s, one)
    with pytest.raises(ValueError, match="alpha must be"):
        A.bicg1_update(f, f, f, f, f, f, two, two)
    with pytest.raises(ValueError, match="omega must be"):
        A.bicg1_p(f, f, f, s, s, s, s.float())
    with pytest.raises(ValueError, match="contiguous"):
        A.bicg1_sums(f, f.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="rhat is"):
        A.bicg1_update(f, f, f, f, f, torch.empty((2, 3, 4), dtype=torch.float64,
                                                  device="meta"), s, two)
    batch = torch.zeros((3, 2, 3, 4), dtype=torch.float64)
    assert A.bicg1_sums(batch, batch, with_aa=True).shape == (3, 2)
