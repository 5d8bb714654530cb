"""The engine's graphed BiCGStab(1) loop on the CPU (`models/solvers.py`:
`_PingPong`, `_capture`, `_graphed`), with each graph's replay replaced by
the eager iteration it captures (`_bicgstab_iteration` from one state set
into the other), so everything but the capture itself runs here: the two
state sets, restarts copied in, the best iterate kept apart from them, the
graphs and their pool freed when the engine returns, the engagement rule
and the launch counter's captures and replays. On the card,
tests/test_torch_cuda.py holds real graphs to the eager loop bit for bit.
"""

import warnings
import weakref

import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch import _build
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.ops import krylov_algebra as A
from otmb_tpu_torch.utils import tracing

torch.set_num_threads(1)

MEMBERS = 3


@pytest.fixture(scope="module", params=["tripolar", "bipolar"])
def case(request):
    ds = P.synthetic_dataset(nx=24, ny=16, nz=8, topology=request.param, seed=42)
    gm = P.makegridmetrics(
        areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon, lat=ds.lat, lev=ds.lev,
        lon_vertices=ds.lon_vertices, lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    T = P.assemble_transport(ds.umo, ds.vmo, ds.mlotst, gm, idx.wet3d).T
    return T, gm.topology, idx.wet3d


def _b(wet, members=None, seed=5, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    shape = tuple(wet.shape) if members is None else (members, *wet.shape)
    return torch.where(wet, torch.randn(shape, generator=g, dtype=torch.float64), 0.0).to(dtype)


def _skew(T, wet, diag):
    """A skew-dominant f32 operator (east +1, west -1), as in
    tests/test_torch_chunked.py: with a Jacobi M its BiCGStab(1) stalls
    (diag 1e-6) or goes non-finite in its first chunk (diag 0)."""
    w = wet.double()
    z = torch.zeros_like(T.diag)
    return T._replace(diag=z + diag * w, east=z + w, west=z - w, north=z, south=z, top=z,
                      bottom=z).to(torch.float32)


class _EagerGraph:
    """A captured iteration's stand-in: its replay runs the iteration the
    graph would hold, from one state set into the other."""

    def __init__(self, sys_, src, dst):
        self.sys_, self.src, self.dst = sys_, src, dst

    def replay(self):
        S._bicgstab_iteration(self.sys_, self.src, out=self.dst)


def _eager_capture(sys_, sets):
    # A real graph holds no Python object: the stand-in holds the system
    # without its loops, so the loop it lands in does not hold itself.
    sys_ = sys_._replace(loops={})
    return [(_EagerGraph(sys_, sets[i], sets[1 - i]), {}) for i in (0, 1)]


@pytest.fixture
def eager_replays(monkeypatch):
    """Graphs whose replays run the eager iteration."""
    monkeypatch.setattr(S, "_capture", _eager_capture)


@pytest.fixture
def graphed_here(monkeypatch, eager_replays):
    """The engine's graphed loop on CPU tensors."""
    monkeypatch.setattr(S, "_graphed", lambda sys_, algorithm, b: algorithm == "bicgstab")


def _same(got, want):
    for name, g, w in zip(S._State1._fields, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("members", [None, MEMBERS])
def test_ping_pong_equals_eager_steps(case, eager_replays, members):
    """Parts of several iterations, a stall restart (a fresh Krylov space at
    the best iterate) and a jittered one, for some members of a batch: the
    ping-pong runner gives x, r, p and rho bit for bit as `_bicgstab_steps`,
    and its state sets alias none of the tensors it was started from."""
    T, topo, wet = case
    sys_ = S._system(T, torch.float64, topo, shift=1e-5)
    b = _b(wet, members)
    mask = [True] if members is None else [True, False, True]
    eager = S._bicgstab_steps(sys_, S._initial_state(sys_, "bicgstab", b), 1)
    loop = S._PingPong(sys_, eager)
    ptrs = {t.data_ptr() for t in eager}
    assert not ptrs & {t.data_ptr() for t in (*loop.sets[0], *loop.sets[1])}
    for stage, parts in enumerate(([2, 4, 3], [1, 5], [2, 3])):
        if stage:  # a stall restart, then a jittered one, from the eager iterate
            x_best = eager.x.clone()
            restarted = S._restart_members(sys_, "bicgstab", None, eager, x_best, b, mask,
                                           jitter=stage - 1)
            eager = restarted
            loop.load(restarted)
            _same(loop.state, eager)
        for n in parts:
            eager = S._bicgstab_steps(sys_, eager, n)
            _same(loop.steps(n), eager)


@pytest.mark.parametrize("scenario", ["stall", "diverge"])
def test_graphed_engine_equals_eager_engine(case, scenario, monkeypatch, graphed_here):
    """The whole engine on its graphed loop (replays run eagerly here)
    against the eager loop: the same x, residual and stats, through stall
    restarts (a 3-chunk window without 2 % of gain) or jittered ones (a
    recurrence gone non-finite)."""
    T, topo, wet = case
    b = _b(wet, dtype=torch.float32)
    kw = (dict(tol=1e-300, maxiter=600, chunk=10, preconditioner="jacobi")
          if scenario == "stall" else
          dict(tol=1e-6, chunk=10, maxiter=600, max_restarts=0, early_stop=False,
               max_diverge_restarts=2))
    coeffs = _skew(T, wet, 1e-6 if scenario == "stall" else 0.0)
    runs = []
    for graphs in (True, False):
        if not graphs:
            monkeypatch.setattr(S, "_graphed", lambda sys_, algorithm, b: False)
        stats = {}
        n0 = _build.calls("graph:bicg1")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            x, res = P.solve_shifted_chunked(coeffs, b, topo, stats=stats, **kw)
        runs.append((x, res, stats, _build.calls("graph:bicg1") - n0))
    (xg, rg, sg, replays), (xe, re_, se, none) = runs
    assert replays == sg["iters"] - 1 and none == 0  # all but the warm-up replayed
    assert sg["restarts" if scenario == "stall" else "diverge_restarts"] >= 1
    assert torch.equal(xg, xe) and rg == re_
    sg.pop("chunk_s"), se.pop("chunk_s")
    assert sg == se


def _age_extra(wet):
    """The ideal age's surface restoring, whose system takes more than one
    iteration (a shifted one converges in one)."""
    surface = torch.zeros(wet.shape, dtype=torch.float32)
    surface[0] = 1.0
    return torch.where(wet, surface, 0.0)


def test_a_refinement_captures_once_and_frees_its_loop(case, monkeypatch, graphed_here):
    """The passes of a refined solve share its one system and the graphed
    loop the first pass captured on it, and give the eager passes' bits;
    the loop's state sets go with the system when the solve returns. Two
    plain solves capture one loop each."""
    T, topo, wet = case
    b = _b(wet, dtype=torch.float32)
    systems, sets = [], []  # each capture's system, by its Thomas factor

    def capture(sys_, state_sets):
        systems.append(sys_.factor)  # the system itself would hold its loop
        sets.extend(weakref.ref(t) for st in state_sets for t in st)
        return _eager_capture(sys_, state_sets)

    monkeypatch.setattr(S, "_capture", capture)
    kw = dict(extra_diag=_age_extra(wet), tol=1e-9)
    stats = {}
    x, rel = P.solve_shifted_ir(T.to(torch.float32), b, topo, stats=stats, **kw)
    assert len(stats["passes"]) > 1 and len(systems) == 1
    assert sets and all(ref() is None for ref in sets)
    for _ in range(2):
        P.solve_shifted_chunked(T.to(torch.float32), b, topo, extra_diag=kw["extra_diag"],
                                tol=1e-6)
    assert len(systems) == 3 and systems[1] is not systems[2]
    monkeypatch.setattr(S, "_graphed", lambda sys_, algorithm, b: False)
    xe, rel_e = P.solve_shifted_ir(T.to(torch.float32), b, topo, **kw)
    assert torch.equal(x, xe) and rel == rel_e


@pytest.mark.parametrize("inner_algorithm", ["bicgstab", "bicgstab2"])
def test_a_refinement_builds_one_system(case, monkeypatch, inner_algorithm):
    """A refined solve of several passes builds one system and makes one
    Thomas factor (one K2 factor launch on the card), which every pass and
    its K3 steps use."""
    from otmb_tpu_torch.ops import krylov

    T, topo, wet = case
    counts = {"system": 0, "factor": 0}

    def counted(fn, what):
        def wrapped(*args, **kwargs):
            counts[what] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(S, "_system", counted(S._system, "system"))
    factor = counted(S.tridiag_factor, "factor")
    monkeypatch.setattr(S, "tridiag_factor", factor)
    monkeypatch.setattr(krylov, "tridiag_factor", factor)
    stats = {}
    _, rel = P.solve_shifted_ir(T.to(torch.float32), _b(wet, dtype=torch.float32), topo,
                                extra_diag=_age_extra(wet), tol=1e-9, stats=stats,
                                inner_algorithm=inner_algorithm)
    assert rel <= 1e-9 and len(stats["passes"]) >= 2
    assert counts == {"system": 1, "factor": 1}


def test_best_iterate_outlives_two_replays(case, monkeypatch, graphed_here):
    """A read that improves the residual keeps that read's iterate, though
    the set it lay in is overwritten two replays later: the engine returns
    it, and not a later iterate. The reads are scripted (0.9, then 0.5, then
    0.8 of ||b||^2), so the second one, after two replays, is the best; on
    this system every iteration moves x."""
    T, topo, wet = case
    b = _b(wet, dtype=torch.float32)
    seen, script = [], iter([0.9, 0.5, 0.8, 0.8])
    steps, read = S._PingPong.steps, S._read

    def recorded(self, n):
        state = steps(self, n)
        seen.append(state.x.clone())
        return state

    def scripted(values, what):
        out = read(values, what)
        return [next(script) * bnorm2[0]] if what == "recurrence residual" else out

    bnorm2 = read(S._dot(b, b), "||b||^2")
    monkeypatch.setattr(S._PingPong, "steps", recorded)
    monkeypatch.setattr(S, "_read", scripted)
    x, _ = P.solve_shifted_chunked(_skew(T, wet, 1e-2), b, topo, tol=1e-300, maxiter=15,
                                   preconditioner="jacobi", early_stop=False)
    assert len(seen) == 3  # parts 2, 4, 8 after the eager first
    assert torch.equal(x, seen[0]) and not torch.equal(x, seen[-1])


def test_the_rule_engages_bicgstab1_on_a_whole_cuda_field(case):
    """`_graphed` engages BiCGStab(1) on the whole field of a CUDA tensor and
    declines CPU tensors, a shard's field, BiCGStab(2) and GMRES. A CUDA
    tensor is stood in for by its one property the rule reads."""
    T, topo, wet = case
    sys_ = S._system(T, torch.float64, topo)
    shard = sys_._replace(field=sys_.field._replace(whole=False))
    cuda, cpu = type("CudaTensor", (), {"is_cuda": True})(), _b(wet)
    assert S._graphed(sys_, "bicgstab", cuda)
    assert not S._graphed(sys_, "bicgstab", cpu)
    assert not S._graphed(shard, "bicgstab", cuda)
    assert not any(S._graphed(sys_, algorithm, cuda) for algorithm in ("bicgstab2", "gmres"))


def test_a_shards_field_is_not_whole():
    """What the rule reads of the field: a rank's shard is never whole, even
    the one shard of a (1, 1) grid, whose sums still go through the
    process group."""
    from otmb_tpu_torch.parallel.mesh import ProcessGrid
    from otmb_tpu_torch.parallel.solve_halo import halo_field

    topo = P.GridTopology("tripolar", 8, 6, 2)
    for shape in ((1, 1), (2, 2)):
        assert not halo_field(topo, ProcessGrid(shape, 0, torch.device("cpu"), "gloo")).whole
    assert S._whole_field(topo).whole


def test_a_replay_is_one_launch_path_call():
    """`_build.replay` replays the graph and counts one call under its name,
    in `_build.calls` and in the open span's `calls`; the entry calls of its
    tally count under their own names, as run, and not in the total."""

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    graph, tally = Graph(), {"otmb_bicg1_p_f32": 1, "otmb_thomas_solve_f32": 2}
    n0, total0 = _build.calls("graph:bicg1"), _build.calls()
    k13, k2 = (_build.calls(_build.KERNELS[k]) for k in ("K13", "K2"))
    with tracing.span("engine.steps", iters=2) as steps:
        _build.replay(graph, tally, "graph:bicg1")
        _build.replay(graph, tally, "graph:bicg1")
    assert graph.replays == 2
    assert _build.calls("graph:bicg1") == n0 + 2 and _build.calls() == total0 + 2
    assert _build.calls(_build.KERNELS["K13"]) == k13 + 2
    assert _build.calls(_build.KERNELS["K2"]) == k2 + 4
    assert [s.calls for s in tracing.spans() if s.id == steps.id] == [2]


def test_captured_entry_calls_count_apart():
    """An entry call made while a graph is captured runs nothing: it counts
    once in the total and under "capture:" + its name, which no kernel of
    `_build.KERNELS` names, and in the capture's tally; after the capture,
    calls count under their own names again."""
    k13, total0 = _build.calls(_build.KERNELS["K13"]), _build.calls()
    c0 = _build.calls("capture:otmb_bicg1_")
    with _build.capturing() as tally:
        _build._count("otmb_bicg1_update_f32")
        _build._count("otmb_bicg1_update_f32")
        _build._count("otmb_stencil_f32")
    assert tally == {"otmb_bicg1_update_f32": 2, "otmb_stencil_f32": 1}
    assert _build.calls("capture:otmb_bicg1_") == c0 + 2 and _build.calls() == total0 + 3
    assert _build.calls(_build.KERNELS["K13"]) == k13
    assert not any(name.startswith("capture:") for prefixes in _build.KERNELS.values()
                   for name in prefixes)
    _build._count("otmb_bicg1_update_f32")
    assert _build.calls(_build.KERNELS["K13"]) == k13 + 1 and len(tally) == 2


@pytest.mark.parametrize("members", [None, MEMBERS])
def test_k13_writes_into_given_outputs(case, members):
    """`bicg1_update` and `bicg1_p` write into given tensors what they would
    return fresh, and refuse outputs of another shape."""
    _, _, wet = case
    x, phat, shat, s, t, rhat, r, p, v = (_b(wet, members, seed) for seed in range(9))
    scalar = lambda value: torch.full(x.shape[:-3], value, dtype=x.dtype)
    alpha, rho = scalar(0.3), scalar(2.0)
    ts = A.bicg1_sums(t, s, with_aa=True)
    fresh = A.bicg1_update(x, phat, shat, s, t, rhat, alpha, ts)
    outs = (torch.empty_like(x), torch.empty_like(x), torch.empty_like(alpha))
    got = A.bicg1_update(x, phat, shat, s, t, rhat, alpha, ts, *outs)
    for out, g, f in zip(outs, (got[0], got[1], got[3]), (fresh[0], fresh[1], fresh[3])):
        assert g is out and torch.equal(out, f)
    p_out = torch.empty_like(p)
    assert A.bicg1_p(r, p, v, rho, fresh[3], alpha, fresh[2], out=p_out) is p_out
    assert torch.equal(p_out, A.bicg1_p(r, p, v, rho, fresh[3], alpha, fresh[2]))
    with pytest.raises(ValueError, match="out is"):
        A.bicg1_p(r, p, v, rho, fresh[3], alpha, fresh[2], out=p_out[..., :-1].contiguous())
    with pytest.raises(ValueError, match="rho_out must be"):
        A.bicg1_update(x, phat, shat, s, t, rhat, alpha, ts, rho_out=scalar(0.0)[None])
