"""The program's spans (`utils/tracing.py`) and its one launch counter
(`_build.calls`), on the CPU: a refined ideal age at 24x16x8 makes one root
span whose tree is whole, its `engine.steps` iterations sum to the stats',
its reads all run inside `engine.read`, and the stats' chunk and pass
seconds are the spans' own clock readings; the buffer drops its oldest
spans and counts them; the counter counts per entry name, on a faked
library, and the spans difference it; `_build.KERNELS` names every entry
once."""

import collections
import types

import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch import _build
from otmb_tpu_torch.models import solvers as S
from otmb_tpu_torch.utils import tracing

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """The set-up path's public calls, each recorded as it runs."""
    tracing.clear()
    ds = P.synthetic_dataset(nx=24, ny=16, nz=8, topology="tripolar", seed=42)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    P.facefluxesfrommasstransport(umo=ds.umo, vmo=ds.vmo, gridmetrics=gm, indices=idx)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    return gm, idx, T, tracing.spans()


@pytest.fixture(scope="module")
def age(setup):
    """One refined ideal age, its stats and its spans."""
    gm, idx, T, _ = setup
    tracing.clear()
    stats = {}
    _, res = P.ideal_age(T, idx.wet3d, gm.topology, refine=True, stats=stats)
    assert res <= 1e-8
    return stats, tracing.spans()


def test_each_setup_call_is_one_root(setup):
    names = [s.name for s in setup[3] if s.parent is None]
    assert names == ["makegridmetrics", "makeindices", "facefluxesfrommasstransport",
                     "assemble_T"]


def test_a_request_is_one_tree(age):
    _, spans = age
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["ideal_age"]
    assert all(s.root == roots[0].id and s.rank == 0 for s in spans)
    for s in spans:
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    count = collections.Counter(s.name for s in spans)
    assert count["solve_shifted_ir"] == 1 and count["ir.pass"] >= 2
    # a pass opens `engine` itself, no public solve of its own
    assert count["solve_shifted"] == count["solve_shifted_chunked"] == 0
    solved = [s.id for s in spans if s.name == "ir.pass" and "inner_iters" in s.attrs]
    assert sorted(s.parent for s in spans if s.name == "engine") == sorted(solved)
    assert count["engine.steps"] >= count["engine"] and count["engine.read"] > count["engine"]


@pytest.mark.parametrize("name", ["solve_shifted", "solve_shifted_chunked", "solve_shifted_multi",
                                  "solve_shifted_chunked_multi"])
def test_a_public_solve_is_one_span_over_one_engine(setup, name):
    """Each public solve opens its own span once, and `engine` once inside
    it: none reaches the engine through another public solve."""
    gm, idx, T, _ = setup
    b = idx.wet3d.to(T.diag.dtype)
    tracing.clear()
    getattr(P, name)(T, torch.stack([b, 2 * b]) if "multi" in name else b, gm.topology,
                     shift=1e-3, tol=1e-6)
    spans = tracing.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == [name]
    engines = [s for s in spans if s.name == "engine"]
    assert len(engines) == 1 and engines[0].parent == roots[0].id
    assert not any(s.name.startswith("solve_shifted") for s in spans if s is not roots[0])


def test_steps_count_the_engine_iterations(age):
    stats, spans = age
    steps = [s for s in spans if s.name == "engine.steps"]
    assert sum(s.attrs["iters"] for s in steps) == sum(p["inner_iters"]
                                                       for p in stats["passes"])
    passes = [s for s in spans if s.name == "ir.pass" and "inner_iters" in s.attrs]
    assert [s.attrs["inner_iters"] for s in passes] == [p["inner_iters"]
                                                        for p in stats["passes"]]
    assert all(s.calls == 0 for s in spans)  # the CPU launches nothing


def test_stats_seconds_are_the_spans(age):
    """chunk_s and the passes' wall_s come from the spans' clock readings."""
    stats, spans = age
    passes = [s for s in spans if s.name == "ir.pass" and "inner_iters" in s.attrs]
    seconds = lambda s: (s.end_ns - s.start_ns) * 1e-9
    assert [p["wall_s"] for p in stats["passes"]] == list(map(seconds, passes))
    chunks = [round(seconds(s), 4) for s in spans if s.name == "engine.chunk"]
    assert chunks == [c for p in stats["passes"] for c in p["inner_chunk_s"]]


def test_every_read_runs_inside_engine_read(setup, monkeypatch):
    """Every device-to-host read the refinement and the engine make, through
    `tolist`, `item` or `float`, runs with `engine.read` the innermost span,
    and every `_read` makes exactly one."""
    gm, idx, T, _ = setup
    seen = []
    for attr in ("tolist", "item", "__float__"):
        real = getattr(torch.Tensor, attr)

        def spy(self, *a, _real=real, **k):
            open_ = tracing._stack.open
            seen.append(open_[-1].name if open_ else None)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, attr, spy)
    reads = []
    real_read = S._read
    monkeypatch.setattr(S, "_read", lambda v, what: reads.append(what) or real_read(v, what))
    tracing.clear()
    P.ideal_age(T, idx.wet3d, gm.topology, refine=True)
    assert seen and set(seen) == {"engine.read"}
    assert len(reads) == sum(s.name == "engine.read" for s in tracing.spans())


def test_a_full_buffer_drops_its_oldest(monkeypatch):
    monkeypatch.setattr(tracing, "_buffer", collections.deque(maxlen=3))
    monkeypatch.setattr(tracing, "_dropped", 0)
    for i in range(5):
        with tracing.span(f"s{i}", i=i):
            pass
    assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_spans_nest_and_close_on_errors():
    tracing.clear()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner", k=1) as inner:
                inner.attrs["late"] = 2
                raise ValueError
    outer_s, inner_s = sorted(tracing.spans(), key=lambda s: s.start_ns)
    assert (outer_s.name, inner_s.name) == ("outer", "inner")
    assert inner_s.parent == outer_s.id and inner_s.root == outer_s.root == outer_s.id
    assert inner_s.attrs == {"k": 1, "late": 2} and not tracing._stack.open


def test_calls_count_entries_and_spans_difference_them(monkeypatch):
    """`_build.launch` counts each returned call per C entry name; a failed
    call is not counted; spans hold the calls made inside them. The library
    is faked, so nothing is built."""
    lib = types.SimpleNamespace(otmb_set_device=lambda index: 0,
                                otmb_cuda_error_string=lambda err: b"fake error")
    errors = {"otmb_bad_f32": 2}
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "function",
                        lambda name, argtypes: lambda *args: errors.get(name, 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "_selected", type(_build._selected)())
    monkeypatch.setattr(_build, "_calls", {})
    monkeypatch.setattr(_build, "_total", 0)
    device = torch.device("cuda", 0)
    tracing.clear()
    with tracing.span("outer"):
        _build.launch("otmb_thomas_solve_f32", [], device)
        _build.launch("otmb_thomas_solve_f32", [], device)
        with tracing.span("inner"):
            _build.launch("otmb_bicg1_s_f32", [], device)
            _build.launch("otmb_bicg1_sums_f32", [], device)
        with pytest.raises(RuntimeError, match="fake error"):
            _build.launch("otmb_bad_f32", [], device)
        _build.launch("otmb_redi_f32_f32", [], device)
        _build.launch("otmb_redi_f32_f32", [], device, batch=True)
    assert _build.calls() == 6
    assert _build.calls("otmb_thomas_") == 2 and _build.calls("otmb_bicg1_") == 2
    assert _build.calls("otmb_bicg1_s_") == 1 and _build.calls("otmb_bad_") == 0
    assert _build.calls(("otmb_thomas_", "otmb_bicg1_sums_")) == 3
    assert _build.calls(_build.KERNELS["K6"]) == _build.calls(_build.KERNELS["K6 multi"]) == 1
    assert {s.name: s.calls for s in tracing.spans()} == {"inner": 2, "outer": 6}


def test_kernels_name_every_entry_once():
    """Each C entry the wrappers call is counted under one kernel of
    `_build.KERNELS`, and a batch through K6's or K7's entry under that
    kernel's "multi" entry alone."""
    from otmb_tpu_torch.models import redi_kernel
    from otmb_tpu_torch.ops import assemble, krylov, krylov_algebra, stencil, tridiag
    from otmb_tpu_torch.parallel import assemble_halo, halo_kernel, redi_halo

    tables = (stencil._ENTRY, stencil._MULTI_ENTRY, krylov._ENTRY, assemble._ENTRY,
              assemble._PREP_ENTRY, redi_kernel._ENTRY, halo_kernel._ENTRY,
              halo_kernel._PACK_ENTRY, halo_kernel._EDGE_ENTRY, assemble_halo._ENTRY,
              redi_halo._ENTRY)
    entries = [name for table in tables for name in table.values()]
    entries += [f"otmb_thomas_{e}_{t}" for e in ("factor", "solve")
                for t in tridiag._SUFFIX.values()]
    entries += [f"otmb_polish_{e}_{t}" for e in ("sums", "update")
                for t in krylov_algebra._TYPES.values()]
    entries += [f"otmb_bicg1_{e}_{t}" for e in krylov_algebra._BICG1_ARGTYPES
                for t in krylov_algebra._TYPES.values()]
    entries += ["otmb_probe_f32"]
    entries += ["multi:" + name for name in (*redi_kernel._ENTRY.values(),
                                             *halo_kernel._ENTRY.values())]
    for name in entries:
        kernels = [k for k, prefixes in _build.KERNELS.items() if name.startswith(prefixes)]
        assert len(kernels) == 1, (name, kernels)
    for k, prefixes in _build.KERNELS.items():
        assert any(name.startswith(prefixes) for name in entries), k
