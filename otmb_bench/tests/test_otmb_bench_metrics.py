"""The benchmark's metric arithmetic: window over work, the percentile over
all requests, busy time and idle share from a trace, and a traced stretch
with no device operation taken again."""

import contextlib

import pytest

from otmb_bench import readers, run
from otmb_bench.window import (Record, Trace, Window, busiest, closed_loop, idle_gaps,
                               percentile, rate, short_name, union_seconds)


class View:
    def __init__(self, window, work=None, kind="NVIDIA H100 80GB HBM3"):
        self.window, self.work, self.kind, self.setup_s = window, work or {}, kind, 1.0


def records(walls, units=1, counters=None):
    return [Record(w, units, dict(counters or {}), True) for w in walls]


def test_rate_divides_the_whole_window_by_all_work():
    w = Window(records([0.1, 0.5, 0.2], units=50), seconds=1.0)
    assert readers.per_unit(View(w)) == pytest.approx(1.0 / 150)
    assert readers.per_unit(View(w), 1e3) == pytest.approx(1000.0 / 150)
    with pytest.raises(ValueError):
        rate(1.0, 0)


@pytest.mark.parametrize("n, want", [(10, 9), (100, 90), (101, 91), (1, 1)])
def test_p90_is_the_nearest_rank_over_every_request(n, want):
    walls = list(range(1, n + 1))[::-1]  # order does not matter
    assert percentile(walls, 90) == want
    assert readers.p90(View(Window(records(walls), seconds=n))) == want


def test_mean_counter_over_the_window():
    w = Window(records([1, 1]) + [Record(1, 1, {"krylov_iters": 10}, True),
                                   Record(1, 1, {"krylov_iters": 20}, True)], seconds=4)
    assert readers.mean_counter(View(w), "krylov_iters") == 15
    assert readers.mean_counter(View(w), "absent") is None


def test_union_and_idle_share_from_a_synthetic_trace():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0), ("d", 3.2, 3.5)]
    assert union_seconds(ops) == pytest.approx(3.0)
    w = Window(records([5.0]), seconds=5.0, trace=Trace(ops, 5.0))
    assert readers.idle_share(View(w)) == pytest.approx(40.0)
    gaps = idle_gaps(ops + [("a", 4.5, 5.0)])
    assert gaps[0] == ["b>c", pytest.approx(1.0)]
    assert gaps[1] == ["c>a", pytest.approx(0.5)]
    assert busiest(ops)[0] == ["b", pytest.approx(1.5)]


def test_no_trace_or_an_empty_one_reads_nothing():
    w = Window(records([1.0]), seconds=1.0)
    assert readers.idle_share(View(w)) is None
    w.trace = Trace([], 1.0)
    assert readers.idle_share(View(w)) is None
    assert readers.roofline_share(View(w, {"stencil": {}}), "stencil", None) is None


def test_roofline_share_counts_traced_work_over_device_seconds():
    recs = records([1.0, 1.0], units=10)
    recs[0].traced = True
    ops = [("stencil_multi_kernel<float>", 0.0, 0.5), ("memcpy", 0.5, 1.0)]
    w = Window(recs, seconds=2.0, trace=Trace(ops, 1.0))
    work = {"stencil": {"shape": (1, 1, 1), "vec_bytes": 1, "coef_bytes": 1, "batch": 1}}
    per_unit = lambda shape, v, c, b: 3.35e11  # 0.1 s at the peak
    assert readers.roofline_share(View(w, work), "stencil", per_unit) == pytest.approx(100.0)
    assert readers.roofline_share(View(w, work), "stencil", per_unit,
                                  ("stencil",)) == pytest.approx(200.0)
    assert readers.roofline_share(View(w, work, kind="other"), "stencil", per_unit) is None


def test_closed_loop_closes_after_the_request_in_flight():
    t = [0.0]
    clock = lambda: t[0]

    def request(i):
        t[0] += 0.4
        return Record(0.0, 1, {}, True)

    w = closed_loop(request, 1.0, lambda: None, clock)
    assert len(w.records) == 3 and w.seconds == pytest.approx(1.2)
    assert [r.wall_s for r in w.records] == pytest.approx([0.4] * 3)


def test_kernel_names_lose_their_arguments():
    assert short_name("void stencil_kernel<float, 1>(float*, int)") == "stencil_kernel<float, 1>"


def test_a_trace_without_device_operations_is_taken_again(monkeypatch):
    import torch.profiler

    started = []

    @contextlib.contextmanager
    def fake_profile(**kw):
        started.append(1)
        yield object()

    class Fake:
        def __init__(self, **kw):
            self.cm = fake_profile(**kw)

        def __enter__(self):
            return self.cm.__enter__()

        def __exit__(self, *a):
            return self.cm.__exit__(*a)

    reads = iter([[], [("k", 0.0, 0.1)]])
    monkeypatch.setattr(torch.profiler, "profile", Fake)
    monkeypatch.setattr("otmb_bench.window.device_ops", lambda prof: next(reads))
    t = [0.0]

    def clock():
        return t[0]

    def request(i):
        t[0] += 1.0
        return Record(0.0, 1, {}, True)

    tracer = run._Tracer(1.5, lambda: None, clock)
    w = closed_loop(tracer.wrap(request), 10.0, lambda: None, clock)
    tracer.stop()
    assert len(started) == 2  # the empty stretch, then its retake
    assert tracer.trace.ops == [("k", 0.0, 0.1)]
    traced = [i for i, r in enumerate(w.records) if r.traced]
    assert traced == [2, 3]  # the first stretch's records no longer count
