"""The readers of the program's spans (`spans.py`) on a synthetic device
trace and synthetic spans: the device's idle time split by the innermost
span open on the host, the three idle shares summing to `idle_share`, the
innermost span winning, spans clipped to the traced stretch, the host time
and the calls an iteration, set-up's grid seconds, and None wherever the
run gives nothing to read."""

import pytest

from otmb_bench import readers
from otmb_bench import spans as SP
from otmb_bench import spec
from otmb_bench.window import Record, Trace, Window
from otmb_tpu_torch.utils.tracing import Span

BASE = 1_760_000_000  # seconds since the epoch, as time.time_ns() reads


def ns(t: float) -> int:
    return BASE * 10**9 + round(t * 1e9)


def op(name, a, b):
    return (name, BASE + a, BASE + b)


class View:
    def __init__(self, ops, span_s):
        self.window = Window([Record(1.0, 1, {}, True, True)], 5.0,
                             None if ops is None else Trace(ops, span_s))
        self.work, self.kind, self.setup_s = {}, "NVIDIA H100 80GB HBM3", 1.0


def span(name, a, b, i, parent=None, calls=0, **attrs):
    return Span(name, ns(a), ns(b), i, parent, 1, 0, attrs, calls)


#: Device busy [10.0, 10.2], [10.5, 10.6], [11.0, 11.1], [11.5, 12.0]: the
#: stretch is [10, 12], idle 1.1 s inside it, the host's window 2.5 s.
OPS = [op("k", 10.0, 10.2), op("k", 10.5, 10.6), op("k", 11.0, 11.1), op("k", 11.5, 12.0)]
SPANS = [
    span("engine.steps", 10.1, 10.4, 3, 2, calls=27, iters=3),
    span("engine.read", 10.4, 10.7, 4, 2),
    span("engine.read", 10.9, 11.05, 6, 5),  # inside the steps below: innermost wins
    span("engine.steps", 10.7, 11.3, 5, 2, calls=27, iters=3),
    span("engine.read", 11.3, 11.6, 7, 2),
    span("engine", 9.8, 12.2, 2, 1),
    span("ideal_age", 9.5, 12.5, 1),
]


def test_the_idle_time_splits_by_the_innermost_span():
    view = View(OPS, 2.5)
    split = SP.idle_by_span(view.window.trace, SPANS)
    assert split == {"engine.steps": pytest.approx(0.6, abs=1e-6),
                     "engine.read": pytest.approx(0.5, abs=1e-6)}


def test_the_three_idle_shares_sum_to_idle_share():
    view, rec = View(OPS, 2.5), (SPANS, 0)
    total = readers.idle_share(view)
    issuing = SP.idle_share_in(view, "engine.steps", rec)
    reading = SP.idle_share_in(view, "engine.read", rec)
    rest = SP.idle_rest(view, ("engine.steps", "engine.read"), rec)
    assert total == pytest.approx(64.0)
    assert (issuing, reading, rest) == (pytest.approx(24.0, abs=1e-4),
                                        pytest.approx(20.0, abs=1e-4),
                                        pytest.approx(20.0, abs=1e-4))  # the edges
    assert issuing + reading + rest == pytest.approx(total, abs=1e-12)


def test_a_read_nested_in_steps_counts_as_reading():
    ops = [op("k", 0.0, 1.0), op("k", 2.0, 3.0)]
    nested = [span("engine.steps", 0.5, 2.5, 2, calls=9, iters=1),
              span("engine.read", 0.9, 2.1, 3, 2)]
    split = SP.idle_by_span(View(ops, 3.0).window.trace, nested)
    assert split == {"engine.read": pytest.approx(1.0, abs=1e-6)}


def test_spans_are_clipped_to_the_stretch():
    """A span that starts before the stretch, or ends after it, counts only
    inside it, and the iteration metrics take whole spans only."""
    ops = [op("k", 10.0, 10.2), op("k", 10.6, 11.0)]
    edge = [span("engine.steps", 9.0, 10.4, 2, calls=90, iters=10),
            span("engine.read", 10.4, 11.5, 3)]
    view, rec = View(ops, 1.0), (edge, 0)
    assert SP.idle_by_span(view.window.trace, edge) == {
        "engine.steps": pytest.approx(0.2, abs=1e-6), "engine.read": pytest.approx(0.2, abs=1e-6)}
    assert SP.host_us_per_call(view, rec) is None and SP.calls_per_iter(view, rec) is None
    inner = edge + [span("engine.steps", 10.05, 10.15, 4, calls=18, iters=2)]
    assert SP.calls_per_iter(view, (inner, 0)) == 9.0
    assert SP.host_us_per_call(view, (inner, 0)) == pytest.approx(1e5 / 18, rel=1e-6)


def test_host_time_and_calls_an_iteration():
    view, rec = View(OPS, 2.5), (SPANS, 0)
    assert SP.calls_per_iter(view, rec) == 9.0
    assert SP.host_us_per_call(view, rec) == pytest.approx(0.9e6 / 54, rel=1e-6)


def test_nothing_to_read_gives_none(monkeypatch):
    names = ("engine.steps", "engine.read")
    for view, rec in ((View(None, 2.5), (SPANS, 0)),  # no trace
                      (View([], 2.5), (SPANS, 0)),  # a trace without a device operation
                      (View(OPS, 2.5), ([span("x", 1.0, 2.0, 9)], 0)),  # no span in it
                      (View(OPS, 2.5), (SPANS, 4))):  # dropped spans the stretch may hold
        assert SP.idle_share_in(view, "engine.steps", rec) is None
        assert SP.idle_rest(view, names, rec) is None
        assert SP.host_us_per_call(view, rec) is None and SP.calls_per_iter(view, rec) is None
    # dropped, but all before the stretch: the oldest span kept closed before it
    old = [span("ideal_age", 1.0, 2.0, 90)] + SPANS
    assert SP.calls_per_iter(View(OPS, 2.5), (old, 4)) == 9.0
    # a program without the recorder: every reader, through the metric files
    monkeypatch.setattr(SP, "program_spans", lambda: None)
    for name in ("idle_issuing.solve", "idle_reading.solve", "idle_rest.solve",
                 "host_us_per_call.solve", "calls_per_iter.solve", "setup_grid_s"):
        assert spec.reader(name)(View(OPS, 2.5)) is None


def test_the_metric_files_read_the_recorder(monkeypatch):
    monkeypatch.setattr(SP, "program_spans", lambda: (SPANS, 0))
    view = View(OPS, 2.5)
    got = {name: spec.reader(name)(view) for name in (
        "idle_issuing.solve", "idle_reading.solve", "idle_rest.solve",
        "host_us_per_call.solve", "calls_per_iter.solve")}
    assert got == {"idle_issuing.solve": pytest.approx(24.0, abs=1e-4),
                   "idle_reading.solve": pytest.approx(20.0, abs=1e-4),
                   "idle_rest.solve": pytest.approx(20.0, abs=1e-4),
                   "host_us_per_call.solve": pytest.approx(0.9e6 / 54, rel=1e-6),
                   "calls_per_iter.solve": 9.0}


def test_setup_grid_seconds_sum_the_grid_roots():
    setup = [span("makegridmetrics", 0.0, 1.5, 11), span("makeindices", 1.5, 1.75, 12),
             span("facefluxesfrommasstransport", 1.75, 2.0, 13),
             span("makeindices", 3.0, 4.0, 15, parent=14),  # inside another call: not set-up's
             span("assemble_T", 2.0, 2.5, 14)]
    view = View(OPS, 2.5)
    assert SP.setup_grid_s(view, (setup, 0)) == pytest.approx(2.0, abs=1e-6)
    assert SP.setup_grid_s(view, (setup, 1)) is None  # set-up's spans go first
    assert SP.setup_grid_s(view, (SPANS, 0)) is None
