"""Shared arithmetic of the metric readers in `metrics/`: each reader is a
`read(run)` that returns a number, or None where the run gives it nothing
to read (a run without a trace, a trace without a device operation, a card
without a published peak)."""

from __future__ import annotations

from . import roofline
from .window import percentile, rate, union_seconds


def per_unit(run, scale: float = 1.0) -> float:
    """Window seconds over all the work of the window, times `scale`."""
    w = run.window
    return scale * rate(w.seconds, sum(r.units for r in w.records))


def p90(run) -> float:
    return percentile([r.wall_s for r in run.window.records], 90)


def mean_counter(run, name: str) -> float | None:
    values = [r.counters[name] for r in run.window.records if name in r.counters]
    return sum(values) / len(values) if values else None


def idle_share(run) -> float | None:
    """% of the traced stretch in which no device operation ran."""
    tr = run.window.trace
    if tr is None or not tr.ops or tr.span_s <= 0:
        return None
    return 100.0 * (1.0 - union_seconds(tr.ops) / tr.span_s)


def roofline_share(run, work: str, bytes_fn, kernels=None) -> float | None:
    """% of the published bandwidth bound: the compulsory bytes of the
    traced requests' work (`bytes_fn` per unit) over the device seconds of
    the trace's operations (those whose names contain one of `kernels`,
    or all)."""
    tr, peak = run.window.trace, roofline.peak_bytes_per_s(run.kind)
    params = run.work.get(work)
    if tr is None or not tr.ops or peak is None or params is None:
        return None
    units = sum(r.counters.get("krylov_iters", r.units) if work == "krylov" else r.units
                for r in run.window.traced)
    picked = [op for op in tr.ops if kernels is None or any(k in op[0] for k in kernels)]
    seconds = sum(e - s for _, s, e in picked)
    if units <= 0 or seconds <= 0:
        return None
    p = params
    return 100.0 * units * bytes_fn(p["shape"], p["vec_bytes"], p["coef_bytes"],
                                    p["batch"]) / peak / seconds
