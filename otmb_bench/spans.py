"""Shared arithmetic of the readers of the program's own spans
(`otmb_tpu_torch.utils.tracing`), laid over the device trace.

The program stamps its spans with `time.time_ns()`, the clock on which
`torch.profiler` places the device's operations, so the two line up. The
stretch is the traced one, from the first device operation's start to the
last one's end; spans are clipped to it. Each instant of the stretch in
which no device operation runs is charged to the innermost program span
open on the host at that instant, or to none.

Every reader returns None where the run gives it nothing to read: no
trace, a program without the recorder (it reads nothing and raises
nothing), no span in the stretch, a buffer that dropped spans the stretch
may hold, or a denominator of 0.
"""

from __future__ import annotations

from .readers import idle_share

#: The set-up path's grid calls, each a root span of the process.
SETUP_GRID = ("makegridmetrics", "makeindices", "facefluxesfrommasstransport")


def program_spans():
    """(the recorder's spans, oldest first; the count it dropped), or None
    where the program has no recorder."""
    try:
        from otmb_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.dropped()


def stretch(trace) -> tuple[float, float] | None:
    """[first device operation's start, last one's end] in seconds, or None."""
    if trace is None or not trace.ops or trace.span_s <= 0:
        return None
    return min(o[1] for o in trace.ops), max(o[2] for o in trace.ops)


def in_stretch(trace, recorded) -> list | None:
    """The spans that overlap the stretch, or None where there are none or
    the buffer may have dropped some of them (spans are kept in the order
    they closed, so every dropped one closed before the oldest kept)."""
    lo_hi = stretch(trace)
    if lo_hi is None or recorded is None:
        return None
    spans, dropped = recorded
    lo, hi = lo_hi
    if dropped and (not spans or spans[0].end_ns * 1e-9 >= lo):
        return None
    inside = [s for s in spans if s.end_ns * 1e-9 > lo and s.start_ns * 1e-9 < hi]
    return inside or None


def innermost(spans, lo: float, hi: float) -> list:
    """(start, end, name) segments covering [lo, hi], each named by the
    innermost span open through it (None where none is). Spans nest, as one
    thread's do."""
    segments, stack, at = [], [], lo

    def upto(t):
        nonlocal at
        t = min(max(t, lo), hi)
        if t > at:
            segments.append((at, t, stack[-1].name if stack else None))
            at = t

    def close():
        upto(stack[-1].end_ns * 1e-9)
        stack.pop()

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            close()
        upto(s.start_ns * 1e-9)
        stack.append(s)
    while stack:
        close()
    upto(hi)
    return segments


def idle(ops, lo: float, hi: float) -> list:
    """The intervals of [lo, hi] in which no device operation runs."""
    out, at = [], lo
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def idle_by_span(trace, spans) -> dict:
    """Device-idle seconds of the stretch by the innermost program span open
    on the host (None: no span), from the spans that overlap it."""
    lo, hi = stretch(trace)
    gaps, segments = idle(trace.ops, lo, hi), innermost(spans, lo, hi)
    out, i = {}, 0
    for a, b in gaps:
        while i < len(segments) and segments[i][1] <= a:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < b:
            s0, s1, name = segments[j]
            overlap = min(b, s1) - max(a, s0)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap
            j += 1
    return out


def idle_share_in(run, name: str, recorded=None) -> float | None:
    """% of the traced stretch (over `trace.span_s`, `idle_share`'s
    denominator) in which the device was idle while `name` was the
    innermost program span."""
    tr = run.window.trace
    spans = in_stretch(tr, program_spans() if recorded is None else recorded)
    if spans is None:
        return None
    return 100.0 * idle_by_span(tr, spans).get(name, 0.0) / tr.span_s


def idle_rest(run, names, recorded=None) -> float | None:
    """`idle_share` less the shares of the spans `names`."""
    recorded = program_spans() if recorded is None else recorded
    total = idle_share(run)
    parts = [idle_share_in(run, name, recorded) for name in names]
    if total is None or None in parts:
        return None
    return total - sum(parts)


def _whole_steps(run, recorded):
    """The `engine.steps` spans that lie wholly inside the stretch."""
    tr = run.window.trace
    spans = in_stretch(tr, program_spans() if recorded is None else recorded)
    if spans is None:
        return None
    lo, hi = stretch(tr)
    return [s for s in spans if s.name == "engine.steps" and lo <= s.start_ns * 1e-9
            and s.end_ns * 1e-9 <= hi]


def host_us_per_call(run, recorded=None) -> float | None:
    """Host microseconds an entry call while the engine issues its
    iterations: the stretch's `engine.steps` spans' length over their
    calls."""
    steps = _whole_steps(run, recorded)
    calls = sum(s.calls for s in steps or ())
    if not calls:
        return None
    return 1e-3 * sum(s.end_ns - s.start_ns for s in steps) / calls


def calls_per_iter(run, recorded=None) -> float | None:
    """Entry calls a matvec pair in the stretch's `engine.steps` spans."""
    steps = _whole_steps(run, recorded)
    iters = sum(s.attrs.get("iters", 0) for s in steps or ())
    if not iters:
        return None
    return sum(s.calls for s in steps) / iters


def setup_grid_s(run, recorded=None) -> float | None:
    """Seconds in the process's root spans of the set-up path's grid calls;
    None where the recorder dropped spans (set-up's are the oldest)."""
    recorded = program_spans() if recorded is None else recorded
    if recorded is None or recorded[1]:
        return None
    found = [s for s in recorded[0] if s.parent is None and s.name in SETUP_GRID]
    if not found:
        return None
    return 1e-9 * sum(s.end_ns - s.start_ns for s in found)
