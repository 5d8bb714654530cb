"""The measured window: a closed loop with one client, the records it
keeps, and the reduction of a device trace to busy time and idle gaps.

One client sends the next request when the last returns, as a modeller's
script does. The window opens before the first request and closes when
the request in flight at `seconds` completes; every rate divides the whole
window by all the work in it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable


@dataclasses.dataclass
class Record:
    """One request: its wall seconds, its units of work (solves, cycles or
    steps), the program's counters, whether it met its limits, and whether
    it ran under the profiler."""

    wall_s: float
    units: int
    counters: dict
    ok: bool
    traced: bool = False


@dataclasses.dataclass
class Trace:
    """The device operations of a traced stretch of the window, as
    (name, start s, end s) on the device's clock, and the stretch's length
    on the host's clock."""

    ops: list
    span_s: float


@dataclasses.dataclass
class Window:
    records: list
    seconds: float
    trace: Trace | None = None

    @property
    def traced(self) -> list:
        return [r for r in self.records if r.traced]


def closed_loop(request: Callable[[int], Record], seconds: float,
                sync: Callable[[], None], clock=time.perf_counter) -> Window:
    """Requests 0, 1, 2, ... back to back until `seconds` have passed;
    `request(i)` returns its record (wall_s filled here), `sync` waits for
    the device."""
    records = []
    start = clock()
    while True:
        t0 = clock()
        rec = request(len(records))
        sync()
        now = clock()
        rec.wall_s = now - t0
        records.append(rec)
        if now - start >= seconds:
            return Window(records, now - start)


def rate(window_s: float, work: float) -> float:
    """Window seconds per unit of work."""
    if work <= 0:
        raise ValueError("no work completed in the window")
    return window_s / work


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all values (q in (0, 100])."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def union_seconds(ops) -> float:
    """Seconds in which at least one operation ran: the length of the union
    of the [start, end] intervals."""
    busy, end = 0.0, -math.inf
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def idle_gaps(ops, top: int = 10) -> list:
    """The idle gaps between device operations, named by the operations
    that bound them ("before>after"), summed over the trace by name: the
    `top` largest as [name, seconds]."""
    gaps, end, last = {}, -math.inf, None
    for name, s, e in sorted(ops, key=lambda o: o[1]):
        if last is not None and s > end:
            key = f"{last}>{name}"
            gaps[key] = gaps.get(key, 0.0) + (s - end)
        if e > end:
            end, last = e, name
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]


def busiest(ops, top: int = 10) -> list:
    """Device seconds summed by operation name: the `top` largest."""
    by = {}
    for name, s, e in ops:
        by[name] = by.get(name, 0.0) + (e - s)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def short_name(name: str) -> str:
    """A kernel's name without its argument list or return type."""
    base = name.split("(")[0].strip()
    for prefix in ("void ", "__global__ "):
        if base.startswith(prefix):
            base = base[len(prefix):]
    return base[:80]


def device_ops(prof) -> list:
    """(name, start s, end s) of every device operation in a finished
    `torch.profiler` trace."""
    from torch.autograd import DeviceType

    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns() * 1e-9
                out.append((short_name(e.name()), s, s + e.duration_ns() * 1e-9))
        return out
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((short_name(e.name), e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    return out
