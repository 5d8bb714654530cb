"""Spans of the program's own work, on the clock of the device trace.

A span is a named stretch of host time: the public call it belongs to, a
refinement pass, a part of a Krylov chunk, a read of the residual. Each
records its start and end from `time.time_ns()`, the clock on which
`torch.profiler` places both host and device events, so a span can be laid
over a device trace taken in the same process. It also records the span
that caused it (`parent`), the public call it belongs to (`root`: the
spans of one request share it), the process's rank, its attributes, and
`calls`: the C entry calls `_build.launch` made while it was open.

The recorder is always on and costs 1.5–2.8 µs a span (timed on the host
of an H100 machine). It keeps the newest `CAPACITY` finished spans in
memory and counts what it had to drop; it writes nothing. After a run:

    from otmb_tpu_torch.utils import tracing
    for s in tracing.spans():
        print(s.name, (s.end_ns - s.start_ns) * 1e-9, s.calls, s.attrs)

Spans nest per thread. They are plain clock readings and never profiler
ranges, which a trace would place on the device's timeline among the
kernels.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import NamedTuple

from .. import _build

#: Finished spans kept: six times a 51 s window of the busiest request mix
#: (the 1-degree refined age, about 100 spans a 0.26 s request), set-up's
#: included.
CAPACITY = 1 << 17


class Span(NamedTuple):
    """One finished span. Times are `time.time_ns()`."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None  # the enclosing span's id; None for a root
    root: int  # the root's id (its own for a root)
    rank: int
    attrs: dict
    calls: int  # C entry calls made inside it (`_build.calls`)


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_stack = _Stack()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class span:
    """A context manager that records one span named `name` with the
    attributes `attrs`; more may be added to `.attrs` while it is open.
    After it closes, `.start_ns` and `.end_ns` hold its clock readings."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "rank", "start_ns", "end_ns",
                 "_calls")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "span":
        open_ = _stack.open
        self.id = next(_ids)
        if open_:
            top = open_[-1]
            self.parent, self.root, self.rank = top.id, top.root, top.rank
        else:
            self.parent, self.root, self.rank = None, self.id, _rank()
        open_.append(self)
        self._calls = _build._total  # `_build.calls()`, read without the call
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        self.end_ns = end = time.time_ns()
        _stack.open.pop()
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        # a plain tuple: `spans()` makes the `Span`s, off the hot path
        _buffer.append((self.name, self.start_ns, end, self.id, self.parent, self.root,
                        self.rank, self.attrs, _build._total - self._calls))

    @property
    def seconds(self) -> float:
        """The closed span's length in seconds."""
        return (self.end_ns - self.start_ns) * 1e-9


def traced(fn):
    """Run `fn` inside a span named after it: a public entry point's span,
    a root when nothing encloses the call."""
    name = fn.__name__

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return inner


def spans() -> list[Span]:
    """A copy of the finished spans kept, oldest first (in the order they
    closed)."""
    return [Span._make(s) for s in _buffer]


def dropped() -> int:
    """Finished spans dropped, oldest first, since the last `clear`."""
    return _dropped


def clear() -> None:
    """Empty the buffer and zero the dropped count."""
    global _dropped
    _buffer.clear()
    _dropped = 0
