"""Spans and counters of the port, held in memory; nothing is written out.

``span(name)`` marks a layer boundary on the calling thread::

    with trace.span("project"):
        attrs, aux = project_gaussians(...)

Tracing is off by default: ``span`` then returns one shared no-op object
after a single flag check, and records, reads and launches nothing.
``enable()`` turns it on, ``disable()`` off, and ``take()`` returns what
was recorded since the last ``take()`` and clears it.

A span is ``(name, start, end, parent, thread)``.  Times are Unix-epoch
nanoseconds (``time.time_ns()``), the clock of a ``torch.profiler`` trace
(an event's ``ts`` in microseconds plus the trace's
``baseTimeNanoseconds``), so spans join to the device trace by time: a
launch belongs to the innermost span, on any thread, whose interval holds
the launch's host time.  The parent stack is kept per thread; ``parent``
is the index, in the same ``take()``, of the enclosing span on that
thread (None at a root).  ``thread`` is the native thread id.

Counters: ``count(name)`` adds to an integer that is always kept (the
kernel wrappers' launch counts, ``launches.<wrapper>``, read by
``ops.kernel_launches()``; ``raster.packed_calls``, the calls of
``ops/rasterize.py:pack_entry_attrs`` on the card, which the render, the
training step and the metric views never make); ``counters()`` returns
them.  ``gauge(name,
value)`` records a value the host already holds, with its time, only
while tracing is on (``slots.alive`` and ``slots.capacity`` at each
``train.step``).

The spans (parent in brackets): ``train.step``; ``project``, ``bin``,
``raster`` [a step or ``view.frame``]; ``loss``, ``backward``,
``sh_vjp`` (the SH colour's VJP, opened just before ``project_vjp``),
``project_vjp``, ``adam``, ``wait.entry_cap``, ``wait.rate``,
``densify.event`` [``train.step``]; ``densify.grow``,
``densify.importance``, ``densify.prune``, ``wait.event_counts``
[``densify.event``]; ``view.frame``; ``view.host_copy`` [``view.frame``].
No span opens inside an ``autograd.Function.backward``, which the engine
may run on a thread of its own.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start: int  # ns since the Unix epoch
    end: int
    parent: int | None  # index of the enclosing span in the same take()
    thread: int  # native thread id


class Gauge(NamedTuple):
    name: str
    time: int  # ns since the Unix epoch
    value: float
    thread: int


class Records(NamedTuple):
    spans: list[Span]
    gauges: list[Gauge]


_on = False
_lock = threading.Lock()
# open and closed spans as [name, start, end, parent record, thread]
_spans: list[list] = []
_gauges: list[Gauge] = []
_counters: dict[str, int] = {}
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        _local.stack = st = []
        _local.tid = threading.get_native_id()
    return st


class _Open:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.rec = [self.name, time.time_ns(), None,
                    st[-1] if st else None, _local.tid]
        with _lock:
            _spans.append(self.rec)
        st.append(self.rec)
        return None

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str):
    """A context manager that records ``name`` over its body while tracing
    is on, and the shared no-op otherwise."""
    if not _on:
        return _OFF
    return _Open(name)


def gauge(name: str, value: float) -> None:
    """Record ``value`` (held by the host) now, while tracing is on."""
    if _on:
        _stack()
        with _lock:
            _gauges.append(Gauge(name, time.time_ns(), value, _local.tid))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always kept; threads may share
    a counter, as the trainer and the viewer of ``serve --train`` do)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> Records:
    """The spans closed and the gauges recorded since the last call, in
    the order they were opened; spans still open stay for the next call."""
    global _spans, _gauges
    with _lock:
        recs, _spans = _spans, []
        gauges, _gauges = _gauges, []
        # one read of each end: another thread may close a span meanwhile
        done = [(r, r[2]) for r in recs]
        _spans.extend(r for r, end in done if end is None)
    done = [(r, end) for r, end in done if end is not None]
    pos = {id(r): i for i, (r, _) in enumerate(done)}
    return Records(
        [Span(r[0], r[1], end, None if r[3] is None else pos.get(id(r[3])),
              r[4]) for r, end in done], gauges)
