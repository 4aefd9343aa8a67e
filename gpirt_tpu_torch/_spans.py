"""The span recorder of the sweep: each block's host interval and stream
time, kept while a ``torch.profiler`` records or inside :func:`recording`.

Its public surface is ``utils/profiling.py``, which re-exports it; it lives
here, importing nothing of the package, so that the sweep's modules can
import it without a cycle through ``gpirt_tpu_torch.utils``.

A span is the program's own in-memory record, not a
``torch.profiler.record_function`` range: such a range is laid on the
device's timeline too, where it would read as device work. Its start and
end are ``time.time_ns()``, the Unix-epoch clock the profiler's events
report (``_KinetoEvent.start_ns()``), so the two can be joined by time. In
a process that has initialised CUDA it also records a pair of timing
events, taken from a pool, without a synchronize, on the stream current
when its outermost open span started (``torch.cuda.current_stream()``
costs as much as a launch, so a span inherits its parent's); their elapsed
time, read lazily in :func:`span_totals` once the work has finished, is
the time the stream took from the block's first enqueued work to its last.
On the CPU the host interval stands in for it.

With the recorder off, :func:`span` checks two flags and returns one shared
object whose ``__enter__`` and ``__exit__`` do nothing: no clock, no event,
no allocation. It never synchronizes, draws no random number and changes
no operation, so a sweep recorded is the sweep unrecorded, bit for bit.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "recording", "spans", "span_totals", "clear_spans"]

MAX_SPANS = 1 << 16  # records kept; later spans are counted in span.dropped


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the innermost span open on the thread at the start
    it: Optional[int]  # the sweep's absolute iteration, shared by its spans
    start_ns: int  # time.time_ns()
    end_ns: int
    stream_ms: float  # the stream's time between the span's events; the host's on the CPU


class SpanTotal(NamedTuple):
    count: int
    host_ns: int
    self_ns: int  # host ns less that of the spans opened directly inside
    stream_ms: float


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NOOP = _Noop()
_on = 0  # depth of recording() blocks
_records: List["_Open"] = []
_pool: Dict[int, list] = {}  # device index -> free timing events
_ids = itertools.count()
_local = threading.local()


class _Open:
    __slots__ = ("name", "id", "parent", "it", "t0", "t1", "stream", "events")

    def __init__(self, name: str, it: Optional[int]):
        self.name, self.it = name, it

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.it is None and parent is not None:
            self.it = parent.it
        self.id = next(_ids)
        stack.append(self)
        self.stream = self.events = None
        if len(_records) < MAX_SPANS:
            _records.append(self)
            if torch.cuda.is_initialized():
                self.stream = (parent.stream if parent is not None and parent.stream is not None
                               else torch.cuda.current_stream())
                self.events = _take_events(self.stream.device_index)
                self.events[0].record(self.stream)
        else:
            span.dropped += 1
        self.t1 = None
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        _local.stack.pop()
        return None


def _take_events(device: int):
    """(start, end, device index): a pair of timing events of ``device``,
    from the pool."""
    free = _pool.setdefault(device, [])
    if free:
        return free.pop()
    return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), device)


def span(name: str, it: Optional[int] = None):
    """A context manager over one block, recorded while a torch profiler
    records or inside :func:`recording`, under ``name``; ``it``, the sweep's
    absolute iteration, is given by the root and inherited by the spans
    opened inside it."""
    if _on or _autograd_profiler._is_profiler_enabled:
        return _Open(name, it)
    return _NOOP


span.dropped = 0


class recording:
    """Record spans inside this block, with no profiler running."""

    def __enter__(self):
        global _on
        _on += 1
        return self

    def __exit__(self, *exc):
        global _on
        _on -= 1
        return None


def _stream_ms(r: _Open) -> float:
    if r.events is None:
        return (r.t1 - r.t0) / 1e6
    r.events[1].synchronize()
    return r.events[0].elapsed_time(r.events[1])


def spans() -> List[Span]:
    """The spans kept, closed ones only, in the order they started."""
    return [Span(r.name, r.id, r.parent, r.it, r.t0, r.t1, _stream_ms(r))
            for r in _records if r.t1 is not None]


def span_totals() -> Dict[str, SpanTotal]:
    """Per span name: its count, host ns, host self ns and stream ms."""
    done = spans()
    child_ns: Dict[int, int] = {}
    for s in done:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    out: Dict[str, list] = {}
    for s in done:
        t = out.setdefault(s.name, [0, 0, 0, 0.0])
        ns = s.end_ns - s.start_ns
        t[0] += 1
        t[1] += ns
        t[2] += ns - child_ns.get(s.id, 0)
        t[3] += s.stream_ms
    return {k: SpanTotal(*v) for k, v in out.items()}


def clear_spans() -> None:
    """Forget the spans kept and the count dropped; their events go back to
    the pool."""
    for r in _records:
        if r.events is not None and r.t1 is not None:
            r.events[1].synchronize()
            _pool[r.events[2]].append(r.events)
    _records.clear()
    span.dropped = 0
