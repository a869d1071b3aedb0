"""The port's span recorder: named regions at the boundaries of the live
consumer and the clip export, and inside the colour step and the
time-parallel phase clip, kept in memory.

``span(name, id)`` is a context manager. Off (the default) it checks one
module-level flag and returns a shared null context: nothing is recorded,
allocated or entered. Between ``enable()`` and ``disable()`` it records the
region's name, start and end in int ns on ``engine/frame.py::now()``'s clock
(``time.monotonic_ns``), the thread, the parent (the innermost span open in
that thread), the frame's identifier (a span opened without one takes its
parent's, so the spans inside a frame's step carry the frame's ``seq``), and
enters ``torch.profiler.record_function(name)``, so the same region shows in
a profiler's trace. A span that holds a host<->device copy (``copy=`` the
device) carries the bytes it moves and, on a CUDA device, a pair of
``torch.cuda.Event`` around it. Their elapsed time is the stream's time over
the whole region: with pageable host memory that holds CUDA's staging
through its pinned buffer as well as the transfer, and any layout kernel the
region issues. A span over device work that is no copy (``device=`` the
device) gets the same pair on a CUDA device and enters no
``record_function``: the profiler would give such a range a device-side
shadow spanning its first kernel to its last, idle gaps included, which a
trace's reduction would read as device work. The events are read only once
the end event has completed, which the program's own synchronisations bring
about (the readbacks). No span adds a synchronisation or a copy.

``torch.profiler`` stamps its events on the wall clock (CLOCK_REALTIME);
``enable()`` takes an anchor between the two clocks and ``to_trace_ns`` maps a
span's stamp onto the profiler's timeline with it. Spans go into a ring of
``CAPACITY`` records; the oldest are overwritten, and no file is written.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, Optional

import torch

CAPACITY = 1 << 16   # spans kept; the oldest are overwritten
EVENT_POOL = 64      # CUDA events kept for reuse
ANCHOR_READS = 16    # clock pairs read for the anchor; the tightest is kept

_on = False
_NULL = contextlib.nullcontext()
_ring: List[Optional["Span"]] = [None] * CAPACITY
_written = itertools.count()       # next() is atomic under the interpreter lock
_local = threading.local()         # each thread's stack of open spans
_offset_ns = 0                     # wall clock minus monotonic clock, from the anchor
_events: List[torch.cuda.Event] = []   # free events
_pending: collections.deque = collections.deque()  # spans whose events are unread
_pending_lock = threading.Lock()


class Span:
    """One region: ``start_ns`` / ``end_ns`` on the monotonic clock (ns),
    ``thread`` (``threading.get_ident()``), ``parent`` (the enclosing Span or
    None), ``id`` (the frame's ``seq`` or a clip cursor), ``nbytes`` (a
    copy's bytes) and ``device_ms`` (the stream time from the start event to
    the end event of a copy or device region, None until read or off a CUDA
    device). ``twin``: whether the span enters ``record_function``."""

    __slots__ = ("name", "id", "start_ns", "end_ns", "thread", "parent", "nbytes",
                 "device_ms", "_device", "_pair", "_rf", "_twin")

    def __init__(self, name: str, id=None, start_ns: int = 0, end_ns: int = 0, thread: int = 0,
                 parent: Optional["Span"] = None, nbytes: int = 0,
                 device_ms: Optional[float] = None, device=None, twin: bool = True):
        self.name, self.id = name, id
        self.start_ns, self.end_ns = start_ns, end_ns
        self.thread, self.parent = thread, parent
        self.nbytes, self.device_ms = nbytes, device_ms
        self._device, self._pair, self._rf, self._twin = device, None, None, twin

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.id is None and self.parent is not None:
            self.id = self.parent.id
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.monotonic_ns()
        if self._twin:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self._device is not None and self._device.type == "cuda":
            self._pair = (_event(), _event())
            self._pair[0].record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc) -> None:
        if self._pair is not None:
            self._pair[1].record(torch.cuda.current_stream(self._device))
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.monotonic_ns()
        _stack().pop()
        _ring[next(_written) % CAPACITY] = self
        if self._pair is not None:
            _pending.append(self)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event() -> torch.cuda.Event:
    with _pending_lock:
        if _events:
            return _events.pop()
    return torch.cuda.Event(enable_timing=True)


def _read_events() -> None:
    """Read the device time of every span whose end event has completed
    (``query`` does not wait) and return its events to the pool."""
    with _pending_lock:
        while _pending and _pending[0]._pair[1].query():
            s = _pending.popleft()
            start, end = s._pair
            s.device_ms, s._pair, s._device = start.elapsed_time(end), None, None
            if len(_events) < EVENT_POOL:
                _events.extend((start, end))


def span(name: str, id=None, copy=None, nbytes: int = 0, device=None):
    """A named region (see the module's docstring). ``copy``: the device of a
    host<->device copy the region holds, ``nbytes`` the bytes it moves;
    ``device``: the device of the device work the region issues, timed by
    events and kept out of the profiler's trace."""
    if not _on:
        return _NULL
    timed = copy if copy is not None else device
    if timed is not None:
        _read_events()
    return Span(name, id, nbytes=nbytes, device=timed, twin=device is None)


def anchor() -> int:
    """Wall clock minus monotonic clock (ns), from the tightest of
    ``ANCHOR_READS`` back-to-back readings."""
    best = None
    for _ in range(ANCHOR_READS):
        a = time.monotonic_ns()
        wall = time.time_ns()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def enable() -> None:
    """Record spans from now on, and take the anchor between the clocks."""
    global _on, _offset_ns
    _offset_ns = anchor()
    _on = True


def disable() -> None:
    """Stop recording; the spans recorded stay readable."""
    global _on
    _on = False


def to_trace_ns(t_ns: int) -> int:
    """A span's stamp (monotonic ns) on the profiler's clock (wall ns)."""
    return t_ns + _offset_ns


def spans(t0: float, t1: float) -> List[Span]:
    """The spans recorded that overlap [t0, t1] (s on ``now()``'s clock), by
    start; copy and device spans carry ``device_ms`` where their events have
    completed."""
    _read_events()
    a, b = round(t0 * 1e9), round(t1 * 1e9)
    held = [s for s in list(_ring) if s is not None and s.start_ns <= b and s.end_ns >= a]
    return sorted(held, key=lambda s: s.start_ns)
