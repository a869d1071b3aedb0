"""The program's own spans (``engine/profiling.py``) in a traced run, and the
device's idle time put down to them.

``install()`` hooks the program's recorder into ``trace.Tracer``: a traced
run's tracer turns the recorder on when it is made (before the set-up) and
off when it first reduces its slice (a camera run: after its first slice; an
export run: after the window). Untraced runs never turn it on. The slice's
reduction leaves out the device-side shadows that ``torch.profiler`` gives
each ``record_function`` range holding kernels (a device event named as a
host event: the range from its first kernel to its last, gaps included), so
that ``trace``'s own outputs read the kernels and copies alone, as they did
before the program had spans (only events named as the program's spans,
``PROGRAM``, are taken for shadows); and it keeps on the ``trace.Slice`` every idle
gap between device intervals (``gaps``, ns on the profiler's clock), not only
the longest that ``reduce_events`` names. The span readers call ``install``
when they load, before the run starts. Where the program has no recorder (an
older checkout) nothing is recorded and the readers find nothing: each
returns None where it finds nothing to read.

Host times are read from the spans of the measured window (from the end of
the set-up) that do not overlap the profiled slices, so the profiler's own
cost stays out of them, as it stays out of the stamp metrics
(``readers._stamps``). The idle time is read inside the slice, with the spans
put on the profiler's clock by ``profiling.to_trace_ns``.
"""

from __future__ import annotations

import functools
import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from benchmark.harness import trace
from live_video_magnification_tpu_torch.engine import profiling

_RECORDER = hasattr(profiling, "spans")
PROGRAM = ("consumer.", "export.")  # the prefixes of the program's span names


def device_work(events) -> list:
    """``events`` without the device-side shadows of the program's spans."""
    host = {n for n, d, _, _ in events if not d and n.startswith(PROGRAM)}
    return [ev for ev in events if not (ev[1] and ev[0] in host)]


def device_gaps(events) -> np.ndarray:
    """The idle intervals between the device's busy intervals, (G, 2) ns,
    sorted and disjoint; ``events`` as ``trace.reduce_events`` takes them."""
    dev = sorted((s, e) for n, d, s, e in events
                 if d and e > s and not n.startswith("Activity Buffer"))
    if len(dev) < 2:
        return np.zeros((0, 2), dtype=np.int64)
    iv = np.array(dev, dtype=np.int64)
    run_end = np.maximum.accumulate(iv[:, 1])
    new = np.flatnonzero(iv[1:, 0] > run_end[:-1]) + 1
    return np.stack([run_end[new - 1], iv[new, 0]], axis=1)


def install() -> None:
    """Hook the program's recorder and the gaps into ``trace`` (once)."""
    if getattr(trace.Tracer, "program_spans", False):
        return
    init, reduce, reduce_events = trace.Tracer.__init__, trace.Tracer.reduce, trace.reduce_events

    @functools.wraps(init)
    def init_with_spans(self, enabled, device):
        init(self, enabled, device)
        if enabled and _RECORDER:
            profiling.enable()

    @functools.wraps(reduce)
    def reduce_with_spans(self):
        if _RECORDER:
            profiling.disable()
        return reduce(self)

    @functools.wraps(reduce_events)
    def reduce_with_gaps(events, window_s, frames):
        work = device_work(events)
        sl = reduce_events(work, window_s, frames)
        sl.gaps = device_gaps(work)
        return sl

    trace.Tracer.__init__, trace.Tracer.reduce = init_with_spans, reduce_with_spans
    trace.reduce_events = reduce_with_gaps
    trace.Tracer.program_spans = True


def profiled(ctx) -> List:
    """The program's spans that overlap the profiled slices."""
    return profiling.spans(*ctx.span) if _RECORDER and ctx.span[1] > 0 else []


def unprofiled(ctx) -> List:
    """The program's spans of the measured window that overlap no profiled slice."""
    if not _RECORDER or ctx.span[1] <= 0:
        return []
    a, b = (round(t * 1e9) for t in ctx.span)
    return [s for s in profiling.spans(ctx.window.setup_end, time.monotonic())
            if s.end_ns < a or s.start_ns > b]


def idle_ns(gaps: np.ndarray, start, end) -> np.ndarray:
    """ns of the gaps inside each [start_i, end_i] (profiler's clock)."""
    if not len(gaps):
        return np.zeros(len(start), dtype=np.int64)
    g0, g1 = gaps[:, 0], gaps[:, 1]
    cum = np.concatenate([[0], np.cumsum(g1 - g0)])

    def before(x):  # idle ns before x: whole gaps that start by x, less the last one's overhang
        i = np.searchsorted(g0, x, side="right")
        overhang = np.where(i > 0, np.maximum(g1[np.maximum(i - 1, 0)] - x, 0), 0)
        return cum[i] - overhang

    return before(np.asarray(end, dtype=np.int64)) - before(np.asarray(start, dtype=np.int64))


def idle_split(gaps: np.ndarray, spans: Sequence) -> Dict[str, float]:
    """The gaps' seconds by the innermost of ``spans`` (one thread's) over
    them, by span name, and under "outside" what no span covers."""
    total = int((gaps[:, 1] - gaps[:, 0]).sum()) if len(gaps) else 0
    if not spans:
        return {"outside": total * 1e-9}
    inside = idle_ns(gaps, [profiling.to_trace_ns(s.start_ns) for s in spans],
                     [profiling.to_trace_ns(s.end_ns) for s in spans])
    own = {id(s): int(v) for s, v in zip(spans, inside)}
    self_ns = dict(own)
    roots = 0
    for s in spans:
        if s.parent is not None and id(s.parent) in own:
            self_ns[id(s.parent)] -= own[id(s)]
        else:
            roots += own[id(s)]
    split = defaultdict(float)
    for s in spans:
        split[s.name] += self_ns[id(s)] * 1e-9
    split["outside"] = (total - roots) * 1e-9
    return dict(split)


def median_ms(ctx, name: str) -> Optional[float]:
    """Median host ms of the unprofiled spans named ``name``."""
    ms = [s.ms for s in unprofiled(ctx) if s.name == name]
    return statistics.median(ms) if ms else None


def export_ms_per_frame(ctx, name: str) -> Optional[float]:
    """Host ms of the unprofiled spans named ``name``, summed, over the frames
    of the chunks they lie in (the chunks' ``export.h2d`` bytes over a
    frame's: u8, 3 channels at the configuration's size)."""
    held = unprofiled(ctx)
    ms = [s.ms for s in held if s.name == name]
    frames = sum(_chunk_frames(ctx, s) for s in held if s.name == "export.h2d")
    return sum(ms) / frames if ms and frames else None


def _chunk_frames(ctx, h2d) -> float:
    """The frames of a chunk: its ``export.h2d`` bytes over a frame's (u8, 3
    channels at the configuration's size)."""
    return h2d.nbytes / (3 * ctx.config["height"] * ctx.config["width"])


def copy_device_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Median over unprofiled frames of the device ms (CUDA events) of the
    copy spans ``names``, for the frames that have all of them read."""
    by_frame = defaultdict(dict)
    for s in unprofiled(ctx):
        if s.name in names and s.device_ms is not None:
            by_frame[s.id][s.name] = s.device_ms
    ms = [sum(d.values()) for d in by_frame.values() if len(d) == len(names)]
    return statistics.median(ms) if ms else None


def export_copy_device_ms(ctx) -> Optional[float]:
    """Device ms a frame (CUDA events) of the unprofiled chunks' ``export.h2d``
    and ``export.readback``, over the chunks that have both read."""
    by_chunk = defaultdict(dict)
    for s in unprofiled(ctx):
        if s.name in ("export.h2d", "export.readback") and s.device_ms is not None:
            by_chunk[s.id][s.name] = s
    held = [c for c in by_chunk.values() if len(c) == 2]
    frames = sum(_chunk_frames(ctx, c["export.h2d"]) for c in held)
    return sum(s.device_ms for c in held for s in c.values()) / frames if frames else None


def idle_ms_per_frame(ctx, name: str) -> Optional[float]:
    """Device idle ms a frame of the slice (every gap) inside the spans named
    ``name``, less what spans nested in them hold, of the thread that opened
    them."""
    gaps, sl = getattr(ctx.slice, "gaps", None), ctx.slice
    held = profiled(ctx)
    mine = [s for s in held if s.name == name]
    if gaps is None or not len(gaps) or not mine or not sl.frames:
        return None
    thread = mine[0].thread
    split = idle_split(gaps, [s for s in held if s.thread == thread])
    return 1e3 * split.get(name, 0.0) / sl.frames
