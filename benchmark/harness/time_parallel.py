"""The time-parallel phase path's stage spans, and the least bytes of its scan.

``models/riesz.py::process_clip_parallel`` opens device spans of the
program's recorder inside a chunk's ``export.step``, each taking the chunk's
cursor as its id: ``phase_tp.build`` once, ``phase_tp.difference``,
``phase_tp.scan`` and ``phase_tp.amplify`` once a band level, and
``phase_tp.collapse`` once. Their CUDA events time the stream over each
region. A reader sums a stage's device ms over a chunk, divides by the
chunk's frames (``spans._chunk_frames``: its ``export.h2d`` bytes over a
frame's) and takes the median over the window's chunks outside the profiled
one. A chunk counts where every span of the stage has its events read. A
program without these spans (the sequential path, an older checkout) reads
nothing, and each reader returns None.

The scan's count is the least traffic of the phase accumulation and both
DF-II filters over a chunk of T frames, whatever implements them: for each
band level of h x w and each component (cos, sin) the phase difference
[T, h, w] read once, y_lo and y_hi written once, and the five carried
planes (acc, r0lo, r1lo, r0hi, r1hi) read once and written once, f32:
(3T + 10) * h * w * 4 bytes. Its operations (a few a element) never bind.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.harness import spans
from benchmark.harness.roofline import F32, PEAK_BYTES_PER_S, level_sizes

STAGES = ("build", "difference", "scan", "amplify", "collapse")
PREFIX = "phase_tp."


def scan_bytes(h: int, w: int, levels: int, t: int) -> int:
    """Least bytes of one chunk's scans: T frames at h x w, ``levels`` levels
    (every level but the residual octave is a band level)."""
    return sum(2 * (3 * t + 10) * lh * lw * F32 for lh, lw in level_sizes(h, w, levels)[:-1])


def scan_seconds(h: int, w: int, levels: int, t: int) -> float:
    return scan_bytes(h, w, levels, t) / PEAK_BYTES_PER_S


def chunks(ctx, stage: str) -> List[Tuple[float, float]]:
    """(frames, device ms of the stage's spans summed) of each unprofiled
    chunk that has the stage's spans, all read, and its ``export.h2d``."""
    name = PREFIX + stage
    held = spans.unprofiled(ctx)
    frames = {s.id: spans._chunk_frames(ctx, s) for s in held if s.name == "export.h2d"}
    by_chunk: Dict[object, list] = defaultdict(list)
    for s in held:
        if s.name == name:
            by_chunk[s.id].append(s.device_ms)
    return [(frames[c], sum(ms)) for c, ms in by_chunk.items()
            if c in frames and None not in ms]


def stage_device_ms(ctx, stage: str) -> Optional[float]:
    """Median over chunks of the stage's device ms a frame."""
    per_frame = [ms / n for n, ms in chunks(ctx, stage)]
    return statistics.median(per_frame) if per_frame else None


def scan_roofline(ctx) -> Optional[float]:
    """Median over chunks of the scan's least time (its bytes over the
    memory peak) over its measured device time, in percent."""
    c = ctx.config
    shares = [100.0 * scan_seconds(c["height"], c["width"], c["levels"], round(n)) / (ms * 1e-3)
              for n, ms in chunks(ctx, "scan") if ms > 0]
    return statistics.median(shares) if shares else None
