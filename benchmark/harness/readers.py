"""What the per-layer metric files read, from a traced run's context.

``ctx`` holds the window (per-frame stamps of a camera run: due, popped by
the consumer, published), the profiled slice (``trace.Slice``, or None off
the card) and the cell's configuration. Stamp-based numbers leave out the
frames due or in flight while the profiler ran (its stop included), so its
cost does not enter them.
Every reader returns None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional, Tuple

import numpy as np

from benchmark.harness import roofline


@dataclasses.dataclass
class Context:
    window: object          # traffic.Window
    slice: Optional[object]  # trace.Slice
    span: Tuple[float, float]
    config: dict


def _stamps(ctx) -> List:
    a, b = ctx.span
    return [s for s in ctx.window.stamps if s.pub < a or s.due > b]


def _median_ms(values) -> Optional[float]:
    return statistics.median(values) * 1e3 if values else None


def consumer_ms(ctx) -> Optional[float]:
    """Median time from the consumer's pop to its publish."""
    return _median_ms([s.pub - s.pop for s in _stamps(ctx)])


def queue_wait_ms(ctx) -> Optional[float]:
    """Median time from a frame's due time to the consumer's pop."""
    return _median_ms([s.pop - s.due for s in _stamps(ctx)])


def latency_p95_ms(ctx) -> Optional[float]:
    lat = [s.pub - s.due for s in _stamps(ctx)]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None


def _device(ctx):
    sl = ctx.slice
    return sl if sl is not None and sl.busy_s > 0 else None


def device_idle_pct(ctx) -> Optional[float]:
    sl = _device(ctx)
    return None if sl is None else 100.0 * (1.0 - sl.busy_s / sl.window_s)


def copy_ms(ctx) -> Optional[float]:
    """Device time of the host<->device copies, a frame."""
    sl = _device(ctx)
    if sl is None or not sl.frames:
        return None
    return 1e3 * (sl.copy_seconds.get("HtoD", 0.0) + sl.copy_seconds.get("DtoH", 0.0)) / sl.frames


def launches_per_frame(ctx) -> Optional[float]:
    sl = _device(ctx)
    return None if sl is None or not sl.frames else sl.kernel_count / sl.frames


def stencils_roofline(ctx) -> Optional[float]:
    sl, c = _device(ctx), ctx.config
    if sl is None or not sl.frames or c["mode"] != "phase":
        return None
    return roofline.stencil_share(sl.op_seconds, sl.op_counts, sl.frames,
                                  c["height"], c["width"], c["levels"])
