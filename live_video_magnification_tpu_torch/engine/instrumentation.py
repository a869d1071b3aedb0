"""Pipeline instrumentation (reference core/Instrumentation.hpp:19-83, .cpp:7-97).

Counters for captured/processed/displayed/skipped/drops/errors, a 64-bucket x
5 ms capture->processed latency histogram (mean + p95), and EMA fps estimates
computed at snapshot time. Polled by UIs/CLIs at a few Hz; the hot path only
bumps counters.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

_BUCKETS = 64
_BUCKET_MS = 5.0
_EMA_ALPHA = 0.25


@dataclasses.dataclass
class StatsSnapshot:
    captured: int = 0
    processed: int = 0
    displayed: int = 0
    display_skipped: int = 0
    source_drops: int = 0
    proc_errors: int = 0
    read_errors: int = 0
    queue_depth: int = 0
    capture_fps: float = 0.0
    process_fps: float = 0.0
    latency_ms_mean: float = 0.0
    latency_ms_p95: float = 0.0
    drop_fraction: float = 0.0


class Instrumentation:
    def __init__(self):
        self._lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self):
        self.captured = 0
        self.processed = 0
        self.displayed = 0
        self.display_skipped = 0
        self.read_errors = 0
        self.proc_errors = 0
        self._hist: List[int] = [0] * _BUCKETS
        self._lat_sum_ms = 0.0
        self._lat_count = 0
        self._last_time: Optional[float] = None
        self._last_captured = 0
        self._last_processed = 0
        self._fps_capture_ema = 0.0
        self._fps_process_ema = 0.0
        self._drop_frac_ema = 0.0
        self._last_drops = 0

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()

    def on_captured(self) -> None:
        with self._lock:
            self.captured += 1

    def on_processed(self) -> None:
        with self._lock:
            self.processed += 1

    def on_displayed(self, skipped: int = 0) -> None:
        with self._lock:
            self.displayed += 1
            self.display_skipped += skipped

    def on_read_error(self) -> None:
        with self._lock:
            self.read_errors += 1

    def on_proc_error(self) -> None:
        with self._lock:
            self.proc_errors += 1

    def record_latency(self, seconds: float) -> None:
        ms = seconds * 1e3
        bucket = min(_BUCKETS - 1, max(0, int(ms / _BUCKET_MS)))
        with self._lock:
            self._hist[bucket] += 1
            self._lat_sum_ms += ms
            self._lat_count += 1

    def snapshot(self, queue_depth: int = 0, source_drops: int = 0) -> StatsSnapshot:
        now = time.monotonic()
        with self._lock:
            snap = StatsSnapshot(
                captured=self.captured,
                processed=self.processed,
                displayed=self.displayed,
                display_skipped=self.display_skipped,
                source_drops=source_drops,
                proc_errors=self.proc_errors,
                read_errors=self.read_errors,
                queue_depth=queue_depth,
            )
            if self._last_time is not None:
                dt = now - self._last_time
                if dt > 1e-3:
                    cap_inst = (self.captured - self._last_captured) / dt
                    proc_inst = (self.processed - self._last_processed) / dt
                    self._fps_capture_ema += _EMA_ALPHA * (cap_inst - self._fps_capture_ema)
                    self._fps_process_ema += _EMA_ALPHA * (proc_inst - self._fps_process_ema)
                    d_drops = source_drops - self._last_drops
                    d_cap = self.captured - self._last_captured
                    if d_cap + d_drops > 0:
                        frac = d_drops / (d_cap + d_drops)
                        self._drop_frac_ema += _EMA_ALPHA * (frac - self._drop_frac_ema)
            self._last_time = now
            self._last_captured = self.captured
            self._last_processed = self.processed
            self._last_drops = source_drops
            snap.capture_fps = self._fps_capture_ema
            snap.process_fps = self._fps_process_ema
            snap.drop_fraction = self._drop_frac_ema

            if self._lat_count:
                snap.latency_ms_mean = self._lat_sum_ms / self._lat_count
                target = 0.95 * self._lat_count
                run = 0
                for i, c in enumerate(self._hist):
                    run += c
                    if run >= target:
                        snap.latency_ms_p95 = (i + 1) * _BUCKET_MS
                        break
            return snap


# Health thresholds (reference ui/StatusHealth.hpp:9-12): file path is judged by
# achieved/target fps; cameras by dropped-frame share.
FILE_FPS_OK = 0.95
FILE_FPS_WARN = 0.80
CAMERA_DROP_WARN = 0.02
CAMERA_DROP_BAD = 0.15


def file_health(process_fps: float, target_fps: float) -> str:
    if target_fps <= 0:
        return "ok"
    ratio = process_fps / target_fps
    if ratio >= FILE_FPS_OK:
        return "ok"
    if ratio >= FILE_FPS_WARN:
        return "warn"
    return "bad"


def camera_health(drop_fraction: float) -> str:
    if drop_fraction > CAMERA_DROP_BAD:
        return "bad"
    if drop_fraction > CAMERA_DROP_WARN:
        return "warn"
    return "ok"
