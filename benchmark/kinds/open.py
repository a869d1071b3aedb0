"""``"kind": "open"``: a camera.

Frame i is due at t0 + i / ``rate_fps`` on an absolute schedule that never
re-anchors; at its due time a thread takes a buffer from the program's pool,
copies the frame in, stamps the due time as its capture time and pushes it
into the program's queue (``policy`` "drop": a full queue evicts its oldest
frame; a pool with no free buffer is a drop too). ``warmup_frames`` go
through one by one in set-up. Frames due within ``--seconds`` make the
window; after the last is due, the run waits for the consumer to finish what
it holds. ``live_fps`` is the frames published over the window's length,
``latency_p95_ms`` the 95th percentile of due-to-publish times.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import program
from benchmark.harness.traffic import SAMPLES, Run, Stamp, Window, pick

LAYOUT = "thwc"


class _Camera(threading.Thread):
    """The open-loop source: frame i at t0 + i / rate, whatever the program does."""

    def __init__(self, engine: program.Engine, clip, first_seq, t0, rate, count, capacity):
        super().__init__(name="benchmark-camera", daemon=True)
        self.e, self.clip, self.first_seq = engine, clip, first_seq
        self.t0, self.rate, self.count, self.capacity = t0, rate, count, capacity
        self.due: Dict[int, float] = {}
        self.late: List[float] = []
        self.pool_drops = 0
        self._out = 0
        self._lock = threading.Lock()

    def _released(self, release):
        def done():
            with self._lock:
                self._out -= 1
            release()
        return done

    def run(self):
        n = self.clip.shape[0]
        h, w, c = self.clip.shape[1:]
        for i in range(self.count):
            due = self.t0 + i / self.rate
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self.late.append(max(0.0, time.monotonic() - due))
            seq = self.first_seq + i
            self.due[seq] = due
            with self._lock:
                full = self._out >= self.capacity
                if not full:
                    self._out += 1
            if full:
                self.pool_drops += 1
                continue
            frame = self.e.pool.acquire(h, w, c)
            if frame is None:  # stopped
                return
            with program.span("source.copy"):
                np.copyto(frame.data, self.clip[seq % n])
            frame.seq, frame.capture_ts = seq, due
            frame.pts_us = int(round(1e6 * i / self.rate))
            frame._release = self._released(frame._release)
            self.e.instr.on_captured()
            self.e.queue.push(frame)


def _wait(pred, timeout: float) -> bool:
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            return False
        time.sleep(0.002)
    return True


def _growth(lat: np.ndarray) -> float:
    """Mean latency of the last quarter of frames over that of the first."""
    q = len(lat) // 4
    return float(lat[-q:].mean() / lat[:q].mean()) if q else 1.0


def run(r: Run) -> Window:
    clip, device, tracer, seconds, traffic = r.clip, r.device, r.tracer, r.seconds, r.traffic
    n = clip.shape[0]
    rate = float(traffic["rate_fps"])
    count = int(seconds * rate)
    warm = int(traffic["warmup_frames"])
    expected = warm + count
    rng = np.random.default_rng(r.seed)
    keep = pick(rng, expected, SAMPLES) | {expected - 1}
    e = program.Engine(r.cfg, traffic, device, lambda pos: pos in keep)
    try:
        h, w, c = clip.shape[1:]

        def one(seq):
            frame = e.pool.acquire(h, w, c)
            np.copyto(frame.data, clip[seq % n])
            frame.seq, frame.capture_ts = seq, time.monotonic()
            e.queue.push(frame)
            if not _wait(lambda: e.mailbox.count() > seq, 120.0):
                raise RuntimeError(f"warm-up frame {seq} was not published within 120 s")

        for seq in range(warm - 1):  # set-up: every shape of the step, one frame at a time
            one(seq)
        tracer.warm_up(lambda: one(warm - 1))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.monotonic() + 0.05
        cam = _Camera(e, clip, warm, t0, rate, count, int(traffic["pool"]))
        cam.start()
        if tracer.enabled:  # slices from a third of the way in, until one holds the card's work
            time.sleep(max(0.0, t0 + seconds / 3.0 - time.monotonic()))
            slice_s = min(float(traffic["trace_seconds"]), seconds / 4.0)
            while True:
                with e.queue.parked():
                    tracer.start()
                time.sleep(slice_s)
                with e.queue.parked():
                    tracer.stop()
                if tracer.reduce().busy_s > 0 or time.monotonic() + slice_s > t0 + seconds:
                    break
                tracer.retries += 1
        cam.join()
        # after the last due frame: wait for the consumer to finish what it holds
        settled = lambda: e.mailbox.count() + e.queue.drops + cam.pool_drops >= expected
        drained = _wait(settled, 60.0)
        tail = time.monotonic() - (t0 + (count - 1) / rate)
    finally:
        e.stop()
    mb, q = e.mailbox, e.queue
    window_seqs = [s for s in mb.order if s >= warm]
    stamps = [Stamp(s, cam.due[s], q.popped[s], mb.published[s]) for s in window_seqs]
    lat = np.array([st.pub - st.due for st in stamps]) * 1e3
    e2e = {"live_fps": len(stamps) / seconds}
    if len(lat):
        e2e["latency_p95_ms"] = float(np.percentile(lat, 95))
    latest = mb.latest()
    if latest is not None:  # the last frame published: the longest carried state
        mb.kept[len(mb.order) - 1] = latest
    samples = {pos: (f.processed.data, f.original.data) for pos, f in mb.kept.items()}
    median_ms = lambda v: float(np.median(v) * 1e3) if len(v) else 0.0
    notes = {"queue_drops": q.drops, "pool_drops": cam.pool_drops,
             "generator_late_p99_ms": float(np.percentile(cam.late, 99) * 1e3) if cam.late else 0.0,
             "drain_s": tail, "drained": float(drained), "proc_errors": e.instr.proc_errors,
             "consumer_ms_median": median_ms([s.pub - s.pop for s in stamps]),
             "latency_growth": _growth(lat)}
    del e
    return Window(seconds, count, len(stamps), e2e, [s % n for s in mb.order], samples, "hwc",
                  list(mb.passthrough), stamps, notes, setup_end=t0)
