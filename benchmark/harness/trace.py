"""The profiled slice of a traced run, reduced to numbers in memory.

``torch.profiler`` records the host and the card over a short steady slice of
the window (one chunk of an export; a few seconds of a camera). Nothing is
written to disk: the slice's events are reduced here to the device's busy
time (the union of every kernel, copy and memset interval), the slice's
length, device time and count by operation, copies by direction, and the
idle gaps between device intervals, each named by the innermost host event
running at its middle (the program's op, a runtime call, or one of the
benchmark's own spans such as ``engine.queue_pop``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

GAPS_NAMED = 400   # the longest gaps are named; the rest only counted
TOP = 10


@dataclasses.dataclass
class Slice:
    window_s: float
    busy_s: float
    frames: Optional[int]
    op_seconds: Dict[str, float]     # device time by operation name
    op_counts: Dict[str, int]
    kernel_count: int                # device kernels (no copy, no memset)
    copy_seconds: Dict[str, float]   # "HtoD" / "DtoH" / "DtoD"
    idle_by_host: Dict[str, float]   # idle seconds by what the host was doing


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def reduce_events(events, window_s: float, frames: Optional[int]) -> Slice:
    """``events``: (name, is_device, start_ns, end_ns) tuples."""
    dev = [(n, s, e) for n, d, s, e in events
           if d and e > s and not n.startswith("Activity Buffer")]
    host = [(n, s, e) for n, d, s, e in events if not d and e > s]
    op_s, op_n, copies = defaultdict(float), defaultdict(int), defaultdict(float)
    kernels = 0
    for n, s, e in dev:
        op_s[n] += (e - s) * 1e-9
        op_n[n] += 1
        if n.startswith("Memcpy"):
            copies[n.split()[1]] += (e - s) * 1e-9
        elif not _is_copy(n):
            kernels += 1
    busy, gaps = 0.0, []
    if dev:
        iv = np.array(sorted((s, e) for _, s, e in dev), dtype=np.int64)
        run_end = np.maximum.accumulate(iv[:, 1])
        starts_new = np.concatenate([[True], iv[1:, 0] > run_end[:-1]])
        seg_start = iv[starts_new, 0]
        seg_end = np.concatenate([run_end[np.flatnonzero(starts_new)[1:] - 1], [run_end[-1]]])
        busy = float((seg_end - seg_start).sum()) * 1e-9
        gaps = list(zip(seg_end[:-1], seg_start[1:]))
    idle = defaultdict(float)
    if gaps and host:
        hs = np.array([s for _, s, _ in host], dtype=np.int64)
        he = np.array([e for _, _, e in host], dtype=np.int64)
        names = [n for n, _, _ in host]
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
            mid = (a + b) // 2
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            label = names[inside[np.argmin(he[inside] - hs[inside])]] if len(inside) else "host: no op"
            idle[label] += (b - a) * 1e-9
    return Slice(window_s, busy, frames, dict(op_s), dict(op_n), kernels, dict(copies), dict(idle))


def breakdown(sl: Slice) -> dict:
    top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(sl.op_seconds), "idle_gaps": top(sl.idle_by_host)}


class Tracer:
    """Start and stop ``torch.profiler`` around one slice of a traced run, from
    the main thread; it records every thread (the live consumer launches from
    its own). ``reduce`` turns the events into a ``Slice`` afterwards,
    outside the window."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.slice: Optional[Slice] = None
        self.span: Tuple[float, float] = (0.0, 0.0)
        self._prof = None
        self._frames: Optional[int] = None
        self.retries = 0  # slices of a camera run that recorded no device work

    @property
    def done(self) -> bool:
        return self.span[1] > 0.0

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        return torch.profiler.profile(
            activities=acts,
            experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))

    def warm_up(self, work) -> None:
        """A throwaway profile around ``work``, in set-up: the first profile
        of a process holds up another thread's first launches under it for
        seconds (a camera's first slice read 13 s for 3), which a slice must
        not hold."""
        if self.enabled:
            prof = self._profile()
            prof.start()
            work()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.stop()
        else:
            work()

    def start(self) -> None:
        self.slice = None
        self._prof = self._profile()
        self._prof.start()
        self._t0 = time.monotonic()
        self.span = (self.span[0] or self._t0, 0.0)  # from the first slice's start

    def stop(self, frames: Optional[int] = None) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.monotonic()
        self._prof.stop()
        self._frames = frames
        self._window = t1 - self._t0
        self.span = (self.span[0], time.monotonic())  # the profiler's own stop included

    def reduce(self) -> Optional[Slice]:
        if self._prof is not None and self.slice is None:
            results = self._prof.profiler.kineto_results
            events = [(e.name(), e.device_type() != torch.autograd.DeviceType.CPU,
                       e.start_ns(), e.end_ns())
                      for e in (results.events() if results is not None else [])]
            self._prof = None
            self.slice = reduce_events(events, self._window, self._frames)
        return self.slice
