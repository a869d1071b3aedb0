"""Fixed frame pool with blocking acquire (reference core/FramePool.hpp:17-48).

Bounds in-flight frames (credit-based backpressure, invariant 6): acquire()
blocks when all buffers are out, which stalls a file source when the pipeline
falls behind — the lossless path. Buffers are preallocated numpy arrays reused
across frames, so steady-state transport does no per-frame allocation.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from live_video_magnification_tpu_torch.engine.frame import Frame, PixelFormat


class FramePool:
    def __init__(self, capacity: int = 12):
        self._capacity = max(1, capacity)
        self._mutex = threading.Lock()
        self._available = threading.Condition(self._mutex)
        self._free: List[np.ndarray] = []
        self._shape: Optional[Tuple[int, ...]] = None
        self._outstanding = 0
        self._stopped = False

    def acquire(self, h: int, w: int, channels: int) -> Optional[Frame]:
        """Blocks while the pool is exhausted; returns None when stopped."""
        shape = (h, w, channels) if channels > 1 else (h, w)
        with self._mutex:
            if self._shape != shape:
                self._free = []
                self._shape = shape
            while (
                not self._free
                and self._outstanding >= self._capacity
                and not self._stopped
            ):
                self._available.wait()
            if self._stopped:
                return None
            buf = self._free.pop() if self._free else np.empty(shape, np.uint8)
            self._outstanding += 1

        frame = Frame(data=buf, width=w, height=h,
                      format=PixelFormat.BGR8 if channels >= 3 else PixelFormat.GRAY8)
        frame._release = lambda b=buf: self._return(b, shape)
        return frame

    def _return(self, buf: np.ndarray, shape) -> None:
        with self._mutex:
            self._outstanding -= 1
            if self._shape == shape and len(self._free) < self._capacity:
                self._free.append(buf)
            self._available.notify()

    def stop(self) -> None:
        """Unblock producers stuck in acquire (teardown ordering)."""
        with self._mutex:
            self._stopped = True
            self._available.notify_all()

    def reset(self) -> None:
        with self._mutex:
            self._stopped = False
            self._outstanding = 0
            self._free = []
