"""Thread-safe camera recording buffer (reference export/RecordingBuffer.{hpp,cpp}).

Append-only clone buffer implementing the frame-sink contract; self-closes at a
byte cap (default 8 GB, reference MainWindow.cpp:49-51) so an unattended
recording auto-stops cleanly instead of OOM-ing.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from live_video_magnification_tpu_torch.engine.source import IFrameSink

DEFAULT_MAX_BYTES = 8 * 1024**3


class RecordingBuffer(IFrameSink):
    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 on_limit: Optional[Callable[[], None]] = None):
        self._lock = threading.Lock()
        self._frames: List[Tuple[np.ndarray, int]] = []
        self._bytes = 0
        self._max_bytes = max_bytes
        self._closed = False
        self._limit_reached = False
        self._on_limit = on_limit

    def append(self, data: np.ndarray, pts_us: int) -> bool:
        with self._lock:
            if self._closed:
                return False
            nbytes = data.nbytes
            if self._bytes + nbytes > self._max_bytes:
                self._closed = True
                self._limit_reached = True
                cb = self._on_limit
            else:
                self._frames.append((data, pts_us))
                self._bytes += nbytes
                cb = None
        if cb is not None:
            cb()
        return cb is None

    def close(self) -> None:
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def limit_reached(self) -> bool:
        with self._lock:
            return self._limit_reached

    @property
    def frame_count(self) -> int:
        with self._lock:
            return len(self._frames)

    @property
    def byte_count(self) -> int:
        with self._lock:
            return self._bytes

    def take_frames(self) -> List[np.ndarray]:
        """Move the frames out; call only after the producer has quiesced."""
        with self._lock:
            frames = [f for f, _ in self._frames]
            self._frames = []
            self._bytes = 0
            return frames
