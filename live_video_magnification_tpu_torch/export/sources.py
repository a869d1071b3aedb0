"""Ordered finite raw-frame sequences for export (reference export/IExportFrameSource.hpp).

Single-threaded pull model: open -> next()* -> close.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Tuple

import numpy as np


class IExportFrameSource(abc.ABC):
    @abc.abstractmethod
    def open(self) -> bool: ...

    @abc.abstractmethod
    def frame_count(self) -> Optional[int]:
        """None when unknown (indeterminate progress)."""

    @abc.abstractmethod
    def size(self) -> Tuple[int, int]: ...

    @abc.abstractmethod
    def next(self) -> Optional[np.ndarray]:
        """Next frame (HWC u8) or None at the end."""

    @abc.abstractmethod
    def close(self) -> None: ...


class FileExportFrameSource(IExportFrameSource):
    """Own re-decode of a [start, end) range, no pacing
    (reference export/FileExportFrameSource.cpp:11-55)."""

    def __init__(self, path: str, start_frame: int = 0, end_frame: Optional[int] = None):
        self._path = path
        self._start = max(0, start_frame)
        self._end = end_frame
        self._cap = None
        self._pos = 0
        self._size = (0, 0)
        self._total: Optional[int] = None

    def open(self) -> bool:
        import cv2

        self._cap = cv2.VideoCapture(self._path)
        if not self._cap.isOpened():
            return False
        total = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
        self._size = (h, w)
        if self._start:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, self._start)
        self._pos = self._start
        if total > 0:
            end = min(self._end, total) if self._end is not None else total
            self._total = max(0, end - self._start)
        return True

    def frame_count(self) -> Optional[int]:
        return self._total

    def size(self) -> Tuple[int, int]:
        return self._size

    def next(self) -> Optional[np.ndarray]:
        if self._end is not None and self._pos >= self._end:
            return None
        ok, img = self._cap.read()
        if not ok:
            return None
        self._pos += 1
        return img

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class BufferExportFrameSource(IExportFrameSource):
    """Replays an in-RAM list of camera frames; frees each frame as it advances
    so a multi-GB capture drains during encode
    (reference export/BufferExportFrameSource.cpp:8-33)."""

    def __init__(self, frames: List[np.ndarray]):
        self._frames = list(frames)
        self._idx = 0

    def open(self) -> bool:
        return True

    def frame_count(self) -> Optional[int]:
        return len(self._frames) if self._idx == 0 else None

    def size(self) -> Tuple[int, int]:
        if not self._frames:
            return (0, 0)
        f = self._frames[0]
        return (f.shape[0], f.shape[1])

    def next(self) -> Optional[np.ndarray]:
        if self._idx >= len(self._frames):
            return None
        f = self._frames[self._idx]
        self._frames[self._idx] = None  # free as we go
        self._idx += 1
        return f

    def close(self) -> None:
        self._frames = []
