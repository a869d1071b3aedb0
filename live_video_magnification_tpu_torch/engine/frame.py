"""Pooled video frame model (reference src/core/Frame.hpp:13-31).

A Frame is immutable after publish (invariant 6): producers fill a pooled
buffer, stamp metadata, and emit; consumers never mutate. `data` is an HWC
uint8 numpy array (BGR8 or Gray8), converted to planar device layout at the
chain boundary.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Optional

import numpy as np


class PixelFormat(enum.Enum):
    BGR8 = "bgr8"
    GRAY8 = "gray8"


def now() -> float:
    """Monotonic clock (reference core/Clock.hpp)."""
    return time.monotonic()


@dataclasses.dataclass
class Frame:
    seq: int = 0
    pts_us: int = 0              # presentation timestamp, microseconds
    capture_ts: float = 0.0      # monotonic capture instant
    width: int = 0
    height: int = 0
    format: PixelFormat = PixelFormat.BGR8
    data: Optional[np.ndarray] = None     # [H, W, C] uint8
    _release: Optional[Callable[[], None]] = None  # pool return hook

    @property
    def channels(self) -> int:
        if self.data is None:
            return 0
        return 1 if self.data.ndim == 2 else self.data.shape[2]

    def release(self) -> None:
        """Return the buffer to its pool (the shared_ptr-deleter analogue)."""
        cb, self._release = self._release, None
        if cb is not None:
            cb()
