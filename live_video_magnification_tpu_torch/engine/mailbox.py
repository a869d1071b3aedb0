"""Latest-wins display mailbox (reference core/LatestFrameMailbox.hpp:12-33).

The ONLY lossy hop after capture policy: the renderer pulls the newest
{processed, original} pair; a skipped pair never feeds temporal state
(invariant 2). The pair is published as one object so split views stay
frame-synced.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from live_video_magnification_tpu_torch.engine.frame import Frame


@dataclasses.dataclass(frozen=True)
class DisplayFrame:
    processed: Frame
    original: Frame


class LatestFrameMailbox:
    def __init__(self):
        self._lock = threading.Lock()
        self._latest: Optional[DisplayFrame] = None

    def publish(self, frame: DisplayFrame) -> None:
        with self._lock:
            self._latest = frame

    def latest(self) -> Optional[DisplayFrame]:
        with self._lock:
            return self._latest

    def clear(self) -> None:
        with self._lock:
            self._latest = None
