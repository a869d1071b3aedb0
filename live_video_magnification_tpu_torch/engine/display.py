"""Display renderer: the pull-based, latest-wins consumer (invariant 2).

Re-design of the reference DisplayWidget's data path (ui/DisplayWidget.cpp):
a ~120 Hz timer polls the mailbox, renders only new frames (seq check), and
accounts skipped frames from sequence gaps (:232-236). Four view modes mirror
the reference's display-mode combo. Rendering backend is optional: an OpenCV
HighGUI window when a display is available, else headless (stats only) — the
GL widget itself is GUI chrome, not framework.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Optional

import numpy as np

from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.mailbox import LatestFrameMailbox


class ViewMode(enum.Enum):
    PROCESSED = "processed"
    ORIGINAL = "original"      # doubles as magnification-off preview
    SIDE_BY_SIDE = "side-by-side"
    TOP_BOTTOM = "top-bottom"


def compose_view(processed: np.ndarray, original: np.ndarray, mode: ViewMode) -> np.ndarray:
    def bgr(x):
        return np.repeat(x[..., None], 3, axis=-1) if x.ndim == 2 else x

    if mode is ViewMode.PROCESSED:
        return bgr(processed)
    if mode is ViewMode.ORIGINAL:
        return bgr(original)
    p, o = bgr(processed), bgr(original)
    h = min(p.shape[0], o.shape[0])
    w = min(p.shape[1], o.shape[1])
    if mode is ViewMode.SIDE_BY_SIDE:
        return np.concatenate([o[:h, :w], p[:h, :w]], axis=1)
    return np.concatenate([o[:h, :w], p[:h, :w]], axis=0)


class DisplayLoop:
    """Polls the mailbox at a fixed rate; hands new frames to a render callback."""

    def __init__(
        self,
        mailbox: LatestFrameMailbox,
        instr: Instrumentation,
        render: Optional[Callable[[np.ndarray], None]] = None,
        poll_hz: float = 120.0,
        view_mode: ViewMode = ViewMode.PROCESSED,
    ):
        self._mailbox = mailbox
        self._instr = instr
        self._render = render
        self._interval = 1.0 / poll_hz
        self.view_mode = view_mode
        self._last_seq: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> Optional[np.ndarray]:
        """One poll: returns the composed view if a NEW frame arrived."""
        pair = self._mailbox.latest()
        if pair is None:
            return None
        seq = pair.processed.seq
        if self._last_seq is not None and seq <= self._last_seq:
            return None
        skipped = 0 if self._last_seq is None else max(0, seq - self._last_seq - 1)
        self._last_seq = seq
        self._instr.on_displayed(skipped=skipped)
        return compose_view(pair.processed.data, pair.original.data, self.view_mode)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="DisplayLoop")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            view = self.poll_once()
            if view is not None and self._render is not None:
                self._render(view)


def make_cv2_renderer(window_name: str = "lvmt") -> Optional[Callable[[np.ndarray], None]]:
    """HighGUI window renderer, or None when no display is available."""
    import os

    if not os.environ.get("DISPLAY") and not os.environ.get("WAYLAND_DISPLAY"):
        return None
    import cv2

    cv2.namedWindow(window_name, cv2.WINDOW_NORMAL)

    def render(img: np.ndarray) -> None:
        cv2.imshow(window_name, img)
        cv2.waitKey(1)

    return render
