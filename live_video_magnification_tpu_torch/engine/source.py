"""Frame sources (reference src/source/): threaded producers feeding the queue.

  * SourceBase — thread lifecycle + pause/stop plumbing + fixed-cadence pacing
    that drops the deficit when behind instead of bursting
    (reference SourceBase.cpp:83-110), sleeping in <=20 ms slices so stop() is
    observed promptly.
  * FileSource — cv2.VideoCapture decode loop with pending-seek exchange,
    in/out trim bounds, loop-to-in or park-at-end, synthesized CFR pts
    (reference FileSource.cpp).
  * CameraSource — free-running grab loop (never paced), transient-read retry,
    wedged-grab timeout, and the lossless record-mode bypass that clones into a
    sink and previews raw (reference CameraSource.cpp:26-80).
  * SyntheticSource — procedural frames for tests/benches (no video file
    needed, and no cv2: its brightness pulse is a numpy table lookup,
    cached per distinct table so that a frame is one strided copy).
  * enumerate_cameras — Linux /dev/video* capture-node scan
    (reference CameraEnumerator_Linux.cpp:18-54).
"""

from __future__ import annotations

import abc
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from live_video_magnification_tpu_torch.engine.frame import Frame, PixelFormat, now
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.pool import FramePool
from live_video_magnification_tpu_torch.engine.queue import BoundedQueue


class IFrameSink(abc.ABC):
    """Sink a source clones grabbed frames into (lossless camera record);
    keeps the source layer free of export deps (reference core/IFrameSink.hpp)."""

    @abc.abstractmethod
    def append(self, data: np.ndarray, pts_us: int) -> bool:
        """Returns False when the sink is closed/full (producer should stop feeding)."""


class ISource(abc.ABC):
    """Producer contract (reference source/ISource.hpp:18-70)."""

    def __init__(self):
        self.loop = False

    # lifecycle
    @abc.abstractmethod
    def open(self) -> bool: ...
    @abc.abstractmethod
    def start(self) -> None: ...   # starts paused
    @abc.abstractmethod
    def play(self) -> None: ...
    @abc.abstractmethod
    def pause(self) -> None: ...
    @abc.abstractmethod
    def stop(self) -> None: ...

    # capability / info
    def reported_fps(self) -> float:
        return 30.0

    def native_channels(self) -> int:
        return 3

    def native_size(self) -> Tuple[int, int]:
        return (0, 0)

    def set_playback_fps(self, fps: float) -> None:
        pass

    # frame-domain timeline (file sources)
    def seekable(self) -> bool:
        return False

    def frame_count(self) -> int:
        return 0

    def current_frame(self) -> int:
        return 0

    def seek_frame(self, frame: int) -> None:
        pass

    def set_in_out(self, in_frame: int, out_frame: int) -> None:
        pass

    def at_end(self) -> bool:
        return False

    def finished(self) -> bool:
        return False

    def is_playing(self) -> bool:
        return False

    # camera recording hooks
    def set_record_target(self, sink: Optional[IFrameSink]) -> None:
        pass


class SourceBase(ISource):
    """Thread lifecycle + pacing (reference SourceBase.{hpp,cpp})."""

    def __init__(self, pool: FramePool, queue: BoundedQueue, instr: Instrumentation):
        super().__init__()
        self._pool = pool
        self._queue = queue
        self._instr = instr
        self._thread: Optional[threading.Thread] = None
        self._mutex = threading.Lock()
        self._cv = threading.Condition(self._mutex)
        self._paused = True
        self._stopping = False
        self._finished = False
        self._playback_fps = 0.0
        self._next_deadline: Optional[float] = None
        self._seq = 0
        # Record plumbing (camera-kind sources). _record_lock is held around
        # every sink.append, so set_record_target(None) returning guarantees
        # no in-flight append — the acknowledged quiesce handshake of the
        # reference's ordered close -> quiesce -> detach
        # (PlaybackController.cpp:244-263).
        self._record_sink: Optional[IFrameSink] = None
        self._record_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------------------------------

    def start(self) -> None:
        with self._mutex:
            self._stopping = False
            self._paused = True
            self._finished = False
        self._thread = threading.Thread(target=self._run_wrapper, daemon=True,
                                        name=type(self).__name__)
        self._thread.start()

    def play(self) -> None:
        with self._mutex:
            self._paused = False
            self._next_deadline = None  # re-anchor pacing
            self._cv.notify_all()

    def pause(self) -> None:
        with self._mutex:
            self._paused = True
            self._next_deadline = None

    def stop(self) -> None:
        with self._mutex:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)
            self._thread = None

    def finished(self) -> bool:
        with self._mutex:
            return self._finished

    def is_playing(self) -> bool:
        with self._mutex:
            return not self._paused and not self._finished and not self._stopping

    def set_playback_fps(self, fps: float) -> None:
        with self._mutex:
            self._playback_fps = fps
            self._next_deadline = None

    # -- worker plumbing ------------------------------------------------------------------------

    def _run_wrapper(self) -> None:
        try:
            self._run()
        except Exception:
            self._instr.on_read_error()
        with self._mutex:
            self._finished = True

    @abc.abstractmethod
    def _run(self) -> None: ...

    def _should_stop(self) -> bool:
        with self._mutex:
            return self._stopping

    def _wait_while_paused(self, extra_wake: Callable[[], bool] = lambda: False) -> bool:
        """Returns False when stopping. extra_wake lets seeks interrupt a pause."""
        with self._mutex:
            while self._paused and not self._stopping and not extra_wake():
                self._cv.wait(timeout=0.05)
            return not self._stopping

    def _wake(self) -> None:
        with self._mutex:
            self._cv.notify_all()

    def _pace_frame(self) -> None:
        """Fixed-cadence scheduler: if behind, drop the deficit and re-anchor
        (never bursts); sleep in <=20 ms slices so stop() is observed
        (reference SourceBase.cpp:83-110). _next_deadline is read/written under
        the mutex (play/pause/set_playback_fps reset it cross-thread)."""
        with self._mutex:
            fps = self._playback_fps
            if fps <= 0:
                return
            interval = 1.0 / fps
            t = time.monotonic()
            if self._next_deadline is None or t > self._next_deadline + interval:
                self._next_deadline = t + interval
                return
            deadline = self._next_deadline
        while True:
            t = time.monotonic()
            remaining = deadline - t
            if remaining <= 0 or self._should_stop():
                break
            time.sleep(min(remaining, 0.02))
        with self._mutex:
            if self._next_deadline is not None:
                self._next_deadline += interval

    def _emit(self, frame: Frame) -> bool:
        self._instr.on_captured()
        return self._queue.push(frame)

    # -- record bypass (camera-kind sources) ------------------------------------------------------

    def set_record_target(self, sink: Optional[IFrameSink]) -> None:
        """Attach/detach the lossless record sink. Detaching (None) blocks until
        any in-flight append has completed — the acknowledged handshake
        replacing the reference's quiesce wait (PlaybackController.cpp:244-263)."""
        with self._record_lock:
            with self._mutex:
                self._record_sink = sink

    def _record_bypass(self, img: np.ndarray, pts_us: int, capture_ts, mailbox) -> bool:
        """If recording: clone into the sink, publish a raw preview, and skip
        the processing queue (reference CameraSource.cpp:70-80). Returns True
        when the frame was consumed by the record path."""
        with self._mutex:
            recording = self._record_sink is not None
        if not recording:
            return False
        with self._record_lock:
            sink = self._record_sink
            if sink is None:  # detached between the check and the lock
                return False
            sink.append(img.copy(), pts_us)
        if getattr(self, "_mailbox", None) is not None:
            from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame

            preview = Frame(
                seq=self._seq, pts_us=pts_us, capture_ts=capture_ts,
                width=img.shape[1], height=img.shape[0],
                format=PixelFormat.BGR8 if img.ndim == 3 else PixelFormat.GRAY8,
                data=img,
            )
            self._seq += 1
            mailbox.publish(DisplayFrame(preview, preview))
        return True

    def _acquire(self, h: int, w: int, channels: int) -> Optional[Frame]:
        frame = self._pool.acquire(h, w, channels)
        if frame is not None:
            frame.seq = self._seq
            self._seq += 1
        return frame


class FileSource(SourceBase):
    """Paced decode of a video file (reference FileSource.{hpp,cpp}).

    Seeks use frame-index positioning (keyframe-approximate, like the
    reference's CAP_PROP_POS_FRAMES); pts is synthesized at a fixed cadence
    (CFR assumption, FileSource.hpp:13-14).
    """

    def __init__(self, path: str, pool: FramePool, queue: BoundedQueue,
                 instr: Instrumentation, mailbox=None):
        super().__init__(pool, queue, instr)
        self._path = path
        self._cap = None
        self._fps = 30.0
        self._frames = 0
        self._pos = 0
        self._channels = 3
        self._size = (0, 0)
        self._pending_seek: Optional[int] = None
        self._in_frame = 0
        self._out_frame: Optional[int] = None
        self._at_end = False
        self._mailbox = mailbox

    def open(self) -> bool:
        import cv2

        self._cap = cv2.VideoCapture(self._path)
        if not self._cap.isOpened():
            return False
        fps = self._cap.get(cv2.CAP_PROP_FPS)
        self._fps = fps if fps and fps > 0 else 30.0
        self._frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        ok, probe = self._cap.read()
        if not ok:
            return False
        self._channels = 1 if probe.ndim == 2 else probe.shape[2]
        self._size = (probe.shape[0], probe.shape[1])
        self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        self._pos = 0
        self._playback_fps = self._fps
        return True

    def reported_fps(self) -> float:
        return self._fps

    def native_channels(self) -> int:
        return self._channels

    def native_size(self) -> Tuple[int, int]:
        return self._size

    def seekable(self) -> bool:
        return self._frames > 0

    def frame_count(self) -> int:
        return self._frames

    def current_frame(self) -> int:
        return self._pos

    def seek_frame(self, frame: int) -> None:
        with self._mutex:
            self._pending_seek = frame
            self._at_end = False
            self._cv.notify_all()

    def set_in_out(self, in_frame: int, out_frame: int) -> None:
        with self._mutex:
            self._in_frame = max(0, in_frame)
            self._out_frame = out_frame if out_frame > 0 else None
            self._at_end = False

    def at_end(self) -> bool:
        with self._mutex:
            return self._at_end

    def _take_pending_seek(self) -> Optional[int]:
        with self._mutex:
            seek, self._pending_seek = self._pending_seek, None
            return seek

    def _run(self) -> None:
        import cv2

        while not self._should_stop():
            if not self._wait_while_paused(lambda: self._pending_seek is not None):
                return

            scrubbing = False
            seek = self._take_pending_seek()
            if seek is not None:
                seek = min(max(seek, 0), max(self._frames - 1, 0))
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, seek)
                self._pos = seek
                scrubbing = self._is_paused()

            with self._mutex:
                in_f, out_f = self._in_frame, self._out_frame
            end_bound = out_f if out_f is not None else (self._frames or None)
            if end_bound is not None and self._pos >= end_bound and not scrubbing:
                if self.loop:
                    self._cap.set(cv2.CAP_PROP_POS_FRAMES, in_f)
                    self._pos = in_f
                else:
                    with self._mutex:
                        self._at_end = True
                        self._paused = True
                    continue
            if self._pos < in_f and not scrubbing:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, in_f)
                self._pos = in_f

            ok, img = self._cap.read()
            if not ok:
                if self.loop and self._frames:
                    self._cap.set(cv2.CAP_PROP_POS_FRAMES, in_f)
                    self._pos = in_f
                    continue
                with self._mutex:
                    self._at_end = True
                    self._paused = True
                continue

            frame = self._acquire(img.shape[0], img.shape[1],
                                  1 if img.ndim == 2 else img.shape[2])
            if frame is None:
                return
            np.copyto(frame.data, img)
            frame.pts_us = int(self._pos * 1_000_000 / self._fps)
            frame.capture_ts = now()
            self._pos += 1

            # Stale-scrub frame: superseded by a newer pending seek -> drop it.
            if scrubbing and self._pending_seek is not None:
                frame.release()
                continue
            if not scrubbing:
                self._pace_frame()
            if not self._emit(frame):
                return

    def _is_paused(self) -> bool:
        with self._mutex:
            return self._paused


class CameraSource(SourceBase):
    """Free-running camera grab loop (reference CameraSource.{hpp,cpp}):
    never paced (pacing would grow latency), transient failures retried,
    record mode bypasses the queue (clone into sink + raw preview)."""

    READ_TIMEOUT_S = 5.0

    def __init__(self, index: int, pool: FramePool, queue: BoundedQueue,
                 instr: Instrumentation, mailbox=None, api_preference=None):
        super().__init__(pool, queue, instr)
        self._index = index
        self._cap = None
        self._fps = 30.0
        self._channels = 3
        self._size = (0, 0)
        self._mailbox = mailbox
        self._api = api_preference

    def open(self) -> bool:
        import cv2

        apis = [self._api] if self._api is not None else [cv2.CAP_V4L2, cv2.CAP_ANY]
        for api in apis:
            self._cap = cv2.VideoCapture(self._index, api)
            if self._cap.isOpened():
                break
        if self._cap is None or not self._cap.isOpened():
            return False
        fps = self._cap.get(cv2.CAP_PROP_FPS)
        self._fps = fps if fps and fps > 0 else 30.0
        ok, probe = self._cap.read()
        if not ok:
            return False
        self._channels = 1 if probe.ndim == 2 else probe.shape[2]
        self._size = (probe.shape[0], probe.shape[1])
        return True

    def reported_fps(self) -> float:
        return self._fps

    def native_channels(self) -> int:
        return self._channels

    def native_size(self) -> Tuple[int, int]:
        return self._size

    def _run(self) -> None:
        last_good = time.monotonic()
        while not self._should_stop():
            if not self._wait_while_paused():
                return
            ok, img = self._cap.read()
            t = time.monotonic()
            if not ok:
                self._instr.on_read_error()
                if t - last_good > self.READ_TIMEOUT_S:
                    return  # wedged grab: give up; controller rebuilds on next Play
                time.sleep(0.01)
                continue
            last_good = t

            if self._record_bypass(img, int(t * 1e6), now(), self._mailbox):
                continue

            frame = self._acquire(img.shape[0], img.shape[1],
                                  1 if img.ndim == 2 else img.shape[2])
            if frame is None:
                return
            np.copyto(frame.data, img)
            frame.pts_us = int(t * 1e6)
            frame.capture_ts = now()
            if not self._emit(frame):
                return


class SyntheticSource(SourceBase):
    """Procedural test/bench source: translating texture + brightness pulse.

    Supports the camera record bypass (set_record_target) so the record ->
    RecordingBuffer -> export flow is testable without hardware.

    The frame of index i is the reference's ``cv2.LUT(tile_i, lut_i)`` bit
    for bit, computed without cv2: ``lut_i[base][dy:dy+h, dx:dx+w]``, where
    ``lut_i[base]`` (the whole texture through frame i's table) is kept per
    distinct table. The shift repeats every ``fps`` frames and the pulse every
    ``fps / 1.2``, so after the first pulse period a frame is a strided copy
    of a cached array (a numpy lookup of a whole 2160x3840x3 frame takes
    several times longer). The cache holds at most RENDER_CACHE_BYTES; past
    that a frame is looked up afresh, with the same bits. A gray source
    renders [H, W] (the reference's gives one column, [H]: cv2.LUT drops
    the trailing unit axis before its ``[..., 0]``)."""

    RENDER_CACHE_BYTES = 2 << 30

    def __init__(self, pool: FramePool, queue: BoundedQueue, instr: Instrumentation,
                 h: int = 480, w: int = 640, fps: float = 30.0, n_frames: int = 0,
                 channels: int = 3, seed: int = 0, mailbox=None):
        super().__init__(pool, queue, instr)
        self._mailbox = mailbox
        self._h, self._w, self._fps = h, w, fps
        self._n = n_frames  # 0 = endless
        self._channels = channels
        rng = np.random.default_rng(seed)
        base = rng.random((h + 16, w + 16, channels)).astype(np.float32)
        # u8 texture + per-frame 256-entry LUT for the brightness pulse
        self._base_u8 = np.clip(base * 255.0, 0, 255).astype(np.uint8)
        if channels == 1:
            self._base_u8 = self._base_u8[..., 0]
        self._looked_up: dict = {}  # table bytes -> read-only lut[base]
        self._i = 0
        self._playback_fps = fps
        self._at_end = False

    def open(self) -> bool:
        return True

    def reported_fps(self) -> float:
        return self._fps

    def native_channels(self) -> int:
        return self._channels

    def native_size(self) -> Tuple[int, int]:
        return (self._h, self._w)

    def seekable(self) -> bool:
        return self._n > 0

    def frame_count(self) -> int:
        return self._n

    def current_frame(self) -> int:
        return self._i

    def at_end(self) -> bool:
        with self._mutex:
            return self._at_end

    def _render(self, i: int) -> np.ndarray:
        """Frame i as a read-only [H, W, C] ([H, W] gray) u8 view."""
        dx = int(4 + 3 * np.sin(2 * np.pi * i / self._fps))
        dy = int(4 + 2 * np.cos(2 * np.pi * i / self._fps))
        pulse = 1.0 + 0.03 * np.sin(2 * np.pi * 1.2 * i / self._fps)
        lut = np.clip(np.arange(256.0) * pulse, 0, 255).astype(np.uint8)
        key = lut.tobytes()
        full = self._looked_up.get(key)
        if full is None:
            full = lut[self._base_u8]
            full.flags.writeable = False
            if (len(self._looked_up) + 1) * full.nbytes <= self.RENDER_CACHE_BYTES:
                self._looked_up[key] = full
        return full[dy : dy + self._h, dx : dx + self._w]

    def _run(self) -> None:
        while not self._should_stop():
            if not self._wait_while_paused():
                return
            if self._n and self._i >= self._n:
                with self._mutex:
                    self._paused = True
                    self._at_end = True
                continue
            img = self._render(self._i)
            pts = int(self._i * 1_000_000 / self._fps)
            if self._record_bypass(img, pts, now(), self._mailbox):
                self._i += 1
                self._pace_frame()
                continue
            frame = self._acquire(self._h, self._w, self._channels)
            if frame is None:
                return
            np.copyto(frame.data, img)
            frame.pts_us = pts
            frame.capture_ts = now()
            self._i += 1
            self._pace_frame()
            if not self._emit(frame):
                return


def enumerate_cameras() -> List[Tuple[int, str]]:
    """Scan /dev/video0..63 for V4L2 capture nodes (Linux). Returns (index, name).

    The index matches OpenCV's CAP_V4L2 ordinal by construction
    (reference CameraEnumerator_Linux.cpp:18-54). Non-Linux: probe a few
    indices with cv2.
    """
    cams: List[Tuple[int, str]] = []
    if os.path.isdir("/sys/class/video4linux"):
        for node in sorted(os.listdir("/sys/class/video4linux")):
            if not node.startswith("video"):
                continue
            idx = int(node[5:])
            name_path = f"/sys/class/video4linux/{node}/name"
            try:
                with open(name_path) as f:
                    name = f.read().strip()
            except OSError:
                name = node
            cams.append((idx, name))
    return cams
