"""ctypes bindings for the native C++ host runtime (native/lvmt_core.cpp).

The port's own adapter to the transport the reference package uses: drop-in
counterparts of the Python transport primitives with the same semantics;
blocking calls release the GIL, so a native queue pop overlaps with device
dispatch and decode threads. Buffers live in a C-side arena and are exposed
to numpy zero-copy.

:func:`load` opens the checked-in ``native/liblvmt_core.so`` read-only. If
that library does not load (another platform, another C library), it
compiles ``native/lvmt_core.cpp`` with ``g++`` into ``build/lvmt_native/``
at the root of the checkout, keyed by a digest of the source, and loads that.
Nothing under ``native/`` is ever written.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_LIB_PATH = _REPO_ROOT / "native" / "liblvmt_core.so"
_SOURCE = _REPO_ROOT / "native" / "lvmt_core.cpp"
GXX_FLAGS = ("-O2", "-std=c++20", "-fPIC", "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()


class FrameMeta(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.c_int64),
        ("pts_us", ctypes.c_int64),
        ("capture_ts", ctypes.c_double),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("buffer_index", ctypes.c_int32),
    ]


def build_path() -> Path:
    """Where a library compiled from ``native/lvmt_core.cpp`` goes."""
    digest = hashlib.sha256(_SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return _REPO_ROOT / "build" / "lvmt_native" / f"liblvmt_core_{digest.hexdigest()[:16]}.so"


def _compile() -> Optional[Path]:
    """Compile the C++ source into build/lvmt_native/ (once); None on failure."""
    out = build_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


def _open(path: Path):
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


def load(build: bool = True):
    """Load the native library (the checked-in one, else one compiled from
    its source when ``build``); returns None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _open(_LIB_PATH) if _LIB_PATH.exists() else None
        if lib is None and build and _SOURCE.exists():
            built = _compile()
            lib = _open(built) if built is not None else None
        if lib is None:
            return None
        lib.lvmt_pool_create.restype = ctypes.c_void_p
        lib.lvmt_pool_create.argtypes = [ctypes.c_int, ctypes.c_longlong]
        lib.lvmt_pool_acquire.restype = ctypes.c_int
        lib.lvmt_pool_acquire.argtypes = [ctypes.c_void_p]
        lib.lvmt_pool_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lvmt_pool_buffer.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.lvmt_pool_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for name in ["lvmt_pool_stop", "lvmt_pool_reset", "lvmt_pool_destroy",
                     "lvmt_queue_stop", "lvmt_queue_reset", "lvmt_queue_destroy",
                     "lvmt_mailbox_destroy", "lvmt_mailbox_clear",
                     "lvmt_stats_destroy"]:
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.lvmt_queue_create.restype = ctypes.c_void_p
        lib.lvmt_queue_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.lvmt_queue_set_policy.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lvmt_queue_push.restype = ctypes.c_int
        lib.lvmt_queue_push.argtypes = [ctypes.c_void_p, ctypes.POINTER(FrameMeta)]
        lib.lvmt_queue_pop.restype = ctypes.c_int
        lib.lvmt_queue_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(FrameMeta),
                                       ctypes.c_double]
        lib.lvmt_queue_drops.restype = ctypes.c_longlong
        lib.lvmt_queue_drops.argtypes = [ctypes.c_void_p]
        lib.lvmt_queue_depth.restype = ctypes.c_int
        lib.lvmt_queue_depth.argtypes = [ctypes.c_void_p]
        lib.lvmt_mailbox_create.restype = ctypes.c_void_p
        lib.lvmt_mailbox_publish.argtypes = [ctypes.c_void_p, ctypes.POINTER(FrameMeta)]
        lib.lvmt_mailbox_latest.restype = ctypes.c_int
        lib.lvmt_mailbox_latest.argtypes = [ctypes.c_void_p, ctypes.POINTER(FrameMeta)]
        lib.lvmt_stats_create.restype = ctypes.c_void_p
        lib.lvmt_stats_bump.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lvmt_stats_latency.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.lvmt_stats_read.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_longlong),
                                        ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


class NativeFramePool:
    """Fixed arena of reusable u8 buffers; acquire blocks when exhausted."""

    def __init__(self, capacity: int, max_frame_bytes: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._ptr = self._lib.lvmt_pool_create(capacity, max_frame_bytes)
        self._max_bytes = max_frame_bytes
        # one full-slot view per arena index, built lazily ONCE: the arena
        # slots never move, so per-frame buffer() becomes a slice+reshape of
        # the cached base instead of a fresh ctypes as_array (measured 7.1 us
        # -> sub-us per call; this was the hot ctypes crossing, round 5)
        self._views: dict = {}

    def acquire(self) -> Optional[int]:
        idx = self._lib.lvmt_pool_acquire(self._ptr)
        return None if idx < 0 else idx

    def release(self, idx: int) -> None:
        self._lib.lvmt_pool_release(self._ptr, idx)

    def buffer(self, idx: int, shape: Tuple[int, ...]) -> np.ndarray:
        """Zero-copy numpy view of a pool buffer reshaped to `shape` (u8)."""
        n = int(np.prod(shape))
        assert n <= self._max_bytes
        base = self._views.get(idx)
        if base is None:
            ptr = self._lib.lvmt_pool_buffer(self._ptr, idx)
            base = np.ctypeslib.as_array(ptr, shape=(self._max_bytes,))
            self._views[idx] = base
        return base[:n].reshape(shape)

    def stop(self) -> None:
        self._lib.lvmt_pool_stop(self._ptr)

    def reset(self) -> None:
        self._lib.lvmt_pool_reset(self._ptr)

    def __del__(self):
        try:
            self._lib.lvmt_pool_destroy(self._ptr)
        except Exception:
            pass


class NativeQueue:
    """Bounded frame-slot queue with BLOCK/DROP overflow; dropped slots are
    recycled into the pool C-side."""

    def __init__(self, capacity: int, drop_policy: bool, pool: NativeFramePool):
        self._lib = load()
        self._pool = pool  # keep alive
        self._ptr = self._lib.lvmt_queue_create(capacity, int(drop_policy), pool._ptr)

    def set_policy(self, drop_policy: bool) -> None:
        self._lib.lvmt_queue_set_policy(self._ptr, int(drop_policy))

    def push(self, meta: FrameMeta) -> bool:
        return bool(self._lib.lvmt_queue_push(self._ptr, ctypes.byref(meta)))

    def pop(self, timeout_ms: float = -1.0) -> Optional[FrameMeta]:
        meta = FrameMeta()
        ok = self._lib.lvmt_queue_pop(self._ptr, ctypes.byref(meta), timeout_ms)
        return meta if ok else None

    def stop(self) -> None:
        self._lib.lvmt_queue_stop(self._ptr)

    def reset(self) -> None:
        self._lib.lvmt_queue_reset(self._ptr)

    @property
    def drops(self) -> int:
        return int(self._lib.lvmt_queue_drops(self._ptr))

    def depth(self) -> int:
        return int(self._lib.lvmt_queue_depth(self._ptr))

    def __del__(self):
        try:
            self._lib.lvmt_queue_destroy(self._ptr)
        except Exception:
            pass


class NativeMailbox:
    def __init__(self):
        self._lib = load()
        self._ptr = self._lib.lvmt_mailbox_create()

    def publish(self, meta: FrameMeta) -> None:
        self._lib.lvmt_mailbox_publish(self._ptr, ctypes.byref(meta))

    def latest(self) -> Optional[FrameMeta]:
        meta = FrameMeta()
        ok = self._lib.lvmt_mailbox_latest(self._ptr, ctypes.byref(meta))
        return meta if ok else None

    def clear(self) -> None:
        self._lib.lvmt_mailbox_clear(self._ptr)

    def __del__(self):
        try:
            self._lib.lvmt_mailbox_destroy(self._ptr)
        except Exception:
            pass


# ---------------------------------------------------------------- engine adapters

# Default arena slot: a 4K BGR frame (largest supported stream).
DEFAULT_MAX_FRAME_BYTES = 2160 * 3840 * 3


class NativeFramePoolAdapter:
    """Drop-in for engine.pool.FramePool backed by the C arena: acquire blocks
    GIL-released in C, buffers are zero-copy numpy views of arena slots, and
    the Frame release hook returns the slot. Enabled via LVMT_NATIVE=1 in
    PlaybackController."""

    def __init__(self, capacity: int = 12, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self._native = NativeFramePool(capacity, max_frame_bytes)
        self._max_bytes = max_frame_bytes

    def acquire(self, h: int, w: int, channels: int):
        from live_video_magnification_tpu_torch.engine.frame import Frame, PixelFormat

        shape = (h, w, channels) if channels > 1 else (h, w)
        nbytes = int(np.prod(shape))
        if nbytes > self._max_bytes:
            raise RuntimeError(
                f"frame {shape} exceeds the native arena slot ({self._max_bytes} B); "
                "raise LVMT_NATIVE_MAX_FRAME or disable LVMT_NATIVE"
            )
        idx = self._native.acquire()
        if idx is None:
            return None
        frame = Frame(data=self._native.buffer(idx, shape), width=w, height=h,
                      format=PixelFormat.BGR8 if channels >= 3 else PixelFormat.GRAY8)
        frame._buffer_index = idx
        frame._release = lambda i=idx: self._native.release(i)
        return frame

    def stop(self) -> None:
        self._native.stop()

    def reset(self) -> None:
        self._native.reset()


class NativeQueueAdapter:
    """Drop-in for engine.queue.BoundedQueue carrying pooled Frames: metadata
    crosses the C queue as FrameMeta (the pixel data never moves — it stays in
    the shared arena); DROP evictions recycle slots into the pool C-side."""

    def __init__(self, capacity: int, pool: NativeFramePoolAdapter):
        self._pool = pool
        self._native = NativeQueue(capacity, drop_policy=False, pool=pool._native)

    def set_policy(self, policy) -> None:
        from live_video_magnification_tpu_torch.engine.queue import OverflowPolicy

        self._native.set_policy(policy is OverflowPolicy.DROP)

    def push(self, frame) -> bool:
        idx = getattr(frame, "_buffer_index", None)
        assert idx is not None, "native queue carries only native-pool frames"
        meta = FrameMeta(
            seq=frame.seq, pts_us=frame.pts_us, capture_ts=frame.capture_ts,
            width=frame.width, height=frame.height, channels=frame.channels,
            buffer_index=idx,
        )
        # On success, ownership of the slot moves into the C queue (pop,
        # drop-recycle, and reset all handle it there). A push refused by a
        # stopped queue leaves the slot with no owner C-side, so recycle it
        # here (same contract the TSAN harness's producer follows).
        frame._release = None
        if self._native.push(meta):
            return True
        self._pool._native.release(idx)
        return False

    def pop(self, timeout: Optional[float] = None):
        from live_video_magnification_tpu_torch.engine.frame import Frame, PixelFormat

        meta = self._native.pop(-1.0 if timeout is None else timeout * 1e3)
        if meta is None:
            return None
        c = int(meta.channels)
        shape = (meta.height, meta.width, c) if c > 1 else (meta.height, meta.width)
        idx = int(meta.buffer_index)
        frame = Frame(
            seq=int(meta.seq), pts_us=int(meta.pts_us),
            capture_ts=float(meta.capture_ts), width=int(meta.width),
            height=int(meta.height),
            format=PixelFormat.BGR8 if c >= 3 else PixelFormat.GRAY8,
            data=self._pool._native.buffer(idx, shape),
        )
        frame._buffer_index = idx
        frame._release = lambda i=idx: self._pool._native.release(i)
        return frame

    def stop(self) -> None:
        self._native.stop()

    def reset(self) -> None:
        self._native.reset()

    @property
    def drops(self) -> int:
        return self._native.drops

    def depth(self) -> int:
        return self._native.depth()


CAPTURED, PROCESSED, DISPLAYED, DISPLAY_SKIPPED, READ_ERRORS, PROC_ERRORS = range(6)


class NativeInstrumentation:
    """Cache-line-padded atomic counters + latency histogram, C-side."""

    def __init__(self):
        self._lib = load()
        self._ptr = self._lib.lvmt_stats_create()

    def bump(self, which: int) -> None:
        self._lib.lvmt_stats_bump(self._ptr, which)

    def record_latency(self, seconds: float) -> None:
        self._lib.lvmt_stats_latency(self._ptr, seconds)

    def read(self):
        counts = (ctypes.c_longlong * 6)()
        lat = (ctypes.c_double * 2)()
        self._lib.lvmt_stats_read(self._ptr, counts, lat)
        return list(counts), lat[0], lat[1]

    def __del__(self):
        try:
            self._lib.lvmt_stats_destroy(self._ptr)
        except Exception:
            pass
