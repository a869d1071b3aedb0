"""Video file decode and encode through OpenCV's bundled FFmpeg.

The counterpart of the reference package's ``io/video.py`` (the reference
app's cv::VideoCapture / cv::VideoWriter use, FileSource.cpp and
Exporter.cpp:92-118), as plain functions for clip workflows. cv2 is imported
inside each call; where it is missing the call raises an ImportError that
says so.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np


def _cv2():
    """OpenCV, imported at the call: the port's compute path does not need it,
    and a machine without it can run everything but file I/O."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "video file I/O needs OpenCV (the cv2 module), which is not installed; "
            "install opencv-python, or pass frames as arrays (utils/synthetic.py makes "
            "a test clip without it)") from e
    return cv2


def video_info(path: str) -> Tuple[int, int, int, float]:
    """(frames, height, width, fps); frames may be 0 when the container lies."""
    cv2 = _cv2()

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    return n, h, w, fps


def iter_video(path: str, start: int = 0, end: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield HWC u8 BGR frames of [start, end)."""
    cv2 = _cv2()

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    if start:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    pos = start
    try:
        while end is None or pos < end:
            ok, img = cap.read()
            if not ok:
                return
            pos += 1
            yield img
    finally:
        cap.release()


def read_video(path: str, start: int = 0, end: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """Read [start, end) into a [T, H, W, C] u8 array. Returns (frames, fps)."""
    _, _, _, fps = video_info(path)
    frames = list(iter_video(path, start, end))
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames), fps


class VideoWriterStream:
    """Incremental writer for chunked export: lazily opens on the first frame
    (output dims are only known post-preprocess), falls back to MJPG .avi like
    the reference's codec chain (Exporter.cpp:92-118)."""

    def __init__(self, path: str, fps: float, fourcc: str = "mp4v"):
        self._path = path
        self._fps = fps
        self._fourcc = fourcc
        self._writer = None
        self.frames_written = 0

    def _open(self, h: int, w: int, color: bool) -> None:
        cv2 = _cv2()

        def try_open(p, fc):
            wtr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*fc), self._fps,
                                  (w, h), color)
            return wtr if wtr.isOpened() else None

        self._writer = try_open(self._path, self._fourcc)
        if self._writer is None:
            self._path = os.path.splitext(self._path)[0] + ".avi"
            self._writer = try_open(self._path, "MJPG")
        if self._writer is None:
            raise IOError("no usable video writer")

    def write_chunk(self, frames_thwc: np.ndarray) -> None:
        """frames: [T, H, W, C] or [T, H, W] u8."""
        if self._writer is None:
            h, w = frames_thwc.shape[1], frames_thwc.shape[2]
            color = frames_thwc.ndim == 4 and frames_thwc.shape[3] == 3
            self._open(h, w, color)
        for i in range(frames_thwc.shape[0]):
            self._writer.write(np.ascontiguousarray(frames_thwc[i]))
        self.frames_written += frames_thwc.shape[0]

    def close(self) -> str:
        if self._writer is not None:
            self._writer.release()
            self._writer = None
        return self._path


def write_video(path: str, frames: np.ndarray, fps: float, fourcc: str = "mp4v") -> str:
    """Write [T, H, W, C] or [T, H, W] u8 frames; falls back to MJPG .avi.

    Returns the path actually written."""
    cv2 = _cv2()

    t = frames.shape[0]
    h, w = frames.shape[1], frames.shape[2]
    color = frames.ndim == 4 and frames.shape[3] == 3

    def _open(p, fc):
        wtr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*fc), fps, (w, h), color)
        return wtr if wtr.isOpened() else None

    writer = _open(path, fourcc)
    if writer is None:
        path = os.path.splitext(path)[0] + ".avi"
        writer = _open(path, "MJPG")
    if writer is None:
        raise IOError("no usable video writer")
    for i in range(t):
        writer.write(frames[i])
    writer.release()
    return path


def concat_videos(paths, output: str, fps: float) -> str:
    """Concatenate part files into ONE playable file: ffmpeg concat demuxer
    (stream copy, bit-preserving) when ffmpeg is on PATH, else a cv2
    re-encode fallback (lossless only for lossless part codecs like FFV1;
    lossy codecs pay one extra quantization pass) — the reference's
    codec-fallback philosophy (Exporter.cpp:92-118). Returns the final output
    path (the cv2 fallback may switch containers). Part files are NOT
    deleted."""
    ext = os.path.splitext(output)[1]
    out_dir = os.path.dirname(output) or "."
    if shutil.which("ffmpeg") is not None:
        tmp_fd, tmp_out = tempfile.mkstemp(suffix=ext, dir=out_dir)
        os.close(tmp_fd)
        list_fd, list_path = tempfile.mkstemp(suffix=".txt", dir=out_dir)
        try:
            with os.fdopen(list_fd, "w") as f:
                for p in paths:
                    escaped = os.path.abspath(p).replace("'", "'\\''")
                    f.write(f"file '{escaped}'\n")
            try:
                proc = subprocess.run(
                    ["ffmpeg", "-y", "-f", "concat", "-safe", "0", "-i",
                     list_path, "-c", "copy", tmp_out],
                    capture_output=True, text=True, timeout=600,
                )
                ok = proc.returncode == 0
            except (subprocess.SubprocessError, OSError):
                # TimeoutExpired / exec failure: fall through to the cv2
                # re-encode instead of aborting after all compute is done
                ok = False
            if ok:
                os.replace(tmp_out, output)
                return output
            os.unlink(tmp_out)  # stream copy failed; fall through to re-encode
        finally:
            if os.path.exists(list_path):
                os.unlink(list_path)
    wtr = VideoWriterStream(
        os.path.join(out_dir, f".{os.path.basename(output)}.concat{ext}"), fps)
    for p in paths:
        for frame in iter_video(p):
            wtr.write_chunk(frame[None] if frame.ndim == 3 else frame[None, ..., None])
    final = wtr.close()
    if wtr.frames_written == 0:
        raise IOError("concat re-encode produced no frames")
    if os.path.splitext(final)[1] != ext:  # writer fell back to another container
        output = os.path.splitext(output)[0] + os.path.splitext(final)[1]
    os.replace(final, output)
    return output
