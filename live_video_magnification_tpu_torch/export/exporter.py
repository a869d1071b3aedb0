"""Offline export worker (reference export/Exporter.{hpp,cpp}).

The counterpart of the reference package's ``export/exporter.py``. An
export runs the SAME chain implementation as live preview over an ordered
finite frame sequence with one fixed config snapshot (Exporter.cpp:202-207):
  * frame metadata synthesized at capture-fps cadence (:212-226);
  * optional live preview via the display mailbox (:227-228);
  * split composition to common EVEN dims + burned-in labels (:53-88);
  * codec fallback chain avc1 -> mp4v -> MJPG-in-.avi (:92-118);
  * writer finalized on every exit path; aborted exports delete the partial
    file; an empty range is an error, not a 0-frame success (:178-280);
  * worker exceptions are contained (:283-288).

:class:`Exporter` runs the chain on CUDA unless asked for the CPU.
``start`` resolves the device and builds and loads the kernel libraries in
the caller's thread, so a missing card or a failed build raises there, not
as a FAILED export; the worker then names that device explicitly.
``compose`` needs no cv2 unless labels are drawn (a gray pane becomes BGR by
repeating it); ``open_writer`` needs cv2.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

import numpy as np

from live_video_magnification_tpu_torch.engine.frame import Frame, PixelFormat, now
from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame, LatestFrameMailbox
from live_video_magnification_tpu_torch.engine.processing import hwc_result, prepare_device
from live_video_magnification_tpu_torch.export.sources import IExportFrameSource
from live_video_magnification_tpu_torch.export.types import (
    ExportFormat,
    ExportPhase,
    ExportProgress,
    ExportRequest,
    SplitMode,
)
from live_video_magnification_tpu_torch.models.chain import MagnificationChain


def _to_bgr(img: np.ndarray) -> np.ndarray:
    """Gray [H, W] -> BGR [H, W, 3] (cv2.COLOR_GRAY2BGR's bits: each channel
    the gray value); BGR unchanged."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img


def _draw_label(canvas: np.ndarray, text: str, x: int, y: int, scale: float) -> None:
    import cv2

    font = cv2.FONT_HERSHEY_SIMPLEX
    thickness = max(1, int(round(scale * 2)))
    (tw, th), baseline = cv2.getTextSize(text, font, scale, thickness)
    pad = max(2, int(round(scale * 4)))
    x0, y0 = x, y
    x1 = min(canvas.shape[1], x0 + tw + 2 * pad)
    y1 = min(canvas.shape[0], y0 + th + baseline + 2 * pad)
    if x1 <= x0 or y1 <= y0:
        return
    roi = canvas[y0:y1, x0:x1]
    roi[:] = (roi * 0.35).astype(np.uint8)  # darkened backdrop
    cv2.putText(canvas, text, (x + pad, y + pad + th), font, scale,
                (255, 255, 255), thickness, cv2.LINE_AA)


def compose(original: Optional[np.ndarray], processed: np.ndarray,
            split: SplitMode, overlay: bool) -> Optional[np.ndarray]:
    """Side-by-side / top-bottom panes cropped to common EVEN dims (H.264/FFV1
    requirement) + labels (Exporter.cpp:53-88)."""
    p = _to_bgr(processed)
    if split is SplitMode.NONE:
        w, h = p.shape[1] & ~1, p.shape[0] & ~1
        if w <= 0 or h <= 0:
            return None
        return np.ascontiguousarray(p[:h, :w])
    o = _to_bgr(original) if original is not None else p
    w = min(o.shape[1], p.shape[1]) & ~1
    h = min(o.shape[0], p.shape[0]) & ~1
    if w <= 0 or h <= 0:
        return None
    oc, pc = o[:h, :w], p[:h, :w]
    scale = min(max(w / 800.0, 0.4), 1.5)
    if split is SplitMode.LEFT_RIGHT:
        canvas = np.empty((h, 2 * w, 3), np.uint8)
        canvas[:, :w] = oc
        canvas[:, w:] = pc
        if overlay:
            _draw_label(canvas, "Original", 6, 6, scale)
            _draw_label(canvas, "Processed", w + 6, 6, scale)
    else:
        canvas = np.empty((2 * h, w, 3), np.uint8)
        canvas[:h] = oc
        canvas[h:] = pc
        if overlay:
            _draw_label(canvas, "Original", 6, 6, scale)
            _draw_label(canvas, "Processed", 6, h + 6, scale)
    return canvas


def clip_tchw(frames_hwc) -> np.ndarray:
    """[H, W, C] u8 frames as one contiguous [T, C, H, W] clip."""
    return np.ascontiguousarray(np.moveaxis(np.stack(frames_hwc), -1, 1))


def clip_hwc(processed: np.ndarray, original: Optional[np.ndarray] = None,
             split: SplitMode = SplitMode.NONE, labels: bool = False) -> np.ndarray:
    """A [T, C, H, W] processed clip as [T, H, W, C]: a view, or under a
    ``split`` each frame composed with its ``original`` (``compose``)."""
    out = np.moveaxis(processed, 1, -1)
    if split is SplitMode.NONE:
        return out
    return np.stack([compose(o, p, split, labels) for o, p in zip(clip_hwc(original), out)])


def open_writer(fmt: ExportFormat, path: str, fps: float, size_wh):
    """Codec fallback chain; returns (writer, actual_path, codec_name) or None."""
    import cv2

    def try_open(fourcc: str, p: str):
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*fourcc), fps, size_wh, True)
        return w if w.isOpened() else None

    attempts = {
        ExportFormat.MP4_H264: [("avc1", path), ("mp4v", path)],
        ExportFormat.AVI_MJPG: [("MJPG", path)],
        ExportFormat.MKV_FFV1: [("FFV1", path)],
    }[fmt]
    for fourcc, p in attempts:
        w = try_open(fourcc, p)
        if w is not None:
            return w, p, fourcc
    fallback = os.path.splitext(path)[0] + ".avi"
    w = try_open("MJPG", fallback)
    if w is not None:
        return w, fallback, "MJPG (fallback .avi)"
    return None


class Exporter:
    def __init__(self, device=None):
        self._device_spec = device
        self._device = None
        self._thread: Optional[threading.Thread] = None
        self._abort = threading.Event()
        self._lock = threading.Lock()
        self._progress = ExportProgress()
        self._preview: Optional[LatestFrameMailbox] = None

    # -- control ---------------------------------------------------------------------------------

    def start(self, source: IExportFrameSource, request: ExportRequest,
              preview: Optional[LatestFrameMailbox] = None) -> None:
        """Start the worker. Raises here, before any thread starts, without a
        card (unless the exporter was made with ``device="cpu"``) or when a
        kernel library does not build."""
        self._device = prepare_device(self._device_spec)
        self.join()
        self._abort.clear()
        self._preview = preview
        with self._lock:
            self._progress = ExportProgress(phase=ExportPhase.PROCESSING)
        self._thread = threading.Thread(
            target=self._run, args=(source, request), daemon=True, name="Exporter"
        )
        self._thread.start()

    def abort(self) -> None:
        self._abort.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if not self._thread.is_alive():
                self._thread = None

    def progress(self) -> ExportProgress:
        with self._lock:
            return dataclasses.replace(self._progress)

    def _set_progress(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self._progress, k, v)

    # -- worker ----------------------------------------------------------------------------------

    def _run(self, source: IExportFrameSource, req: ExportRequest) -> None:
        writer = None
        actual_path = req.output_path
        wrote_any = False
        try:
            if not source.open():
                self._set_progress(phase=ExportPhase.FAILED, error="cannot open source")
                return
            self._set_progress(frames_total=source.frame_count())

            chain = MagnificationChain(device=self._device)  # fresh chain; same code as live
            capture_fps = req.config.magnification.framerate or 30.0
            seq = 0
            while not self._abort.is_set():
                raw = source.next()
                if raw is None:
                    break
                processed_dev, original_dev = chain.process(raw, req.config)
                processed = hwc_result(processed_dev)
                original = hwc_result(original_dev)

                if self._preview is not None:
                    ts = now()
                    pf = Frame(seq=seq, pts_us=int(seq * 1e6 / capture_fps),
                               capture_ts=ts, width=processed.shape[1],
                               height=processed.shape[0],
                               format=PixelFormat.BGR8 if processed.ndim == 3
                               else PixelFormat.GRAY8,
                               data=processed)
                    of = dataclasses.replace(pf, data=original,
                                             width=original.shape[1],
                                             height=original.shape[0],
                                             format=PixelFormat.BGR8 if original.ndim == 3
                                             else PixelFormat.GRAY8)
                    self._preview.publish(DisplayFrame(pf, of))

                canvas = compose(original, processed, req.split, req.text_overlay)
                if canvas is None:
                    continue
                if writer is None:
                    opened = open_writer(req.format, req.output_path, req.file_fps,
                                         (canvas.shape[1], canvas.shape[0]))
                    if opened is None:
                        self._set_progress(phase=ExportPhase.FAILED,
                                           error="no usable codec/writer")
                        return
                    writer, actual_path, _codec = opened
                writer.write(canvas)
                wrote_any = True
                seq += 1
                self._set_progress(frames_done=seq)

            if self._abort.is_set():
                self._set_progress(phase=ExportPhase.ABORTED)
            elif not wrote_any:
                self._set_progress(phase=ExportPhase.FAILED, error="empty export range")
            else:
                self._set_progress(phase=ExportPhase.DONE)
        except Exception as e:  # worker escape would take down the process
            self._set_progress(phase=ExportPhase.FAILED, error=str(e))
        finally:
            if writer is not None:
                writer.release()
            source.close()
            if self._abort.is_set() and os.path.exists(actual_path):
                try:
                    os.remove(actual_path)  # delete the partial file
                except OSError:
                    pass
