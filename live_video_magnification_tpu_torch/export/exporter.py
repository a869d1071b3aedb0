"""Pane composition of an offline export (reference export/Exporter.cpp:53-88).

The counterpart of the part of the reference package's ``export/exporter.py``
that ``cli.py magnify`` uses: the original and processed panes side by side
or one above the other, cropped to common even dimensions (H.264 and FFV1
need them), with optional burned-in labels. cv2 is imported only to convert a
gray pane or to draw a label, so colour panes without labels compose without
it. The ``Exporter`` worker comes with the host engine (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from live_video_magnification_tpu_torch.export.types import SplitMode


def _to_bgr(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        import cv2

        return cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
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
