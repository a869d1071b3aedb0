"""Export request and progress types (reference export/ExportTypes.hpp:11-51).

The counterpart of the reference package's ``export/types.py``.

Capture rate (algorithm Hz, inside ProcessorConfig.magnification.framerate) and
file fps are independent: process 1000 fps slow-motion footage, write a 30 fps
file.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from live_video_magnification_tpu_torch.models.params import ProcessorConfig


class SplitMode(enum.Enum):
    NONE = "none"
    LEFT_RIGHT = "left-right"
    TOP_BOTTOM = "top-bottom"


class ExportFormat(enum.Enum):
    MP4_H264 = "mp4-h264"
    AVI_MJPG = "avi-mjpg"
    MKV_FFV1 = "mkv-ffv1"  # lossless


class ExportPhase(enum.Enum):
    IDLE = "idle"
    RECORDING = "recording"
    PROCESSING = "processing"
    DONE = "done"
    FAILED = "failed"
    ABORTED = "aborted"


@dataclasses.dataclass(frozen=True)
class ExportRequest:
    config: ProcessorConfig
    output_path: str
    file_fps: float = 30.0
    split: SplitMode = SplitMode.NONE
    text_overlay: bool = False
    format: ExportFormat = ExportFormat.MP4_H264
    start_frame: int = 0
    end_frame: Optional[int] = None  # exclusive; None = to the end


@dataclasses.dataclass
class ExportProgress:
    phase: ExportPhase = ExportPhase.IDLE
    frames_done: int = 0
    frames_total: Optional[int] = None  # None = indeterminate
    error: Optional[str] = None


EXTENSION_FOR_FORMAT = {
    ExportFormat.MP4_H264: ".mp4",
    ExportFormat.AVI_MJPG: ".avi",
    ExportFormat.MKV_FFV1: ".mkv",
}


def validate_request(req: ExportRequest, frame_count: Optional[int] = None) -> list:
    """Field validation matching the reference's export dialog
    (ExportSettingsDialog.cpp: range order, writable directory, sane fps).
    Returns a list of human-readable problems; empty == valid. Overwrite is a
    confirmation concern, not an error (surface separately via os.path.exists).
    """
    import os

    problems = []
    if not req.output_path:
        problems.append("no output path")
    else:
        d = os.path.dirname(os.path.abspath(req.output_path))
        if not os.path.isdir(d):
            problems.append(f"directory does not exist: {d}")
        elif not os.access(d, os.W_OK):
            problems.append(f"directory not writable: {d}")
    if req.file_fps <= 0:
        problems.append("file fps must be positive")
    if req.start_frame < 0:
        problems.append("start frame must be >= 0")
    if req.end_frame is not None and req.end_frame <= req.start_frame:
        problems.append("end frame must be after start frame")
    if frame_count:
        if req.start_frame >= frame_count:
            problems.append(f"start frame beyond clip end ({frame_count})")
        if req.end_frame is not None and req.end_frame > frame_count:
            problems.append(f"end frame beyond clip end ({frame_count})")
    # The export now carries its OWN editable config (reference
    # ExportSettingsDialog.cpp:60-200) — validate its numerics too.
    mag = req.config.magnification
    if mag.framerate <= 0:
        problems.append("capture framerate must be positive")
    if mag.amplification < 0:
        problems.append("amplification must be >= 0")
    if mag.levels < 1:
        problems.append("levels must be >= 1")
    if req.config.preprocess.downscale not in (1, 2, 4, 8):
        problems.append("downscale must be 1, 2, 4 or 8")
    return problems
