"""Structural-change tracking: when to drop temporal state.

The counterpart of the reference package's ``models/structural.py``
(MagnifyCore.hpp:45-80): a change of mode, levels, frame size, channels or
preprocess geometry invalidates all carried temporal state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from live_video_magnification_tpu_torch.models.params import (
    MagnificationMode,
    PreprocessParams,
    ProcessorConfig,
)


@dataclasses.dataclass
class StructuralTracker:
    mode: MagnificationMode = MagnificationMode.NONE
    levels: int = -1
    channels: int = -1
    size: Tuple[int, int] = (0, 0)  # (h, w)
    preprocess: Optional[PreprocessParams] = None

    def update(self, cfg: ProcessorConfig, levels: int, channels: int,
               size: Tuple[int, int]) -> bool:
        """True if a structural change occurred (caller must reset temporal state)."""
        p = cfg.magnification
        change = (
            p.mode is not self.mode
            or levels != self.levels
            or size != self.size
            or channels != self.channels
            or cfg.preprocess != self.preprocess
        )
        if change:
            self.mode = p.mode
            self.levels = levels
            self.size = size
            self.channels = channels
            self.preprocess = cfg.preprocess
        return change

    def disable(self) -> None:
        """Partial clear for the disabled/identity path (MagnifyCore.hpp:67-73)."""
        self.mode = MagnificationMode.NONE
        self.levels = -1
        self.channels = -1
        self.size = (0, 0)

    def reset(self) -> None:
        """Full clear: next frame takes the first-frame path (MagnifyCore.hpp:76-79)."""
        self.disable()
        self.preprocess = None
