"""Parameter model of the processing chain.

The counterpart of the reference package's ``models/params.py`` for the
dataclasses and enum the chain needs (IProcessor.hpp:10-48). The UI unit
mapping (MagnificationParamsUi.hpp) is still to come with the front ends.
"""

from __future__ import annotations

import dataclasses
import enum


class MagnificationMode(enum.Enum):
    LAPLACE = "laplace"  # Laplacian pyramid + temporal IIR bandpass (Eulerian motion)
    PHASE = "phase"      # Riesz pyramid + Butterworth phase filtering
    COLOR = "color"      # Gaussian pyramid + ideal FFT bandpass
    NONE = "none"        # internal bypass, never a UI choice


@dataclasses.dataclass(frozen=True)
class MagnificationParams:
    """Algorithm-unit parameters (IProcessor.hpp:14-23).

    co_low/co_high: LAPLACE = IIR blend coefficients in [0,1]; COLOR/PHASE = Hz.
    """

    mode: MagnificationMode = MagnificationMode.LAPLACE
    amplification: float = 0.0     # alpha
    co_wavelength: float = 0.0     # spatial cutoff wavelength (lambda_c analogue)
    co_low: float = 0.0
    co_high: float = 0.0
    chrom_attenuation: float = 0.0  # Lab a/b attenuation, color motion frames only
    levels: int = 4
    framerate: float = 30.0        # true capture rate (Color ideal filter, Riesz Butterworth)


@dataclasses.dataclass(frozen=True)
class PreprocessParams:
    """Geometric preprocessing applied before grayscale+magnification
    (IProcessor.hpp:25-41). The ROI is normalized against the full source
    frame; any change is structural and resets temporal state."""

    downscale: int = 1          # divide dims by 1 / 2 / 4 / 8
    roi_enabled: bool = False
    roi_x: float = 0.0
    roi_y: float = 0.0
    roi_w: float = 1.0
    roi_h: float = 1.0


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    """The per-frame config snapshot (IProcessor.hpp:43-48)."""

    grayscale: bool = False
    preprocess: PreprocessParams = dataclasses.field(default_factory=PreprocessParams)
    magnification: MagnificationParams = dataclasses.field(default_factory=MagnificationParams)
