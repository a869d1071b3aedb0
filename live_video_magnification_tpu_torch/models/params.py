"""Parameter model of the processing chain.

The counterpart of the reference package's ``models/params.py``: the
algorithm-unit dataclasses and enum (IProcessor.hpp:10-48) and the single
UI <-> algorithm unit mapping with the per-mode defaults
(MagnificationParamsUi.hpp), kept value for value so the CLI and any later
front end map sliders as the reference does.
"""

from __future__ import annotations

import dataclasses
import enum
import math


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


# --- UI mapping (MagnificationParamsUi.hpp) -----------------------------------------------------

_TWO_PI = 6.283185307179586


def motion_hz_to_blend(hz: float, fps: float) -> float:
    """Laplace band Hz -> IIR blend coefficient: a = 1 - exp(-2*pi*fc/fps),
    clamped to [0, 0.999999] (MagnificationParamsUi.hpp:29-34)."""
    if fps <= 0.0:
        fps = 30.0
    if hz <= 0.0:
        return 0.0
    a = 1.0 - math.exp(-_TWO_PI * hz / fps)
    return min(max(a, 0.0), 0.999999)


def motion_blend_to_hz(blend: float, fps: float) -> float:
    """Inverse of motion_hz_to_blend (MagnificationParamsUi.hpp:36-41)."""
    if fps <= 0.0:
        fps = 30.0
    blend = min(max(blend, 0.0), 0.999999)
    if blend <= 0.0:
        return 0.0
    return -(fps / _TWO_PI) * math.log(1.0 - blend)


@dataclasses.dataclass
class MagUiValues:
    """UI-unit values; low/high are Hz in every mode (MagnificationParamsUi.hpp:14-23)."""

    mode: MagnificationMode = MagnificationMode.LAPLACE
    amplification: int = 20
    wavelength: float = 50.0
    low: float = 1.0    # Hz
    high: float = 2.5   # Hz
    chroma: int = 0
    levels: int = 4
    capture_fps: float = 30.0


def defaults_for(mode: MagnificationMode) -> MagUiValues:
    """Per-mode defaults — the reference's DEFAULT_MM_* (MagnificationParamsUi.hpp:44-72)."""
    v = MagUiValues(mode=mode)
    if mode is MagnificationMode.COLOR:
        v.amplification = 100
        v.low = 0.84
        v.high = 1.43
        v.levels = 3
    elif mode is MagnificationMode.PHASE:
        v.amplification = 50
        v.wavelength = 50.0
        v.low = 1.0
        v.high = 5.0
        v.levels = 5
    else:  # LAPLACE and NONE
        v.amplification = 20
        v.wavelength = 50.0
        v.low = 1.0
        v.high = 5.0
        v.chroma = 0
        v.levels = 4
    return v


def clamp_band_to_nyquist(v: MagUiValues) -> MagUiValues:
    """The panel's Nyquist clamp: band range is [0.05, fps/2]
    (reference MagnificationControls.cpp:256-260)."""
    fps = v.capture_fps if v.capture_fps > 0 else 30.0
    lo_min, hi_max = 0.05, fps / 2.0
    v.low = min(max(v.low, lo_min), hi_max)
    v.high = min(max(v.high, lo_min), hi_max)
    if v.high < v.low:
        v.low, v.high = v.high, v.low
    return v


def to_params(v: MagUiValues) -> MagnificationParams:
    """UI units -> algorithm units (MagnificationParamsUi.hpp:74-103)."""
    common = dict(
        mode=v.mode,
        amplification=float(v.amplification),
        levels=v.levels,
        framerate=v.capture_fps,
    )
    if v.mode is MagnificationMode.COLOR:
        return MagnificationParams(
            co_wavelength=0.0, co_low=v.low, co_high=v.high, chrom_attenuation=0.0, **common
        )
    if v.mode is MagnificationMode.LAPLACE:
        return MagnificationParams(
            co_wavelength=v.wavelength * 10.0,  # UI % -> algorithm units
            co_low=motion_hz_to_blend(v.low, v.capture_fps),
            co_high=motion_hz_to_blend(v.high, v.capture_fps),
            chrom_attenuation=v.chroma / 100.0,
            **common,
        )
    if v.mode is MagnificationMode.PHASE:
        return MagnificationParams(
            co_wavelength=100.0 - v.wavelength,  # inverted to match Laplace's slider sense
            co_low=v.low,
            co_high=v.high,
            chrom_attenuation=0.0,
            **common,
        )
    return MagnificationParams(**common)


def to_ui(p: MagnificationParams) -> MagUiValues:
    """Algorithm units -> UI units (MagnificationParamsUi.hpp:105-132)."""
    mode = MagnificationMode.LAPLACE if p.mode is MagnificationMode.NONE else p.mode
    v = MagUiValues(
        mode=mode,
        amplification=int(p.amplification),
        levels=p.levels,
        capture_fps=p.framerate,
    )
    if mode is MagnificationMode.COLOR:
        v.low, v.high = p.co_low, p.co_high
    elif mode is MagnificationMode.LAPLACE:
        v.wavelength = p.co_wavelength / 10.0
        v.low = motion_blend_to_hz(p.co_low, p.framerate)
        v.high = motion_blend_to_hz(p.co_high, p.framerate)
        v.chroma = int(p.chrom_attenuation * 100.0)
    elif mode is MagnificationMode.PHASE:
        v.wavelength = 100.0 - p.co_wavelength
        v.low = p.co_low
        v.high = p.co_high
    return v
