"""Plain reference of motion (Laplace) magnification, one frame at a time.

The reference app's Laplacian path (MagnifyCore.hpp, SpatialFilter.cpp,
TemporalFilter.cpp), in plain PyTorch:

  u8 BGR -> [0, 1] -> Lab -> Laplacian pyramid (``levels`` differences of
  cv::pyrDown / cv::pyrUp and the residual) -> per level the difference of
  two exponential moving averages (the IIR bandpass; the first frame seeds
  both with its own pyramid) -> the amplification ladder (the finest level
  and the residual zeroed) -> collapse -> a and b attenuated -> added to the
  input -> BGR u8.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from benchmark.reference.common import (
    BINOMIAL5,
    Taps,
    bgr_to_lab,
    correlate,
    lab_to_bgr,
    to_u8,
    unit,
)


class MotionParams(NamedTuple):
    amplification: float
    wavelength: float   # lambda_c: the UI's wavelength times 10
    blend_lo: float     # EMA coefficients 1 - exp(-2 pi f / fps), clamped below 1
    blend_hi: float
    chroma: float


def motion_params(cfg: dict) -> MotionParams:
    blend = lambda hz: min(max(1.0 - math.exp(-2.0 * math.pi * hz / cfg["capture_fps"]), 0.0),
                           0.999999)
    f32 = lambda v: float(np.float32(v))
    return MotionParams(f32(cfg["amplification"]), f32(cfg["wavelength"] * 10.0),
                        f32(blend(cfg["low_hz"])), f32(blend(cfg["high_hz"])),
                        f32(cfg["chroma"] / 100.0))


def ladder(p: MotionParams, h: int, w: int, levels: int) -> List[float]:
    """Gain of each pyramid level: min(alpha, (lambda / (8 delta) - 1) * 2)
    with delta = lambda_c / (8 (1 + alpha)); lambda starts at the frame's
    diagonal over 3 at the residual and halves toward the finest level. The
    finest level and the residual get 0. In float32, as the app's scalars."""
    f = np.float32
    alpha = f(p.amplification)
    delta = f(p.wavelength) / (f(8.0) * (f(1.0) + alpha))
    gains = [0.0] * (levels + 1)
    lam = math.sqrt(float(w * w + h * h)) / 3.0
    for lvl in range(levels, -1, -1):
        if 0 < lvl < levels:
            gains[lvl] = float(min(alpha, (f(lam) / (delta * f(8.0)) - f(1.0)) * f(2.0)))
        lam /= 2.0
    return gains


class MotionReference:
    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.p = motion_params(cfg)
        self.levels = cfg["levels"]
        self.dtype = dtype
        self.taps = Taps(device, dtype)
        self.hi = self.lo = None

    def _down(self, x):
        return correlate(x, self.taps.get("pyr", np.outer(BINOMIAL5, BINOMIAL5)), stride=2)

    @staticmethod
    def _up_axis(x: torch.Tensor, dim: int, out_len: int) -> torch.Tensor:
        """One axis of cv::pyrUp: the source zero-injected at even places,
        reflected about its ends in the upsampled domain, correlated with
        2 * the binomial taps; even outputs meet taps 0, 2, 4 and odd ones 1, 3."""
        t = (2.0 * BINOMIAL5).tolist()
        n = x.shape[dim]
        p = torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 1, 1)], dim=dim)
        s = lambda k: p.narrow(dim, k, n)
        even = s(0) * t[0] + s(1) * t[2] + s(2) * t[4]
        odd = s(1) * t[1] + s(2) * t[3]
        return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1).narrow(dim, 0, out_len)

    def _up(self, x, hw):
        return self._up_axis(self._up_axis(x, x.ndim - 1, hw[1]), x.ndim - 2, hw[0])

    def step(self, frame_u8: torch.Tensor) -> torch.Tensor:
        """[3, H, W] u8 BGR -> [3, H, W] u8 BGR."""
        _, h, w = frame_u8.shape
        lab = bgr_to_lab(unit(frame_u8, self.dtype))
        pyr, cur = [], lab
        for _ in range(self.levels):
            down = self._down(cur)
            pyr.append(cur - self._up(down, cur.shape[-2:]))
            cur = down
        pyr.append(cur)
        if self.hi is None:
            self.hi, self.lo = list(pyr), list(pyr)
        gains = ladder(self.p, h, w, self.levels)
        bands = []
        for lvl in range(self.levels):
            self.hi[lvl] = (1.0 - self.p.blend_hi) * self.hi[lvl] + self.p.blend_hi * pyr[lvl]
            self.lo[lvl] = (1.0 - self.p.blend_lo) * self.lo[lvl] + self.p.blend_lo * pyr[lvl]
            bands.append((self.hi[lvl] - self.lo[lvl]) * gains[lvl])
        motion = pyr[self.levels] * gains[self.levels]
        for lvl in range(self.levels - 1, -1, -1):
            motion = self._up(motion, bands[lvl].shape[-2:]) + bands[lvl]
        motion = torch.cat([motion[:1], motion[1:] * self.p.chroma])
        return to_u8(lab_to_bgr(lab + motion))


# The class ``benchmark/harness/compare.py`` finds by the configuration's reference name.
Reference = MotionReference
