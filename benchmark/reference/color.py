"""Plain reference of colour magnification, one frame at a time.

The reference app's colour path (MagnifyCore.hpp:163-206, SpatialFilter.cpp:
63-84, TemporalFilter.cpp:24-94), in plain PyTorch:

  u8 BGR -> f32 (no /255) -> ``levels`` pyrDowns; the coarsest level is
  pushed as the newest row of a rolling window of
  W = pow2(max(2 fps, 16)) rows, oldest first; while the window holds fewer
  than 2 rows the frame passes through -> the ideal bandpass over the L
  active rows -> min-max normalized over those rows and all channels ->
  times the amplification -> row min(1, L-1) reconstructed by ``levels``
  pyrUps and a bilinear resize to the frame's size -> added to the input ->
  u8 rescaled by the output's own min and max.

The bandpass is a discrete Fourier transform over time, masked as the app
masks it (TemporalFilter.cpp:24-80): a 0/1 mask is written over the indices
of OpenCV's CCS packed spectrum, each index kept where it lies in
[2 lo L / fps, 2 hi L / fps] (f32, the app's order of operations; a low
cutoff of 0 counts as 0.01), and ``cv::mulSpectrums`` then multiplies the
spectrum by the mask as by another CCS spectrum. The packed array holds the
real part of bin k at index 2k-1 and its imaginary part at 2k
(1 <= k < ceil(L/2)), DC at 0 and, for even L, the Nyquist bin at L-1, so
bin k is scaled by the complex gain m[2k-1] + i m[2k]: 1 + i where both of
its indices are in the band, i where only the imaginary one is, 1 where only
the real one is. The dft/idft round trip scales by 1/L^2.

Departures from the app, none of which changes a value beyond rounding:

* the transform is ``torch.fft.rfft`` / ``irfft`` over the time axis of the
  whole window, with the packed mask carried over to the half spectrum, in
  place of ``cv::dft`` on CCS-packed rows of a temporal matrix with one
  column a pixel;
* pyrDown is one 5x5 correlation (the binomial taps' outer product,
  reflect-101) with stride 2, and the resize is
  ``torch.nn.functional.interpolate`` (bilinear, half-pixel centres),
  which is cv::resize INTER_LINEAR;
* in bfloat16 (the control) every plane is bfloat16 but the transform,
  which ``torch.fft`` computes only in float32: its input and output are
  rounded to bfloat16.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import BINOMIAL5, Taps, correlate
from benchmark.reference.laplace import MotionReference

DBL_EPSILON = 2.220446049250313e-16


def window_rows(fps: float) -> int:
    """pow2(max(2 fps, 16)): two seconds of frames, a power of two, at least 16."""
    return 1 << math.ceil(math.log2(max(2 * int(fps), 16)))


def band(length: int, lo_hz: float, hi_hz: float, fps: float) -> Tuple[np.float32, np.float32]:
    """The packed indices kept: [2 lo L / fps, 2 hi L / fps], in f32."""
    f = np.float32
    lo = f(lo_hz) if f(lo_hz) != 0 else f(0.01)
    return (f(2.0) * lo * f(length)) / f(fps), (f(2.0) * f(hi_hz) * f(length)) / f(fps)


def packed_gains(length: int, lo_hz: float, hi_hz: float, fps: float):
    """(real, imag) parts of the complex gain of each of the L // 2 + 1 bins
    of ``rfft``: the mask at packed index 2k-1 and at 2k (DC: index 0; an
    even L's Nyquist bin: index L-1, real)."""
    fl, fh = band(length, lo_hz, hi_hz, fps)
    kept = lambda i: float(fl <= np.float32(i) <= fh)
    bins = length // 2 + 1
    real, imag = np.zeros(bins, np.float32), np.zeros(bins, np.float32)
    real[0] = kept(0)
    for k in range(1, (length + 1) // 2):
        real[k], imag[k] = kept(2 * k - 1), kept(2 * k)
    if length % 2 == 0:
        real[length // 2] = kept(length - 1)
    return real, imag


def ideal_bandpass(rows: torch.Tensor, lo_hz: float, hi_hz: float, fps: float) -> torch.Tensor:
    """[L, ...] -> [L, ...]: the DFT over dim 0, each bin times its gain, the
    inverse DFT, times 1/L^2."""
    length = rows.shape[0]
    real, imag = (torch.as_tensor(g, device=rows.device) for g in
                  packed_gains(length, lo_hz, hi_hz, fps))
    gain = torch.complex(real, imag).reshape(-1, *[1] * (rows.ndim - 1))
    spec = torch.fft.rfft(rows.float(), dim=0) * gain
    # irfft divides by L once: the identity round trip; the app's scale is 1/L^2
    return (torch.fft.irfft(spec, n=length, dim=0) / length).to(rows.dtype)


class ColorReference:
    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.levels = cfg["levels"]
        self.fps = float(cfg["capture_fps"])
        self.lo, self.hi = float(cfg["low_hz"]), float(cfg["high_hz"])
        self.amplification = float(np.float32(cfg["amplification"]))
        self.dtype = dtype
        self.taps = Taps(device, dtype)
        self.rows = window_rows(self.fps)
        self.window = None  # [L, C, hs, ws], oldest first

    def _down(self, x):
        return correlate(x, self.taps.get("pyr", np.outer(BINOMIAL5, BINOMIAL5)), stride=2)

    def step(self, frame_u8: torch.Tensor) -> torch.Tensor:
        """[3, H, W] u8 BGR -> [3, H, W] u8 BGR."""
        _, h, w = frame_u8.shape
        inp = frame_u8.to(self.dtype)
        top = inp
        for _ in range(self.levels):
            top = self._down(top)
        held = top[None] if self.window is None else torch.cat([self.window, top[None]])
        self.window = held[-self.rows:]
        length = self.window.shape[0]
        if length < 2:
            return frame_u8

        filtered = ideal_bandpass(self.window, self.lo, self.hi, self.fps)
        # cv::normalize NORM_MINMAX: a constant window (an empty band) maps to 0
        mn, mx = filtered.min(), filtered.max()
        scale = torch.where(mx - mn > DBL_EPSILON, 1.0 / (mx - mn), torch.zeros_like(mx))
        row = (filtered[1] - mn) * scale * self.amplification  # row min(1, L - 1)

        for _ in range(self.levels):
            row = MotionReference._up_axis(row, row.ndim - 1, 2 * row.shape[-1])
            row = MotionReference._up_axis(row, row.ndim - 2, 2 * row.shape[-2])
        if row.shape[-2:] != (h, w):
            row = F.interpolate(row[None], size=(h, w), mode="bilinear",
                                align_corners=False)[0]
        out = inp + row
        # convertTo(CV_8U, 255 / (max - min), -min * 255 / (max - min)): rint, saturate
        omn, omx = out.min(), out.max()
        alpha, beta = 255.0 / (omx - omn), -omn * 255.0 / (omx - omn)
        return torch.round(out * alpha + beta).clamp(0.0, 255.0).to(torch.uint8)


# The class ``benchmark/harness/compare.py`` finds by the configuration's reference name.
Reference = ColorReference
