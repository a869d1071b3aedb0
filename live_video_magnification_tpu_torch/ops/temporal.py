"""Temporal filtering of the phase pipeline.

The counterpart of the reference package's ``ops/temporal.py`` for phase mode
(TemporalFilter.cpp):

  * butterworth / butterworth_bandpass_coeffs: scipy-compatible digital
    Butterworth design, on the host in float64 (:268-297, :324-327);
  * CompExp and riesz_df2_step: the Direct-Form-II step with quaternionic
    phase accumulation (:340-351).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


def butterworth(order: int, wn: float) -> Tuple[np.ndarray, np.ndarray]:
    """Digital Butterworth lowpass (b, a), scipy.signal.butter-compatible.

    Analog prototype poles exp(j*(2k-1)/(2N)*pi)*j, warp w0 = 2*fs*tan(pi*Wn/fs)
    with fs=2, bilinear transform. Degenerate inputs (wn<=0, wn>=1, nan) give
    nan/inf coefficients, which callers detect as the reference's
    isnan(itsA[0]) re-init check (MagnifyCore.hpp:226)."""
    fs = 2.0
    with np.errstate(all="ignore"):
        w0 = 2.0 * fs * math.tan(math.pi * float(wn) / fs) if np.isfinite(wn) else float("nan")
        k_idx = np.arange(1, order + 1, dtype=np.float64)
        poles = np.exp(1j * (2.0 * k_idx - 1.0) / (2.0 * order) * np.pi) * 1j
        poles = poles * w0
        gain = w0**order
        fs2 = 2.0 * fs
        poles_z = (fs2 + poles) / (fs2 - poles)
        gain_z = gain * np.real(1.0 / np.prod(fs2 - poles))
        zeros_z = -np.ones(order)
        b = np.real(gain_z * np.poly(zeros_z))
        a = np.real(np.poly(poles_z))
    return b.astype(np.float64), a.astype(np.float64)


def butterworth_bandpass_coeffs(freq_hz: float, framerate: float) -> Tuple[np.ndarray, np.ndarray]:
    """Order-2 Butterworth for one cutoff: Wn = freq / (fps/2) (TemporalFilter.cpp:324-327)."""
    wn = 0.0 if framerate == 0.0 else freq_hz / (framerate / 2.0)
    return butterworth(2, wn)


class CompExp(NamedTuple):
    """A (cos, sin) pair of planes: the reference's CompExpMat (ComplexMat.hpp:9-110)."""

    cos: torch.Tensor
    sin: torch.Tensor

    def __add__(self, o):
        return CompExp(self.cos + o.cos, self.sin + o.sin)

    def __sub__(self, o):
        return CompExp(self.cos - o.cos, self.sin - o.sin)

    def scale(self, s):
        return CompExp(self.cos * s, self.sin * s)

    def square_sum(self):
        return self.cos * self.cos + self.sin * self.sin


def riesz_df2_step(phase_acc: CompExp, reg0: CompExp, reg1: CompExp,
                   phase_diff: CompExp, b, a):
    """One DF-II step (TemporalFilter.cpp:340-351): accumulate the quaternionic
    phase difference (phase unwrapping), then filter. ``b`` and ``a`` are three
    host floats each, already rounded to f32; a[0] == 1 is assumed. Returns
    (result, new_phase_acc, new_reg0, new_reg1)."""
    phase = phase_acc + phase_diff
    result = phase.scale(b[0]) + reg0
    new_reg0 = phase.scale(b[1]) + reg1 - result.scale(a[1])
    new_reg1 = phase.scale(b[2]) - result.scale(a[2])
    return result, phase, new_reg0, new_reg1
