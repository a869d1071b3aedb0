"""Temporal filters of the three modes.

The counterpart of the reference package's ``ops/temporal.py``
(TemporalFilter.cpp):

  * iir_filter: the two-EMA bandpass of motion mode (:9-22);
  * ideal_bandpass_*: the row-wise DFT bandpass of colour mode (:24-80) with
    OpenCV's CCS packed-spectrum quirk (an in-band bin is scaled by 1 + 1i).
    The operator is linear and diagonal in the Fourier basis, hence
    circulant: its first column for the active window length L is built in
    f32 on the device and applied as one [W, W] @ [W, N] matmul over the
    time axis, in IEEE f32 (``device.pin_ieee_f32``);
  * minmax_normalize: cv::normalize NORM_MINMAX with OpenCV's constant guard;
  * optimal_buffer_size: the pow2(max(2*fps, 16)) rolling window (:82-94);
  * butterworth / butterworth_bandpass_coeffs: scipy-compatible digital
    Butterworth design, on the host in float64 (:268-297, :324-327);
  * CompExp and riesz_df2_step: the Direct-Form-II step with quaternionic
    phase accumulation (:340-351).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device

_DBL_EPSILON = 2.220446049250313e-16


# --- motion-mode IIR bandpass -------------------------------------------------------------------

def iir_filter(src: torch.Tensor, lowpass_hi: torch.Tensor, lowpass_lo: torch.Tensor,
               cutoff_lo: float, cutoff_hi: float):
    """One step of the double-EMA bandpass. Returns (bandpassed, new_hi, new_lo).

    The cutoffs are host values taken as f32, as the reference's f32
    scalars; cutoff_lo == 0 is floored to 0.01 as the reference does (exact
    compare)."""
    lo, hi = np.float32(cutoff_lo), np.float32(cutoff_hi)
    if lo == 0.0:
        lo = np.float32(0.01)
    new_hi = float(np.float32(1.0) - hi) * lowpass_hi + float(hi) * src
    new_lo = float(np.float32(1.0) - lo) * lowpass_lo + float(lo) * src
    return new_hi - new_lo, new_hi, new_lo


# --- colour-mode ideal FFT bandpass -------------------------------------------------------------

def optimal_buffer_size(fps: int) -> int:
    """Two seconds of footage rounded up to a power of two, minimum 16."""
    n = max(2 * int(fps), 16)
    return 1 << max(0, math.ceil(math.log2(n)))


def _band_edges(length: int, cutoff_lo: float, cutoff_hi: float, framerate: float):
    """(fl, fh): the packed-index band [2*lo*L/fps, 2*hi*L/fps] in f32, the
    reference's order of operations; cutoff_lo == 0 is bumped to 0.01."""
    lf = np.float32(length)
    lo, hi = np.float32(cutoff_lo), np.float32(cutoff_hi)
    if lo == 0.0:
        lo = lo + np.float32(0.01)
    fps = np.float32(framerate)
    return (np.float32(2.0) * lo * lf) / fps, (np.float32(2.0) * hi * lf) / fps


def ideal_bandpass_gains(w_static: int, length: int, cutoff_lo: float, cutoff_hi: float,
                         framerate: float, device=None):
    """Per-frequency gains (gr[k], gi[k], g_dc, g_ny) of the packed-mask bandpass.

    ``length`` (a host int) is the active window length L <= w_static. Packed
    CCS index mapping: Re_k at 2k-1, Im_k at 2k (1 <= k <= ceil(L/2)-1), DC
    real at 0, Nyquist real at L-1 for even L. Mask = 1 on packed indices in
    [fl, fh] (TemporalFilter.cpp:59-80). gr and gi are f32 tensors on
    ``device`` (CUDA by default); g_dc and g_ny are host floats."""
    dev = resolve_device(device)
    fl, fh = _band_edges(length, cutoff_lo, cutoff_hi, framerate)
    in_band = lambda x: ((x >= float(fl)) & (x <= float(fh))).to(torch.float32)
    k = torch.arange(w_static, device=dev)
    interior = (k >= 1) & (k < (length + 1) // 2)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gr = torch.where(interior, in_band((2 * k - 1).to(torch.float32)), zero)
    gi = torch.where(interior, in_band((2 * k).to(torch.float32)), zero)
    g_dc = float(fl <= 0.0 <= fh)
    g_ny = float(fl <= np.float32(length - 1) <= fh) if length % 2 == 0 else 0.0
    return gr, gi, g_dc, g_ny


def ideal_bandpass_circulant_col(w_static: int, length: int, cutoff_lo: float,
                                 cutoff_hi: float, framerate: float, device=None) -> torch.Tensor:
    """First column b[d] of the circulant bandpass operator for window length L.

    y[n] = sum_m b[(n - m) mod L] x[m], with the double DFT_SCALE (1/L^2) of
    the reference's dft/idft round trip folded in; b[d] = 0 for d >= L."""
    gr, gi, g_dc, g_ny = ideal_bandpass_gains(w_static, length, cutoff_lo, cutoff_hi,
                                              framerate, device)
    lf = float(length)
    d = torch.arange(w_static, dtype=torch.float32, device=gr.device)[:, None]  # displacement
    k = torch.arange(w_static, dtype=torch.float32, device=gr.device)[None, :]  # frequency
    ang = 2.0 * math.pi * k * d / lf
    # 2*Re(G_k e^{i ang}) = 2*(gr*cos - gi*sin); DC and Nyquist contribute once.
    terms = 2.0 * (gr[None, :] * torch.cos(ang) - gi[None, :] * torch.sin(ang))
    b = g_dc + torch.sum(terms, dim=1) + g_ny * torch.cos(math.pi * d[:, 0])
    b = b / (lf * lf)
    return torch.where(torch.arange(w_static, device=gr.device) < length, b, 0.0)


@lru_cache(maxsize=256)
def ideal_bandpass_operator(w_static: int, length: int, cutoff_lo: float, cutoff_hi: float,
                            framerate: float, device: torch.device) -> torch.Tensor:
    """The [W, W] circulant operator for window length L: rows and columns
    >= L are zero. It depends only on its arguments, so it is built once on
    ``device`` per key and then reused: the steady step makes no operator."""
    b = ideal_bandpass_circulant_col(w_static, length, cutoff_lo, cutoff_hi, framerate, device)
    n = torch.arange(w_static, device=b.device)[:, None]
    m = torch.arange(w_static, device=b.device)[None, :]
    bmat = b[torch.remainder(n - m, max(length, 1))]
    return torch.where((n < length) & (m < length), bmat, 0.0)


def ideal_bandpass_apply(window: torch.Tensor, count: int, cutoff_lo: float,
                         cutoff_hi: float, framerate: float) -> torch.Tensor:
    """The ideal bandpass over the time axis of ``window`` [W, N] f32.

    Rows >= count are ignored (zero operator rows and columns). Returns the
    filtered [W, N], with the reference's 1/L^2 pre-normalization scale."""
    op = ideal_bandpass_operator(window.shape[0], int(count), float(cutoff_lo),
                                 float(cutoff_hi), float(framerate), window.device)
    return torch.matmul(op, window)


def minmax_normalize(x: torch.Tensor, valid_rows: Optional[int] = None) -> torch.Tensor:
    """cv::normalize(..., 0, 1, NORM_MINMAX) over the whole tensor (all channels).

    ``valid_rows`` (a host int) limits the min and max to rows [0, valid_rows)
    of dim 0, the active part of colour mode's window (the reference's
    ``valid_mask``). OpenCV guards the constant input: scale = (max-min >
    DBL_EPSILON) ? 1/(max-min) : 0, so a constant array maps to zeros, not
    NaN (core/src/norm.cpp normalize()). The min and max stay on the device."""
    valid = x if valid_rows is None else x[:valid_rows]
    mn, mx = valid.min(), valid.max()
    delta = mx - mn
    inv = torch.where(delta > _DBL_EPSILON, 1.0 / delta, 0.0)
    return (x - mn) * inv


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
