"""Riesz pyramid ops (Wadhwa ICCP'14) matching the reference numerics.

The counterpart of the reference package's ``ops/riesz.py``
(RieszPyramid.cpp):

  * build_riesz_pyramid: buildPyramid (:215-238). Per band level, the 9x9
    high-pass (conv9), its Riesz pair (band5) and the decimated 2*LP9 octave
    (lp9_decimate); the residual octave gets its pair from the plain ops;
  * phase_difference_and_amplitude: the quaternion conjugate product, its
    log, NaN patching and the 13x13 sigma=3 amplitude blur (:81-111);
  * normalize_phase / amplify_level (:114-144), with the clamped arcCos quirk
    (x < -1 maps to -1.0, not acos(-1); :8-23) and THRESH_TRUNC clamping;
  * collapse_riesz_pyramid: zero-injected 2*LP9 upsample (lp9_inject) plus
    the finer octave's high-pass (conv9), coarsest first (:304-325).

The four stencils dispatch on the tensor's device (ops/hopper/stencils.py): the
CUDA kernel for a CUDA tensor at every level, the plain version on the CPU.
The functions here are also the plain tail (phase front, blurs, amplify),
which ``models/riesz.py::step`` runs by default, as the reference package
leaves its tail to XLA; the kernel tails are in ops/hopper/tail.py. All
planes are [H, W] f32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.ops.conv import (
    correlate_cols,
    correlate_rows,
    sep_correlate2d,
)
from live_video_magnification_tpu_torch.ops.hopper.stencils import (
    band5,
    conv9,
    lp9_decimate,
    lp9_inject,
)
from live_video_magnification_tpu_torch.ops.kernels import (
    AMPLITUDE_BLUR_KERNEL_1D,
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
    RIESZ_LOWPASS_9x9,
)
from live_video_magnification_tpu_torch.ops.temporal import CompExp

LOWPASS_2X = 2.0 * RIESZ_LOWPASS_9x9  # exact in f32


class RieszLevel(NamedTuple):
    """One pyramid level: band-passed octave + its Riesz transform pair."""

    lowpass: torch.Tensor  # the reference's itsLowpass (the band image)
    riesz: CompExp         # (real/x, imag/y) Riesz components


def riesz_level_sizes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    """Level sizes: ceil-halved per decimation; last level not decimated further."""
    sizes = []
    for i in range(levels):
        sizes.append((h, w))
        if i < levels - 1:
            h, w = h // 2 + h % 2, w // 2 + w % 2
    return sizes


def build_riesz_pyramid(frame: torch.Tensor, levels: int) -> List[RieszLevel]:
    """buildPyramid (:215-238): levels-1 band levels + the untouched final octave."""
    pyr = []
    octave = frame
    for _ in range(levels - 1):
        hp = conv9(octave, RIESZ_HIGHPASS_9x9)
        r, i = band5(hp, RIESZ_BAND_KERNEL)
        pyr.append(RieszLevel(hp, CompExp(r, i)))
        octave = lp9_decimate(octave, LOWPASS_2X)
    pyr.append(RieszLevel(octave, CompExp(correlate_rows(octave, RIESZ_BAND_KERNEL),
                                          correlate_cols(octave, RIESZ_BAND_KERNEL))))
    return pyr


PI_F32 = float(np.float32(np.pi))


def polynomial_arccos(x: torch.Tensor) -> torch.Tensor:
    """arccos for |x| <= 1 as the reference package's tail kernels compute it
    (``ops/pallas/riesz_phase_fused.py::_acos``, Abramowitz & Stegun 4.4.45):
    sqrt(1-|x|) * poly(|x|), mirrored through pi for x < 0; abs error ~1e-6
    rad. The kernel tails (K8, K9) use it; the plain tail uses torch.arccos."""
    ax = torch.abs(x)
    p = (((((((-0.0012624911 * ax + 0.0066700901) * ax - 0.0170881256) * ax
             + 0.0308918810) * ax - 0.0501743046) * ax + 0.0889789874) * ax
          - 0.2145988016) * ax + 1.5707963050)
    r = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x < 0.0, PI_F32 - r, r)


def clamped_arccos(x: torch.Tensor, arccos=torch.arccos) -> torch.Tensor:
    """The reference's arcCos (:8-23): out-of-range inputs map to +-1.0, not to
    acos of the clamp. Load-bearing for parity."""
    safe = arccos(torch.clamp(x, -1.0, 1.0))
    return torch.where(x < -1.0, -1.0, torch.where(x > 1.0, 1.0, safe))


def patch_nans(x: torch.Tensor) -> torch.Tensor:
    """cv::patchNaNs(x, 0): NaN -> 0 (infinities pass through)."""
    return torch.where(torch.isnan(x), 0.0, x)


def amplitude_blur(x: torch.Tensor) -> torch.Tensor:
    """GaussianBlur(13x13, sigma=3), reflect-101 (:110)."""
    return sep_correlate2d(x, AMPLITUDE_BLUR_KERNEL_1D, AMPLITUDE_BLUR_KERNEL_1D)


class PhaseResult(NamedTuple):
    phase_diff: CompExp
    amplitude: torch.Tensor
    amplitude_blurred: torch.Tensor


def phase_difference_and_amplitude(cur: RieszLevel, prior: RieszLevel,
                                   compute_blur: bool = True,
                                   arccos=torch.arccos) -> PhaseResult:
    """computePhaseDifferenceAndAmplitude (:81-111).

    The quaternion conjugate product cur * conj(prior); its log gives the
    phase difference as orientation*phi; the amplitude is the square root of
    the quaternion norm, blurred 13x13 sigma=3 (unblurred when
    ``compute_blur`` is False: a tail kernel blurs it itself). Divisions by a
    zero norm keep their IEEE results; NaN is patched to 0 as the reference
    does. ``arccos`` is the arccos of the phase (``polynomial_arccos`` in the
    kernel tails' plain versions)."""
    q_real = (
        cur.lowpass * prior.lowpass
        + cur.riesz.cos * prior.riesz.cos
        + cur.riesz.sin * prior.riesz.sin
    )
    # (prior.itsRiesz * (itsLowpass * -1)) + (itsRiesz * prior.itsLowpass)
    q_xy = CompExp(
        prior.riesz.cos * (-cur.lowpass) + cur.riesz.cos * prior.lowpass,
        prior.riesz.sin * (-cur.lowpass) + cur.riesz.sin * prior.lowpass,
    )
    xy_sq = q_xy.square_sum()
    q_amp = torch.sqrt(q_real * q_real + xy_sq)
    phi = clamped_arccos(q_real / q_amp, arccos)
    xy_norm = torch.sqrt(xy_sq)
    orientation = CompExp(q_xy.cos / xy_norm, q_xy.sin / xy_norm)
    phase_diff = CompExp(
        patch_nans(orientation.cos * phi), patch_nans(orientation.sin * phi)
    )
    amplitude = torch.sqrt(q_amp)
    blurred = amplitude_blur(amplitude) if compute_blur else amplitude
    return PhaseResult(phase_diff, amplitude, blurred)


def normalize_phase(
    highpass_iir: CompExp,
    lowpass_iir: CompExp,
    amplitude: torch.Tensor,
    amplitude_blurred: torch.Tensor,
) -> CompExp:
    """RieszPyramidLevel::normalize (:114-127): amplitude-weighted blur of the
    band-passed phase change, divided by the blurred amplitude."""
    change = highpass_iir - lowpass_iir
    cos = amplitude_blur(change.cos * amplitude) / amplitude_blurred
    sin = amplitude_blur(change.sin * amplitude) / amplitude_blurred
    return CompExp(cos, sin)


def amplify_level(level: RieszLevel, normalized: CompExp, alpha: float,
                  threshold: float) -> torch.Tensor:
    """RieszPyramidLevel::amplify (:129-144). Returns the phase-rotated lowpass."""
    mag = torch.sqrt(normalized.square_sum())
    mag2 = torch.clamp(mag * alpha, max=threshold)  # cv::THRESH_TRUNC
    cos_rot = torch.cos(mag2)
    sin_rot = torch.sin(mag2)
    pair = level.riesz.cos * normalized.cos + level.riesz.sin * normalized.sin
    pair = patch_nans(pair / mag)
    return level.lowpass * cos_rot - pair * sin_rot


def collapse_riesz_pyramid(lowpasses: List[torch.Tensor]) -> torch.Tensor:
    """collapsePyramid (:304-325): zero-injected 2*LP9 upsample + high-pass of
    each finer octave, coarsest first."""
    result = lowpasses[-1]
    for octave in reversed(lowpasses[:-1]):
        lp = lp9_inject(result, LOWPASS_2X, tuple(octave.shape))
        hp = conv9(octave, RIESZ_HIGHPASS_9x9)
        result = lp + hp
    return result
