"""Riesz pyramid ops (Wadhwa ICCP'14) matching the reference numerics.

The counterpart of the reference package's ``ops/riesz.py``
(RieszPyramid.cpp):

  * build_riesz_pyramid: buildPyramid (:215-238). Per band level, the 9x9
    high-pass, its Riesz pair and the decimated 2*LP9 octave, in one pass
    (riesz_build_level) or three (conv9, band5, lp9_decimate) as the
    reference's rule picks; the residual octave gets its pair from the plain
    ops;
  * phase_difference_and_amplitude: the quaternion conjugate product, its
    log, NaN patching and the 13x13 sigma=3 amplitude blur (:81-111);
  * normalize_phase / amplify_level (:114-144), with the clamped arcCos quirk
    (x < -1 maps to -1.0, not acos(-1); :8-23) and THRESH_TRUNC clamping;
  * collapse_riesz_pyramid: zero-injected 2*LP9 upsample (lp9_inject) plus
    the finer octave's high-pass (conv9), coarsest first (:304-325).

The stencils dispatch on the tensor's device (ops/hopper/stencils.py): the
CUDA kernel for a CUDA tensor at every level, the plain version on the CPU.
The functions here are also the plain tail (phase front, blurs, amplify),
which ``models/riesz.py::step`` runs by default, as the reference package
leaves its tail to XLA; its 13x13 amplitude blur is stencils.py's blur13 (a
CUDA kernel on a card); the kernel tails are in ops/hopper/tail.py. Planes
are [H, W] f32, except the band levels' planes under ``pyr_io="bf16"``.

The reference's fast modes (``LVMT_MXU_DTYPE``, ``LVMT_PYR_IO``) change the
function: bf16 operands round pixels and taps. So each bf16 arm engages only
where the reference's MXU kernel would run (short side >= MIN_MXU_SIDE, and
for the collapse an exact doubling of even sides); elsewhere the port
computes the f32 function the reference computes there.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.ops.conv import correlate_cols, correlate_rows
from live_video_magnification_tpu_torch.ops.hopper.stencils import (
    band5,
    blur13,
    conv9,
    lp9_decimate,
    lp9_inject,
    resolve_dtype,
    riesz_build_level,
)
from live_video_magnification_tpu_torch.ops.kernels import (
    LOWPASS_2X,
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
)
from live_video_magnification_tpu_torch.ops.temporal import CompExp

# The reference package's size gates (conv9_mxu.py MIN_MXU_DIM, riesz_build.py
# MIN_FUSED_DIM). Its TPU kernels need them; the port's kernels take any size
# of at least 5 (16 for riesz_build_level). Here they decide what the
# reference computes at a level: where its bf16 operands apply (>= 96) and
# which levels its default build fuses (16 to 95).
MIN_MXU_SIDE = 96
MIN_FUSED_SIDE = 16

# Values of the reference's LVMT_BUILD and LVMT_MXU_DTYPE that the port takes.
BUILDS = ("auto", "fused")
MXU_DTYPES = ("f32", "bf16", "hybrid", "hybrid-band")


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


def _choice(what: str, value: str, allowed) -> str:
    if value not in allowed:
        raise ValueError(f"unknown {what} {value!r}: expected one of {', '.join(allowed)}")
    return value


def resolve_build(build: str) -> str:
    """``build`` if it names one of BUILDS; raises otherwise."""
    return _choice("build", build, BUILDS)


def resolve_mxu_dtype(mxu_dtype: str) -> str:
    """``mxu_dtype`` if it names one of MXU_DTYPES; raises otherwise."""
    return _choice("mxu_dtype", mxu_dtype, MXU_DTYPES)


def hybrid_bf16(level: int, mxu_dtype: str) -> Tuple[bool, bool]:
    """(conv_bf16, band_bf16) of a pyramid level: whether the 9x9 stencils and
    the band pair take bf16 operands where the reference runs its MXU kernels
    (its ``_hybrid_bf16`` with the env default resolved). "hybrid" keeps the
    finest level f32; "hybrid-band" keeps the band pair f32 everywhere."""
    resolve_mxu_dtype(mxu_dtype)
    if mxu_dtype == "hybrid":
        return level > 0, level > 0
    if mxu_dtype == "hybrid-band":
        return True, False
    return mxu_dtype == "bf16", mxu_dtype == "bf16"


def fused_level(m: int, build: str = "auto") -> bool:
    """Whether a band level of short side ``m`` is built in one pass
    (riesz_build_level) rather than by conv9, band5 and lp9_decimate."""
    return m >= MIN_FUSED_SIDE and (build == "fused" or m < MIN_MXU_SIDE)


def stencil_launches(h: int, w: int, levels: int, build: str = "auto") -> dict:
    """Stencil launches of one (h, w) frame's build and collapse, by entry
    point of ops/hopper/stencils.py (each launches once a call on a CUDA
    tensor): per band level the one-pass build or the three stencils, and
    lp9_inject + conv9 in the collapse."""
    resolve_build(build)
    want = {"conv9": 0, "band5": 0, "lp9_decimate": 0, "lp9_inject": 0,
            "riesz_build_level": 0}
    for lh, lw in riesz_level_sizes(h, w, levels)[:-1]:
        if fused_level(min(lh, lw), build):
            want["riesz_build_level"] += 1
        else:
            for k in ("conv9", "band5", "lp9_decimate"):
                want[k] += 1
        want["lp9_inject"] += 1
        want["conv9"] += 1
    return want


def build_riesz_pyramid(frame: torch.Tensor, levels: int, *, build: str = "auto",
                        mxu_dtype: str = "f32", pyr_io: str = "f32") -> List[RieszLevel]:
    """buildPyramid (:215-238): levels-1 band levels + the untouched final octave.

    Per band level with short side m, as the reference's build_riesz_pyramid
    (:148-217) picks (the caller resolves the flags; nothing here reads the
    environment):

      * riesz_build_level (one pass, f32 operands) where m >= MIN_FUSED_SIDE
        and either m < MIN_MXU_SIDE or ``build == "fused"``;
      * conv9, band5 and lp9_decimate otherwise, with bf16 operands where
        m >= MIN_MXU_SIDE as ``hybrid_bf16`` says, f32 below 16.

    ``pyr_io == "bf16"`` stores each band level's hp and Riesz pair as bf16:
    conv9 and band5 round on the store (band5 reads the bf16 hp), the other
    routes round their f32 results. The decimated octaves and the residual
    level stay f32."""
    resolve_build(build)
    od = resolve_dtype(pyr_io)
    pyr = []
    octave = frame
    for lvl in range(levels - 1):
        m = min(octave.shape)
        if fused_level(m, build):
            hp, r, i, sub = riesz_build_level(octave, out_dtype=pyr_io)
        elif m >= MIN_MXU_SIDE:
            conv_bf16, band_bf16 = hybrid_bf16(lvl, mxu_dtype)
            hp = conv9(octave, RIESZ_HIGHPASS_9x9, bf16=conv_bf16, out_dtype=pyr_io)
            r, i = band5(hp, RIESZ_BAND_KERNEL, bf16=band_bf16, out_dtype=pyr_io)
            sub = lp9_decimate(octave, LOWPASS_2X, bf16=conv_bf16)
        else:
            hp = conv9(octave, RIESZ_HIGHPASS_9x9)
            r, i = band5(hp, RIESZ_BAND_KERNEL)
            hp, r, i = hp.to(od), r.to(od), i.to(od)
            sub = lp9_decimate(octave, LOWPASS_2X)
        pyr.append(RieszLevel(hp, CompExp(r, i)))
        octave = sub
    pyr.append(RieszLevel(octave, CompExp(correlate_rows(octave, RIESZ_BAND_KERNEL),
                                          correlate_cols(octave, RIESZ_BAND_KERNEL))))
    return pyr


def level_f32(level: RieszLevel) -> RieszLevel:
    """The level's planes as float32 (the same tensors where they are)."""
    return RieszLevel(level.lowpass.float(), CompExp(level.riesz.cos.float(),
                                                     level.riesz.sin.float()))


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
    """GaussianBlur(13x13, sigma=3), reflect-101 (:110), of each [H, W] plane
    of x: blur13's kernel on a CUDA tensor, its plain version on the CPU."""
    return blur13(x)


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


def collapse_riesz_pyramid(lowpasses: List[torch.Tensor], *,
                           mxu_dtype: str = "f32") -> torch.Tensor:
    """collapsePyramid (:304-325): zero-injected 2*LP9 upsample + high-pass of
    each finer octave, coarsest first. lp9_inject and conv9 take bf16
    operands (``hybrid_bf16``) only where the reference runs its MXU kernels
    (:326-351): even sides, exactly twice the coarser result, short side >=
    MIN_MXU_SIDE; f32 elsewhere."""
    result = lowpasses[-1]
    for lvl in range(len(lowpasses) - 2, -1, -1):
        octave = lowpasses[lvl]
        h, w = octave.shape
        mxu = (h % 2 == 0 and w % 2 == 0 and (h, w) == (2 * result.shape[0], 2 * result.shape[1])
               and min(h, w) >= MIN_MXU_SIDE)
        conv_bf16 = hybrid_bf16(lvl, mxu_dtype)[0] and mxu
        lp = lp9_inject(result, LOWPASS_2X, (h, w), bf16=conv_bf16)
        hp = conv9(octave, RIESZ_HIGHPASS_9x9, bf16=conv_bf16)
        result = lp + hp
    return result
