"""Plain reference of phase (Riesz) magnification, one frame at a time.

The reference app's phase path (MagnifyCore.hpp, RieszPyramid.cpp,
TemporalFilter.cpp; Wadhwa et al., ICCP 2014), in plain PyTorch:

  u8 BGR -> [0, 1] -> Lab, take L -> Riesz pyramid (per band level the 9x9
  high-pass, its Riesz pair by the 5-tap band kernel along rows and columns,
  and the 2*LP9 low-pass decimated; the last level is the residual octave)
  -> quaternion phase difference against the prior frame's pyramid -> the
  accumulated phase through two order-2 Butterworth DF-II filters (low and
  high cutoff) -> their difference, amplitude-weighted 13x13 blur over the
  blurred amplitude -> rotation of the band by alpha times it, clamped at the
  threshold -> collapse (zero-injected 2*LP9 upsample plus the band's 9x9
  high-pass) -> L back into Lab -> BGR u8.

The first frame is passed through unchanged. The Butterworth coefficients
come from scipy's design, rounded to float32. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import scipy.signal
import torch

from benchmark.reference.common import (
    BLUR13,
    HIGHPASS9,
    LOWPASS9,
    RIESZ_BAND,
    Taps,
    bgr_to_lab,
    correlate,
    lab_to_bgr,
    to_u8,
    unit,
)


class PhaseParams(NamedTuple):
    amplification: float
    threshold: float   # (100 - wavelength) * pi / 100: the clamp of the rotation
    b_lo: tuple
    a_lo: tuple
    b_hi: tuple
    a_hi: tuple


def phase_params(cfg: dict) -> PhaseParams:
    """The algorithm's parameters from a configuration's UI values."""
    f32 = lambda v: float(np.float32(v))
    nyq = cfg["capture_fps"] / 2.0
    coeffs = []
    for hz in (cfg["low_hz"], cfg["high_hz"]):
        b, a = scipy.signal.butter(2, hz / nyq)
        coeffs += [tuple(f32(v) for v in b), tuple(f32(v) for v in a)]
    return PhaseParams(f32(cfg["amplification"]),
                       f32((100.0 - cfg["wavelength"]) * math.pi / 100.0), *coeffs)


class PhaseReference:
    """Carries the prior pyramid and the filter registers between frames."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.p = phase_params(cfg)
        self.levels = cfg["levels"]
        self.dtype = dtype
        self.taps = Taps(device, dtype)
        self.old = None
        self.regs = None  # per band level: acc (2), lo regs (4), hi regs (4)

    def _w(self, name):
        row = lambda k: np.asarray(k, np.float32)[None, :]
        table = {"hp": HIGHPASS9, "lp": 2.0 * LOWPASS9, "band_r": row(RIESZ_BAND),
                 "band_c": row(RIESZ_BAND).T, "blur_r": row(BLUR13), "blur_c": row(BLUR13).T}
        return self.taps.get(name, table[name])

    def _blur(self, x):
        return correlate(correlate(x, self._w("blur_r")), self._w("blur_c"))

    def pyramid(self, light: torch.Tensor) -> List[tuple]:
        pyr, octave = [], light
        for _ in range(self.levels - 1):
            hp = correlate(octave, self._w("hp"))
            pyr.append((hp, correlate(hp, self._w("band_r")), correlate(hp, self._w("band_c"))))
            octave = correlate(octave, self._w("lp"), stride=2)
        pyr.append((octave, correlate(octave, self._w("band_r")),
                    correlate(octave, self._w("band_c"))))
        return pyr

    def _inject(self, small: torch.Tensor, hw) -> torch.Tensor:
        h, w = hw
        z = small.new_zeros((2 * ((h + 1) // 2), 2 * ((w + 1) // 2)))
        z[0::2, 0::2] = small[: (h + 1) // 2, : (w + 1) // 2]
        return correlate(z[:h, :w], self._w("lp"))

    def _level(self, cur, old, regs):
        lp, r, i = cur
        olp, o_r, o_i = old
        q_real = lp * olp + r * o_r + i * o_i
        qx = o_r * (-lp) + r * olp
        qy = o_i * (-lp) + i * olp
        xy_sq = qx * qx + qy * qy
        q_amp = torch.sqrt(q_real * q_real + xy_sq)
        ratio = q_real / q_amp
        # the reference's arcCos: inputs past +-1 map to +-1.0, not to acos of the clamp
        phi = torch.where(ratio < -1.0, -1.0,
                          torch.where(ratio > 1.0, 1.0, torch.arccos(ratio.clamp(-1.0, 1.0))))
        xy_norm = torch.sqrt(xy_sq)
        nan0 = lambda t: torch.where(torch.isnan(t), 0.0, t)
        diff = (nan0(qx / xy_norm * phi), nan0(qy / xy_norm * phi))
        amplitude = torch.sqrt(q_amp)

        acc_c, acc_s = regs[0] + diff[0], regs[1] + diff[1]
        outs, new_regs = [], [acc_c, acc_s]
        for (b, a), k in (((self.p.b_lo, self.p.a_lo), 2), ((self.p.b_hi, self.p.a_hi), 6)):
            filtered = []
            for phase, r0, r1 in ((acc_c, regs[k], regs[k + 2]), (acc_s, regs[k + 1], regs[k + 3])):
                y = phase * b[0] + r0
                filtered.append((y, phase * b[1] + r1 - y * a[1], phase * b[2] - y * a[2]))
            outs.append((filtered[0][0], filtered[1][0]))
            new_regs += [filtered[0][1], filtered[1][1], filtered[0][2], filtered[1][2]]

        (lo_c, lo_s), (hi_c, hi_s) = outs
        blurred = self._blur(amplitude)
        nc = self._blur((hi_c - lo_c) * amplitude) / blurred
        ns = self._blur((hi_s - lo_s) * amplitude) / blurred
        mag = torch.sqrt(nc * nc + ns * ns)
        rot = torch.clamp(mag * self.p.amplification, max=self.p.threshold)
        pair = nan0((r * nc + i * ns) / mag)
        return lp * torch.cos(rot) - pair * torch.sin(rot), new_regs

    def step(self, frame_u8: torch.Tensor) -> torch.Tensor:
        """[3, H, W] u8 BGR -> [3, H, W] u8 BGR."""
        lab = bgr_to_lab(unit(frame_u8, self.dtype))
        cur = self.pyramid(lab[0])
        first = self.old is None
        if first:
            self.old = cur
            self.regs = [[torch.zeros_like(c[0]) for _ in range(10)] for c in cur[:-1]]
        bands = []
        for lvl in range(self.levels - 1):
            out, self.regs[lvl] = self._level(cur[lvl], self.old[lvl], self.regs[lvl])
            bands.append(out)
        result = cur[-1][0]
        for lvl in range(self.levels - 2, -1, -1):
            hw = bands[lvl].shape
            result = self._inject(result, hw) + correlate(bands[lvl], self._w("hp"))
        self.old = cur
        if first:
            return frame_u8.clone()
        return to_u8(lab_to_bgr(torch.stack([result, lab[1], lab[2]])))


# The class ``benchmark/harness/compare.py`` finds by the configuration's reference name.
Reference = PhaseReference
