"""The seeded synthetic clip every cell feeds, made on the device.

A colour texture of plane waves whose wavelengths span the pyramid's levels
(a few pixels to half the frame), moving by sub-pixel amounts at two
frequencies inside the configuration's band, with a locally pulsing patch
and a weak global brightness pulse: the signals motion and phase
magnification target (the pattern of the program's
``utils/synthetic.py``, widened to every scale). Every frequency is a whole
number of cycles over the clip, so the cycled clip has no seam.

The same seed gives the same frames: the draws come from a
``torch.Generator`` on the device, and the frames from a fixed sequence of
elementwise operations. The frames come back to the host as ordinary
(pageable) u8 arrays, as a decoder or camera would hand them over.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def make_clip(clip: dict, h: int, w: int, capture_fps: float, band_hz, seed: int,
              device, layout: str = "tchw") -> np.ndarray:
    """[n, 3, h, w] (``layout="tchw"``) or [n, h, w, 3] ("thwc") u8 BGR."""
    n, waves = int(clip["frames"]), int(clip["waves"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    rand = lambda *shape: torch.rand(shape, generator=g, device=device, dtype=torch.float64)

    lo_len, hi_len = math.log(clip["min_wavelength_px"]), math.log(0.5 * min(h, w))
    wavelength = torch.exp(lo_len + (hi_len - lo_len) * rand(3, waves))
    angle = 2.0 * math.pi * rand(3, waves)
    k = 2.0 * math.pi / wavelength
    kx, ky = k * torch.cos(angle), k * torch.sin(angle)
    amp = wavelength.sqrt() * (0.3 + 0.7 * rand(3, waves))
    amp = amp / amp.sum(dim=1, keepdim=True)
    offset = 2.0 * math.pi * rand(3, waves)

    # two motion frequencies and one pulse frequency, whole cycles over n frames
    lo_c = math.ceil(band_hz[0] * n / capture_fps)
    hi_c = max(lo_c, math.floor(band_hz[1] * n / capture_fps))
    cycles = (lo_c + torch.floor(rand(3) * (hi_c - lo_c + 1))).clamp(max=hi_c)
    freq = 2.0 * math.pi * cycles / n                       # radians per frame
    shift = clip["shift_px"] * (0.5 + 0.5 * rand(4))        # dx, dx2, dy, dy2 amplitudes
    kx, ky, amp, offset, freq, shift = (v.cpu().numpy() for v in (kx, ky, amp, offset, freq, shift))

    ys = torch.arange(h, device=device, dtype=torch.float64)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float64)[None, :]
    blob = torch.exp(-(((ys - h / 2) / (h / 6)) ** 2 + ((xs - w / 2) / (w / 6)) ** 2)).float()
    xs32, ys32 = xs.float(), ys.float()

    out_shape = (n, 3, h, w) if layout == "tchw" else (n, h, w, 3)
    frames = np.empty(out_shape, np.uint8)
    for t in range(n):
        dx = shift[0] * math.sin(freq[0] * t) + shift[1] * math.sin(freq[1] * t)
        dy = shift[2] * math.cos(freq[0] * t) + shift[3] * math.sin(freq[1] * t)
        pulse = math.sin(freq[2] * t)
        planes = []
        for c in range(3):
            img = torch.zeros((h, w), device=device, dtype=torch.float32)
            for j in range(waves):
                phase0 = float(offset[c, j] - kx[c, j] * dx - ky[c, j] * dy)
                img += float(amp[c, j]) * torch.sin(float(kx[c, j]) * xs32
                                                    + float(ky[c, j]) * ys32 + phase0)
            img = (0.5 + 0.35 * img) * (1.0 + clip["pulse"] * pulse * blob)
            planes.append(img * (1.0 + 0.3 * clip["pulse"] * pulse))
        frame = torch.round(torch.stack(planes) * 255.0).clamp(0, 255).to(torch.uint8)
        if layout != "tchw":
            frame = frame.permute(1, 2, 0)
        frames[t] = frame.cpu().numpy()
    return frames
