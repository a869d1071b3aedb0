"""Shared pieces of the plain reference: colour conversion, rounding to u8,
the filter taps and correlation with OpenCV's BORDER_REFLECT_101.

Plain PyTorch, written from the published formulas (OpenCV's cvtColor
BGR<->Lab on float images with the sRGB gamma and the D65 white point,
convertTo's round-half-to-even and saturation), with no code of the program.
Correlation goes through ``torch.nn.functional.conv2d`` (no kernel flip, like
cv::filter2D) on a reflect-padded plane; the caller sets TF32 off, so a
float32 reference computes in IEEE float32 throughout.

Every function takes planes of any float dtype: the bfloat16 control runs
the same code on bfloat16 tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Taps of the reference app's filters (SpatialFilter.cpp, RieszPyramid.cpp,
# Wadhwa et al., ICCP 2014).
BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
RIESZ_BAND = np.array([-0.2, -0.48, 0.0, 0.48, 0.2], dtype=np.float32)
LOWPASS9 = np.array([
    [-0.0001, -0.0007, -0.0023, -0.0046, -0.0057, -0.0046, -0.0023, -0.0007, -0.0001],
    [-0.0007, -0.0030, -0.0047, -0.0025, -0.0003, -0.0025, -0.0047, -0.0030, -0.0007],
    [-0.0023, -0.0047, 0.0054, 0.0272, 0.0387, 0.0272, 0.0054, -0.0047, -0.0023],
    [-0.0046, -0.0025, 0.0272, 0.0706, 0.0910, 0.0706, 0.0272, -0.0025, -0.0046],
    [-0.0057, -0.0003, 0.0387, 0.0910, 0.1138, 0.0910, 0.0387, -0.0003, -0.0057],
    [-0.0046, -0.0025, 0.0272, 0.0706, 0.0910, 0.0706, 0.0272, -0.0025, -0.0046],
    [-0.0023, -0.0047, 0.0054, 0.0272, 0.0387, 0.0272, 0.0054, -0.0047, -0.0023],
    [-0.0007, -0.0030, -0.0047, -0.0025, -0.0003, -0.0025, -0.0047, -0.0030, -0.0007],
    [-0.0001, -0.0007, -0.0023, -0.0046, -0.0057, -0.0046, -0.0023, -0.0007, -0.0001],
], dtype=np.float32)
HIGHPASS9 = np.array([
    [0.0000, 0.0003, 0.0011, 0.0022, 0.0027, 0.0022, 0.0011, 0.0003, 0.0000],
    [0.0003, 0.0020, 0.0059, 0.0103, 0.0123, 0.0103, 0.0059, 0.0020, 0.0003],
    [0.0011, 0.0059, 0.0151, 0.0249, 0.0292, 0.0249, 0.0151, 0.0059, 0.0011],
    [0.0022, 0.0103, 0.0249, 0.0402, 0.0469, 0.0402, 0.0249, 0.0103, 0.0022],
    [0.0027, 0.0123, 0.0292, 0.0469, -0.9455, 0.0469, 0.0292, 0.0123, 0.0027],
    [0.0022, 0.0103, 0.0249, 0.0402, 0.0469, 0.0402, 0.0249, 0.0103, 0.0022],
    [0.0011, 0.0059, 0.0151, 0.0249, 0.0292, 0.0249, 0.0151, 0.0059, 0.0011],
    [0.0003, 0.0020, 0.0059, 0.0103, 0.0123, 0.0103, 0.0059, 0.0020, 0.0003],
    [0.0000, 0.0003, 0.0011, 0.0022, 0.0027, 0.0022, 0.0011, 0.0003, 0.0000],
], dtype=np.float32)


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel: normalised exp(-(i - c)^2 / (2 sigma^2))."""
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return k / k.sum()


BLUR13 = gaussian_taps(13, 3.0)  # GaussianBlur(13x13, sigma 3) of the amplitudes


def disable_tf32() -> None:
    """IEEE float32 in every matmul and convolution of this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Taps:
    """Filter weights as conv2d operands of one dtype on one device."""

    def __init__(self, device, dtype):
        self.device, self.dtype = device, dtype
        self._cache = {}

    def get(self, key: str, k: np.ndarray) -> torch.Tensor:
        if key not in self._cache:
            w = torch.as_tensor(np.asarray(k, np.float32), device=self.device)
            self._cache[key] = w.to(self.dtype).reshape(1, 1, *w.shape[-2:])
        return self._cache[key]


def correlate(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """[H, W] (or [C, H, W]) correlated with a [1, 1, kh, kw] kernel,
    reflect-101 borders; ``stride`` 2 keeps every even row and column."""
    kh, kw = w.shape[-2:]
    planes = x.reshape(-1, 1, *x.shape[-2:])
    padded = F.pad(planes, (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    out = F.conv2d(padded, w, stride=stride)
    return out.reshape(*x.shape[:-2], *out.shape[-2:])


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c.abs() + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.0031308, 12.92 * c, 1.055 * c.clamp(min=0.0) ** (1.0 / 2.4) - 0.055)


def _f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0.008856, t.clamp(min=0.0) ** (1.0 / 3.0), 7.787 * t + 16.0 / 116.0)


def bgr_to_lab(bgr: torch.Tensor) -> torch.Tensor:
    """[3, H, W] BGR in [0, 1] -> [3, H, W] L*a*b* (L in 0..100)."""
    b, g, r = (srgb_to_linear(c) for c in bgr.unbind(0))
    x = (0.412453 * r + 0.357580 * g + 0.180423 * b) / 0.950456
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / 1.088754
    fx, fy, fz = _f(x), _f(y), _f(z)
    light = torch.where(y > 0.008856, 116.0 * fy - 16.0, 903.3 * y)
    return torch.stack([light, 500.0 * (fx - fy), 200.0 * (fy - fz)])


def lab_to_bgr(lab: torch.Tensor) -> torch.Tensor:
    """[3, H, W] L*a*b* -> [3, H, W] BGR, unclamped."""
    light, a, b = lab.unbind(0)
    linear = light > 903.3 * 0.008856
    fy = (light + 16.0) / 116.0
    y = torch.where(linear, fy * fy * fy, light / 903.3)
    fy = torch.where(linear, fy, 7.787 * (light / 903.3) + 16.0 / 116.0)
    fx, fz = a / 500.0 + fy, fy - b / 200.0
    inv = lambda t: torch.where(t * t * t > 0.008856, t * t * t, (t - 16.0 / 116.0) / 7.787)
    x, z = inv(fx) * 0.950456, inv(fz) * 1.088754
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875991 * y + 0.041556 * z
    bl = 0.055648 * x - 0.204043 * y + 1.057311 * z
    return torch.stack([linear_to_srgb(bl), linear_to_srgb(g), linear_to_srgb(r)])


def unit(frame_u8: torch.Tensor, dtype) -> torch.Tensor:
    """u8 -> [0, 1] as convertTo(CV_32F, 1/255): times float32(1/255)."""
    return frame_u8.to(dtype) * float(np.float32(1.0 / 255.0))


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """convertTo(CV_8U, 255, 1/255): round half to even, saturate."""
    return torch.round(x * 255.0 + 1.0 / 255.0).clamp(0.0, 255.0).to(torch.uint8)
