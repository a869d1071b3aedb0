"""Color conversions matching OpenCV as the reference pipelines use it.

The counterpart of the reference package's ``ops/color.py``:

  * bgr_to_lab / lab_to_bgr: cv::cvtColor COLOR_BGR2Lab / COLOR_Lab2BGR on
    CV_32F, with the exact sRGB gamma curve and D65 white point;
  * bgr_to_gray_u8: cv::cvtColor COLOR_BGR2GRAY on CV_8U, OpenCV's 15-bit
    fixed point, bit-exact;
  * bgr_to_gray: cv::cvtColor COLOR_BGR2GRAY on CV_32F;
  * to_u8: cv::Mat::convertTo(CV_8U, alpha, beta), round half to even, then
    saturate; alpha and beta may be 0-d tensors (colour mode rescales by the
    output's own min and max without reading them back to the host).

Layout is planar [..., C, H, W] f32 in BGR order: leading dims (a clip's
time axis) pass through. PyTorch has no cube root, so the
CIE f(t) uses ``t ** (1/3)`` on t > 0.008856: a few f32 ulps from a true cube
root, below 1e-4 in L for L in [0, 100] (tests hold Lab to 2e-4 of the
reference package).
"""

from __future__ import annotations

import torch

_T0 = 0.008856  # CIE threshold
_T0_CBRT_SCALE = 7.787
_T0_OFFSET = 16.0 / 116.0
_L_THRESH = 903.3 * _T0  # == 7.99959...; L below this came from the linear branch
_INV_255_F32 = 0.003921568859368563  # float32(1/255), exactly


def _srgb_inverse_gamma(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((torch.abs(x) + 0.055) / 1.055, 2.4))


def _srgb_forward_gamma(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * torch.pow(torch.clamp(x, min=0.0), 1.0 / 2.4) - 0.055,
    )


def _cie_f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _T0, torch.pow(torch.clamp(t, min=0.0), 1.0 / 3.0),
                       _T0_CBRT_SCALE * t + _T0_OFFSET)


def bgr_to_lab(bgr: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] BGR float32 in [0,1] -> [..., 3, H, W] Lab (L 0..100, a/b signed)."""
    b, g, r = bgr.unbind(-3)
    r = _srgb_inverse_gamma(r)
    g = _srgb_inverse_gamma(g)
    b = _srgb_inverse_gamma(b)
    x = (0.412453 * r + 0.357580 * g + 0.180423 * b) / 0.950456
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / 1.088754
    fx, fy, fz = _cie_f(x), _cie_f(y), _cie_f(z)
    l_chan = torch.where(y > _T0, 116.0 * fy - 16.0, 903.3 * y)
    a_chan = 500.0 * (fx - fy)
    b_chan = 200.0 * (fy - fz)
    return torch.stack([l_chan, a_chan, b_chan], dim=-3)


def lab_to_bgr(lab: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] Lab float32 -> [..., 3, H, W] BGR (unclamped, like OpenCV's f32 path)."""
    l_chan, a_chan, b_chan = lab.unbind(-3)
    fy = (l_chan + 16.0) / 116.0
    y = torch.where(l_chan > _L_THRESH, fy * fy * fy, l_chan / 903.3)
    fy_eff = torch.where(l_chan > _L_THRESH, fy,
                         _T0_CBRT_SCALE * (l_chan / 903.3) + _T0_OFFSET)
    fx = a_chan / 500.0 + fy_eff
    fz = fy_eff - b_chan / 200.0
    fx3, fz3 = fx * fx * fx, fz * fz * fz
    x = torch.where(fx3 > _T0, fx3, (fx - _T0_OFFSET) / _T0_CBRT_SCALE) * 0.950456
    z = torch.where(fz3 > _T0, fz3, (fz - _T0_OFFSET) / _T0_CBRT_SCALE) * 1.088754
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875991 * y + 0.041556 * z
    b = 0.055648 * x - 0.204043 * y + 1.057311 * z
    return torch.stack(
        [_srgb_forward_gamma(b), _srgb_forward_gamma(g), _srgb_forward_gamma(r)], dim=-3
    )


def bgr_to_gray_u8(bgr_u8: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] uint8 BGR -> [..., 1, H, W] uint8 gray, bit-exact with
    OpenCV CV_8U: (R*9798 + G*19235 + B*3735 + (1<<14)) >> 15."""
    b, g, r = (c.to(torch.int32) for c in bgr_u8.unbind(-3))
    y = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
    return y.to(torch.uint8).unsqueeze(-3)


def to_u8(x: torch.Tensor, alpha: float | torch.Tensor = 1.0,
          beta: float | torch.Tensor = 0.0) -> torch.Tensor:
    """cv::Mat::convertTo(CV_8U, alpha, beta): rint (half to even) then saturate."""
    v = torch.round(x * alpha + beta)
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def u8_to_unit_f32(x_u8: torch.Tensor) -> torch.Tensor:
    """convertTo(CV_32F, 1/255): u8 -> [0,1] float32 (times float32(1/255))."""
    return x_u8.to(torch.float32) * _INV_255_F32


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """Float BGR -> gray (cv::cvtColor CV_32F weights), [3,H,W] -> [1,H,W]."""
    return (0.114 * bgr[0] + 0.587 * bgr[1] + 0.299 * bgr[2])[None]
