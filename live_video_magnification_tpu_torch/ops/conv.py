"""2-D correlation with OpenCV BORDER_REFLECT_101 borders, in plain PyTorch.

The counterpart of the reference package's ``ops/conv.py`` (cv::filter2D /
cv::sepFilter2D: correlation, no kernel flip, centred anchor, reflect without
repeating the edge pixel). These are the plain versions of the stencil kernels
in ``ops/hopper/stencils.py``: shifted multiply-adds over a reflect-padded
array, summed in the reference's tap order (row by row, taps left to right,
zero taps skipped so a NaN meets the same taps). Each multiply and each add
rounds to f32, so the CUDA kernels, which do the same operations in the same
order without fused multiply-adds, agree with these bit for bit.

Layout is [..., H, W]; taps are static host values cast to the array's dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source indices of a reflect-101 padded axis of length n + 2*pad.

    Periodic with period 2(n-1), as numpy's ``mode="reflect"`` is for pads
    wider than the axis."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def reflect_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of the trailing two dims (gfedcb|abcdefgh|gfedcba)."""
    h, w = x.shape[-2], x.shape[-1]
    if pad_h:
        x = x.index_select(-2, reflect_index(h, pad_h, x.device))
    if pad_w:
        x = x.index_select(-1, reflect_index(w, pad_w, x.device))
    return x


def _shifted_taps_sum(padded: torch.Tensor, taps, dim: int, out_len: int) -> torch.Tensor:
    """Valid correlation along ``dim`` of a padded array via shifted multiply-adds."""
    acc = None
    for k, w in enumerate(taps):
        if w == 0.0:
            continue
        term = padded.narrow(dim, k, out_len) * float(np.float32(w))
        acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(padded.narrow(dim, 0, out_len))
    return acc


def sep_correlate2d(x: torch.Tensor, kr, kc) -> torch.Tensor:
    """Separable correlation: kr along rows (H), kc along columns (W), reflect-101."""
    kr = np.asarray(kr, dtype=np.float64)
    kc = np.asarray(kc, dtype=np.float64)
    h, w = x.shape[-2], x.shape[-1]
    out = reflect_pad(x, len(kr) // 2, len(kc) // 2)
    out = _shifted_taps_sum(out, kc.tolist(), dim=out.ndim - 1, out_len=w)
    out = _shifted_taps_sum(out, kr.tolist(), dim=out.ndim - 2, out_len=h)
    return out


def correlate2d(x: torch.Tensor, kernel) -> torch.Tensor:
    """Dense 2-D correlation with a static [kh, kw] kernel, reflect-101 border."""
    k = np.asarray(kernel, dtype=np.float64)
    kh, kw = k.shape
    h, w = x.shape[-2], x.shape[-1]
    padded = reflect_pad(x, kh // 2, kw // 2)
    acc = None
    for i in range(kh):
        row = padded.narrow(padded.ndim - 2, i, h)
        term = _shifted_taps_sum(row, k[i].tolist(), dim=row.ndim - 1, out_len=w)
        acc = term if acc is None else acc + term
    return acc


def correlate_rows(x: torch.Tensor, taps) -> torch.Tensor:
    """1-D correlation along W (a horizontal 1xK cv::filter2D), reflect-101."""
    taps = np.asarray(taps, dtype=np.float64)
    padded = reflect_pad(x, 0, len(taps) // 2)
    return _shifted_taps_sum(padded, taps.tolist(), dim=x.ndim - 1, out_len=x.shape[-1])


def correlate_cols(x: torch.Tensor, taps) -> torch.Tensor:
    """1-D correlation along H (a vertical Kx1 cv::filter2D), reflect-101."""
    taps = np.asarray(taps, dtype=np.float64)
    padded = reflect_pad(x, len(taps) // 2, 0)
    return _shifted_taps_sum(padded, taps.tolist(), dim=x.ndim - 2, out_len=x.shape[-2])
