"""Image resize matching cv::resize as the phase chain uses it.

The counterpart of the reference package's ``ops/resize.py``:

  * resize_linear: cv::resize INTER_LINEAR (default), which absorbs the pyrUp
    rounding drift of colour mode's reconstruction (SpatialFilter.cpp:48);
    two matmuls with host-built weights in IEEE f32;
  * resize_area: cv::resize INTER_AREA shrink (the 1/2, 1/4, 1/8 preprocess
    downscale, PreprocessProcessor.cpp:37-41). Integer factors are an exact
    box average (reshape-mean); other factors are two matmuls with host-built
    weights, in IEEE f32 (``device.pin_ieee_f32``);
  * resize_nearest_even_inject: INTER_NEAREST upsample followed by zeroing
    all but the (even, even) pixels, the Riesz collapse upsampling
    (RieszPyramid.cpp:280-317).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def resize_matrix(src_len: int, dst_len: int, kind: str) -> np.ndarray:
    """[dst_len, src_len] row-stochastic resampling matrix ('linear' or 'area')."""
    m = np.zeros((dst_len, src_len), dtype=np.float64)
    if src_len == dst_len:
        np.fill_diagonal(m, 1.0)
        return m.astype(np.float32)
    scale = src_len / dst_len
    if kind == "linear":
        for x in range(dst_len):
            fx = (x + 0.5) * scale - 0.5
            sx = int(np.floor(fx))
            fx -= sx
            if sx < 0:
                sx, fx = 0, 0.0
            if sx >= src_len - 1:
                sx, fx = src_len - 2, 1.0
            if src_len == 1:
                m[x, 0] = 1.0
            else:
                m[x, sx] = 1.0 - fx
                m[x, sx + 1] = fx
    elif kind == "area":
        # Shrink-only area average: weight = overlap([j, j+1], [x*scale, (x+1)*scale)) / scale.
        for x in range(dst_len):
            fsx1 = x * scale
            fsx2 = fsx1 + scale
            cell = 1.0 / scale
            j0 = int(np.floor(fsx1))
            j1 = min(int(np.ceil(fsx2)), src_len)
            for j in range(j0, j1):
                overlap = min(j + 1, fsx2) - max(j, fsx1)
                if overlap > 0:
                    m[x, j] = overlap * cell
    else:
        raise ValueError(f"unknown resize kind {kind!r}")
    return m.astype(np.float32)


@lru_cache(maxsize=8)
def _device_matrix(src_len: int, dst_len: int, kind: str, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """resize_matrix on ``device``, copied there once: a host-to-device copy
    inside a step would synchronise the host with the card every frame. A
    4K-wide matrix is ~60 MB, so only a few are kept."""
    return torch.as_tensor(resize_matrix(src_len, dst_len, kind), dtype=dtype, device=device)


def _apply(x: torch.Tensor, out_hw: Tuple[int, int], kind: str) -> torch.Tensor:
    """out = R @ x @ C^T over the trailing two dims."""
    r = _device_matrix(x.shape[-2], out_hw[0], kind, x.dtype, x.device)
    c = _device_matrix(x.shape[-1], out_hw[1], kind, x.dtype, x.device)
    return torch.matmul(torch.matmul(r, x), c.T)


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv::resize INTER_LINEAR on [..., H, W] float; the same size is x itself."""
    if tuple(out_hw) == (x.shape[-2], x.shape[-1]):
        return x
    return _apply(x, out_hw, "linear")


def resize_area(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv::resize INTER_AREA (shrinking) on [..., H, W] float."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    if oh > 0 and ow > 0 and h % oh == 0 and w % ow == 0:
        fh, fw = h // oh, w // ow
        r = x.reshape(x.shape[:-2] + (oh, fh, ow, fw))
        return r.mean(dim=(-3, -1))
    return _apply(x, out_hw, "area")


def resize_nearest_even_inject(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """INTER_NEAREST to out_hw, then zero all but the (even, even) pixels.

    For out dims of 2n or 2n-1, nearest mapping sends output pixel (2i, 2j)
    to source (i, j), so the composite is direct zero-injection."""
    oh, ow = out_hw
    h2, w2 = x.shape[-2], x.shape[-1]
    n_even_h, n_even_w = (oh + 1) // 2, (ow + 1) // 2
    if n_even_h > h2 or n_even_w > w2:
        raise ValueError(f"inject target {out_hw} must be at most 2x the source {(h2, w2)}")
    out = x.new_zeros(x.shape[:-2] + (2 * n_even_h, 2 * n_even_w))
    out[..., 0::2, 0::2] = x[..., :n_even_h, :n_even_w]
    return out[..., :oh, :ow]
