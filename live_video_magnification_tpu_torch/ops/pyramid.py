"""Gaussian / Laplacian pyramid ops matching OpenCV pyrDown/pyrUp numerics.

The counterpart of the reference package's ``ops/pyramid.py``
(SpatialFilter.cpp:5-61):

  * pyr_down == cv::pyrDown: 5-tap binomial blur, reflect-101, keep every
    even pixel (ceil-halved output size);
  * pyr_up == cv::pyrUp: zero-inject, 4x-scaled kernel, reflect-101 in the
    upsampled domain, optional odd output size;
  * build_gauss_pyr / build_laplace_pyr / collapse_laplace_pyr /
    reconstruct_from_gauss_level mirror buildGaussPyrFromImg /
    buildLaplacePyrFromImg / buildImgFromLaplacePyr / buildImgFromGaussPyr.

Tensors are [..., H, W] float (channels on leading dims); a pyramid is a
list of tensors, one per level. The taps are applied as shifted
multiply-adds in the reference's order (``ops/conv.py``), so each value is
the same sequence of f32 roundings.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from live_video_magnification_tpu_torch.ops.conv import _shifted_taps_sum, sep_correlate2d
from live_video_magnification_tpu_torch.ops.kernels import PYR_KERNEL_1D
from live_video_magnification_tpu_torch.ops.resize import resize_linear


def calculate_max_levels(size_hw: Tuple[int, int]) -> int:
    """Max pyramid levels: halve (ceil) while both dims exceed 5 (SpatialFilter.cpp:5-11)."""
    h, w = size_hw
    levels = 0
    while w > 5 and h > 5:
        levels += 1
        h, w = (1 + h) // 2, (1 + w) // 2
    return levels


def pyramid_sizes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    """Sizes of `levels` successive pyrDown outputs of an (h, w) image."""
    sizes = []
    for _ in range(levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        sizes.append((h, w))
    return sizes


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: binomial 5x5 blur (reflect-101) then take every even pixel."""
    return sep_correlate2d(x, PYR_KERNEL_1D, PYR_KERNEL_1D)[..., ::2, ::2]


def _upsample_axis(x: torch.Tensor, dim: int, out_len: int) -> torch.Tensor:
    """One axis of cv::pyrUp: zero-inject, correlate with the 2x-scaled 5-tap
    kernel, crop to out_len.

    The border reflects (101) in the upsampled domain: the zero-injected
    signal Z (src[i] at Z[2i], length 2n) reflects about its ends, so Z[-2]
    -> src[1] on the left and Z[2n] -> Z[2n-2] = src[n-1] on the right.
    Polyphase: even outputs take taps {k0, k2, k4}, odd outputs {k1, k3}. An
    odd out_len gets one dummy odd-phase row, dropped after interleaving."""
    taps2 = (2.0 * PYR_KERNEL_1D).tolist()  # per-axis factor 2 (4x in 2-D)
    n = x.shape[dim]
    padded = torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 1, 1)], dim=dim)
    n_even, n_odd = (out_len + 1) // 2, out_len // 2
    # even output 2i: t0*srcE[i-1] + t2*srcE[i] + t4*srcE[i+1]; odd 2i+1: t1*srcE[i] + t3*srcE[i+1]
    even = _shifted_taps_sum(padded, [taps2[0], taps2[2], taps2[4]], dim=dim, out_len=n_even)
    odd = _shifted_taps_sum(padded.narrow(dim, 1, n + 1), [taps2[1], taps2[3]], dim=dim,
                            out_len=n_odd)
    if n_even != n_odd:
        odd = torch.cat([odd, odd.narrow(dim, n_odd - 1, 1)], dim=dim)
    out = torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)
    return out.narrow(dim, 0, out_len)


def pyr_up(x: torch.Tensor, out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """cv::pyrUp to out_hw (default exactly 2x); out_hw may be (2h, 2w) or odd (2h-1, ...)."""
    if out_hw is None:
        out_hw = (2 * x.shape[-2], 2 * x.shape[-1])
    out = _upsample_axis(x, x.ndim - 1, out_hw[1])
    return _upsample_axis(out, out.ndim - 2, out_hw[0])


def build_gauss_pyr(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """`levels` successive pyrDowns; the original is not stored (SpatialFilter.cpp:13-23)."""
    pyr, cur = [], img
    for _ in range(levels):
        cur = pyr_down(cur)
        pyr.append(cur)
    return pyr


def build_laplace_pyr(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """`levels` difference images and the coarsest residual: levels+1 tensors
    (SpatialFilter.cpp:25-38)."""
    pyr, cur = [], img
    for _ in range(levels):
        down = pyr_down(cur)
        pyr.append(cur - pyr_up(down, (cur.shape[-2], cur.shape[-1])))
        cur = down
    pyr.append(cur)
    return pyr


def collapse_laplace_pyr(pyr: Sequence[torch.Tensor]) -> torch.Tensor:
    """Residual up + add per level, finest last (SpatialFilter.cpp:52-61)."""
    cur = pyr[-1]
    for lvl in range(len(pyr) - 2, -1, -1):
        cur = pyr_up(cur, (pyr[lvl].shape[-2], pyr[lvl].shape[-1])) + pyr[lvl]
    return cur


def reconstruct_from_gauss_level(level_img: torch.Tensor, levels: int,
                                 out_hw: Tuple[int, int]) -> torch.Tensor:
    """`levels` exact-2x pyrUps, then a bilinear resize that absorbs the
    rounding drift (SpatialFilter.cpp:40-50; identity at the same size)."""
    cur = level_img
    for _ in range(levels):
        cur = pyr_up(cur)
    return resize_linear(cur, out_hw)
