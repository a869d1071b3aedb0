"""Fixed filter-bank constants of the magnification pipelines.

The same values as the reference package's ``ops/kernels.py`` (the
reference app's filters, SpatialFilter.cpp:13-61, RieszPyramid.cpp:71-72 and
:146-167, the last taken from Wadhwa et al., ICCP 2014):

  * the 5-tap binomial pyramid kernel of cv::pyrDown / cv::pyrUp;
  * the Riesz band kernel [-0.2, -0.48, 0, 0.48, 0.2] and its transpose;
  * the 9x9 low-pass (applied as 2*LP9, exact in f32) and high-pass filters;
  * cv::getGaussianKernel-compatible taps for the 13x13 sigma=3 amplitude blur.
"""

from __future__ import annotations

import numpy as np

# OpenCV pyramid kernel: outer([1,4,6,4,1]/16). pyrDown correlates with K, pyrUp with 4*K.
PYR_KERNEL_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float64) / 16.0

RIESZ_BAND_KERNEL = np.array([-0.2, -0.48, 0.0, 0.48, 0.2], dtype=np.float32)

RIESZ_LOWPASS_9x9 = np.array(
    [
        [-0.0001, -0.0007, -0.0023, -0.0046, -0.0057, -0.0046, -0.0023, -0.0007, -0.0001],
        [-0.0007, -0.0030, -0.0047, -0.0025, -0.0003, -0.0025, -0.0047, -0.0030, -0.0007],
        [-0.0023, -0.0047,  0.0054,  0.0272,  0.0387,  0.0272,  0.0054, -0.0047, -0.0023],
        [-0.0046, -0.0025,  0.0272,  0.0706,  0.0910,  0.0706,  0.0272, -0.0025, -0.0046],
        [-0.0057, -0.0003,  0.0387,  0.0910,  0.1138,  0.0910,  0.0387, -0.0003, -0.0057],
        [-0.0046, -0.0025,  0.0272,  0.0706,  0.0910,  0.0706,  0.0272, -0.0025, -0.0046],
        [-0.0023, -0.0047,  0.0054,  0.0272,  0.0387,  0.0272,  0.0054, -0.0047, -0.0023],
        [-0.0007, -0.0030, -0.0047, -0.0025, -0.0003, -0.0025, -0.0047, -0.0030, -0.0007],
        [-0.0001, -0.0007, -0.0023, -0.0046, -0.0057, -0.0046, -0.0023, -0.0007, -0.0001],
    ],
    dtype=np.float32,
)

RIESZ_HIGHPASS_9x9 = np.array(
    [
        [0.0000, 0.0003, 0.0011, 0.0022, 0.0027, 0.0022, 0.0011, 0.0003, 0.0000],
        [0.0003, 0.0020, 0.0059, 0.0103, 0.0123, 0.0103, 0.0059, 0.0020, 0.0003],
        [0.0011, 0.0059, 0.0151, 0.0249, 0.0292, 0.0249, 0.0151, 0.0059, 0.0011],
        [0.0022, 0.0103, 0.0249, 0.0402, 0.0469, 0.0402, 0.0249, 0.0103, 0.0022],
        [0.0027, 0.0123, 0.0292, 0.0469, -0.9455, 0.0469, 0.0292, 0.0123, 0.0027],
        [0.0022, 0.0103, 0.0249, 0.0402, 0.0469, 0.0402, 0.0249, 0.0103, 0.0022],
        [0.0011, 0.0059, 0.0151, 0.0249, 0.0292, 0.0249, 0.0151, 0.0059, 0.0011],
        [0.0003, 0.0020, 0.0059, 0.0103, 0.0123, 0.0103, 0.0059, 0.0020, 0.0003],
        [0.0000, 0.0003, 0.0011, 0.0022, 0.0027, 0.0022, 0.0011, 0.0003, 0.0000],
    ],
    dtype=np.float32,
)

# The pyramid applies the low-pass as 2*LP9 (exact in f32: a power-of-two scale).
LOWPASS_2X = 2.0 * RIESZ_LOWPASS_9x9


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel(ksize, sigma): normalized exp(-(i-c)^2 / (2*sigma^2))."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) * 0.5
    i = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((i - c) ** 2) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k


# GaussianBlur(13x13, sigma=3) of the amplitudes and sepFilter2D of the phase
# normalization use the same 13 taps (RieszPyramid.cpp:110, :114-127).
AMPLITUDE_BLUR_KERNEL_1D = gaussian_kernel_1d(13, 3.0)
