"""Quality metrics, as the reference package's ``utils/metrics.py``."""

from __future__ import annotations

import math

import numpy as np


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    """Peak signal-to-noise ratio between two u8 images/clips (dB; 99 = equal)."""
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float((d * d).mean())
    if mse == 0.0:
        return 99.0
    return 10.0 * math.log10(255.0**2 / mse)
