"""Synthetic footage made with numpy from a seed, for tests and smoke runs.

A smooth colour texture (a few plane waves per channel) moving by sub-pixel
amounts at two frequencies, with a locally pulsing patch near the centre and
a weak global brightness oscillation: the signal classes phase magnification
targets. Each wave is separable (sin(a + b) = sin a cos b + cos a sin b), so a
4K frame costs a few outer products.
"""

from __future__ import annotations

import math

import numpy as np


FPS = 30.0
WAVES = 5  # plane waves per channel


def moving_clip(t: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """[t, h, w, 3] uint8 BGR frames at 30 fps."""
    rng = np.random.default_rng(seed)
    freq = rng.uniform(0.02, 0.15, (3, WAVES, 2)) * (64.0 / max(64.0, min(h, w)) ** 0.5)
    phase = rng.uniform(0.0, 2.0 * math.pi, (3, WAVES))
    amp = rng.uniform(0.3, 1.0, (3, WAVES))
    amp /= amp.sum(axis=1, keepdims=True)
    ys = np.arange(h, dtype=np.float64)
    xs = np.arange(w, dtype=np.float64)
    blob = np.exp(-(((ys[:, None] - h / 2) / (h / 6)) ** 2
                    + ((xs[None, :] - w / 2) / (w / 6)) ** 2)).astype(np.float32)
    frames = np.empty((t, h, w, 3), np.uint8)
    for i in range(t):
        ph = 2.0 * math.pi * i / FPS
        dx = 0.8 * math.sin(1.3 * ph) + 0.4 * math.sin(2.7 * ph)
        dy = 0.6 * math.cos(1.3 * ph) + 0.3 * math.sin(3.1 * ph)
        for c in range(3):
            img = np.zeros((h, w), np.float32)
            for k in range(WAVES):
                ax = (freq[c, k, 1] * (xs - dx) + phase[c, k]).astype(np.float32)
                by = (freq[c, k, 0] * (ys - dy)).astype(np.float32)
                img += amp[c, k] * (np.outer(np.sin(by), np.cos(ax))
                                    + np.outer(np.cos(by), np.sin(ax)))
            img = (0.5 + 0.35 * img) * (1.0 + 0.015 * math.sin(ph) * blob)
            img *= 1.0 + 0.008 * math.sin(1.2 * ph)
            frames[i, :, :, c] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return frames
