"""Pyramid sizing shared by the magnification modes.

Only :func:`calculate_max_levels` is ported so far; the Gaussian and Laplacian
pyramid ops of motion and color mode are still to come (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple


def calculate_max_levels(size_hw: Tuple[int, int]) -> int:
    """Max pyramid levels: halve (ceil) while both dims exceed 5 (SpatialFilter.cpp:5-11)."""
    h, w = size_hw
    levels = 0
    while w > 5 and h > 5:
        levels += 1
        h, w = (1 + h) // 2, (1 + w) // 2
    return levels
