"""Golden-ratio HSV colour generation for visualisation
(ref psn::GenerateColors, psn_where/PSNWhere_Utils.cpp:536-560)."""

from __future__ import annotations

import colorsys

import numpy as np

_GOLDEN_RATIO_CONJUGATE = 0.618033988749895


def generate_colors(n: int, seed_hue: float = 0.0) -> np.ndarray:
    """[n, 3] float RGB colours, hues spaced by the golden-ratio conjugate
    so neighbouring ids stay visually distinct."""
    out = np.zeros((n, 3), np.float32)
    h = seed_hue
    for i in range(n):
        h = (h + _GOLDEN_RATIO_CONJUGATE) % 1.0
        out[i] = colorsys.hsv_to_rgb(h, 0.75, 0.95)
    return out
