"""Bresenham line plotting for debug renders and golden tests.

Counterpart of /root/reference/util/src/debug.rs:51-75.
"""

from __future__ import annotations

import numpy as np


def plot_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, value) -> None:
    """Draw a line into `img` (2D or 3D array) with Bresenham stepping."""
    h, w = img.shape[:2]
    dx = abs(x1 - x0)
    sx = 1 if x0 < x1 else -1
    dy = -abs(y1 - y0)
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    x, y = x0, y0
    while True:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = value
        if x == x1 and y == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x += sx
        if e2 <= dx:
            err += dx
            y += sy
