"""Meters-per-pixel ratio from the OCR'd map scale bars.

Port of upstream src/vision/mpx_ratio.rs:3-134. For every OCR'd
"<N>m" text, scan downward from the text bottom for the |----| scale bar,
walk right/left requiring a 4-px vertical black bar at each end, and average
meters/width over the scales found. Faithful quirks preserved:

  * the "upward" half of the vertical-bar check is an empty Rust range
    (y..y-4), so only the 4 pixels downward are actually checked;
  * the scan-down budget is round((20/640) * image_width);
  * right end = first qualifying column minus 1; left end = first qualifying
    column (scanning leftward) plus 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .geometry import Line, Point

MIN_SCALE_WIDTH = 10
MIN_SCALE_VERTICAL_BAR_HEIGHT = 4


def _round_half_up(v: float) -> int:
    return int(v + 0.5)


def find_scale_width(
    meters: int,
    xy: tuple[int, int],
    image: np.ndarray,
    debug_out: Optional[list] = None,
) -> Optional[float]:
    x, y0 = xy
    h, w = image.shape

    if y0 < MIN_SCALE_VERTICAL_BAR_HEIGHT:
        return None

    max_scale_y_offset = _round_half_up((20.0 / 640.0) * w)

    def bar_black(bx: int, by: int) -> bool:
        # (y..y+4) downward; the upward chain in the reference is empty.
        if by + MIN_SCALE_VERTICAL_BAR_HEIGHT > h:
            return False
        return bool((image[by : by + MIN_SCALE_VERTICAL_BAR_HEIGHT, bx] == 0).all())

    for y in range(y0, min(h, y0 + max_scale_y_offset)):
        if x >= w or image[y, x] != 0:
            continue

        right = 0
        for rx in range(x, w):
            if bar_black(rx, y):
                right = rx
                break
        if right == 0:
            continue
        right -= 1

        left = 0
        for lx in range(x - 1, -1, -1):
            if bar_black(lx, y):
                left = lx
                break
        if left == 0:
            continue
        left += 1

        width = right - left
        if width < MIN_SCALE_WIDTH:
            continue

        if debug_out is not None:
            debug_out.append((meters, Line(Point(float(left), float(y)), Point(float(right), float(y)))))

        return meters / width

    return None


def calc_meters_to_px_ratio(
    scales: list[tuple[int, tuple[int, int]]],
    image: np.ndarray,
    debug_out: Optional[list] = None,
) -> Optional[float]:
    """Average meters/px over <=3 detected scales (mpx_ratio.rs:78-133)."""
    if not scales:
        return None
    found = [
        r
        for r in (find_scale_width(m, xy, image, debug_out) for m, xy in scales)
        if r is not None
    ]
    if not found:
        return None
    return sum(found) / len(found)
