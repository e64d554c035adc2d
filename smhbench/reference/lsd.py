"""Line-segment detection: host-side seed scan shared by all backends.

The scan is inherently sequential (each accepted line suppresses later seed
pixels); the backend supplies `find_longest_line`.

Parity citations:
  * seed scan + suppression + acceptance: upstream vision-common/src/lsd.rs:60-107
  * centre snapping:                      upstream vision-common/src/lsd.rs:5-44
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from . import consts as C
from .geometry import Line, Point

# find_longest_line(mask_u8, pt, max_gap) -> (Line, length_sqr)
FindLongestLine = Callable[[np.ndarray, Point, float], tuple[Line, float]]


def get_centre(mask: np.ndarray, pt: Point) -> Point:
    """Snap a seed point to the centre of its white blob (lsd.rs:5-44).

    Walks <= LSD_CENTRE_MAX_DIST px in each direction while pixels are 255;
    the result averages the first *failing* positions. Pixel lookups truncate
    the float coordinates. Out-of-bounds reads count as non-white (the
    reference uses unchecked reads here and simply never hits this in
    practice; checking is the safe equivalent).
    """
    h, w = mask.shape
    max_dist = C.LSD_CENTRE_MAX_DIST

    yi = int(pt.y)
    xi = int(pt.x)

    def white(x: int, y: int) -> bool:
        return 0 <= x < w and 0 <= y < h and mask[y, x] == 255

    left = pt.x
    while left > 0.0 and abs(left - pt.x) < max_dist and white(int(left), yi):
        left -= 1.0

    right = pt.x
    while right < float(w - 1) and abs(right - pt.x) < max_dist and white(int(right), yi):
        right += 1.0

    up = pt.y
    while up > 0.0 and abs(up - pt.y) < max_dist and white(xi, int(up)):
        up -= 1.0

    down = pt.y
    while down < float(h - 1) and abs(down - pt.y) < max_dist and white(xi, int(down)):
        down += 1.0

    return Point((left + right) / 2.0, (up + down) / 2.0)


def find_lines(
    mask: np.ndarray,
    max_gap: int,
    find_longest_line: FindLongestLine,
    max_lines: int = C.LSD_MAX_LINES,
    find_longest_lines_batch=None,
    batch_size: int = 8,
) -> list[Line]:
    """Row-major seed scan with suppression near accepted lines.

    Semantics match lsd.rs:60-107: a white (==255) pixel is skipped if its
    squared distance to the *infinite* line through any accepted segment is
    < LSD_DEDUP_DIST_SQR; otherwise it is centre-snapped and ray-marched, and
    the longest ray is accepted if its squared length > LSD_MIN_LENGTH_SQR.

    The per-pixel loop is vectorized: candidates are the white pixels in
    row-major order, and suppression is applied to the whole candidate set
    each time a line is accepted (equivalent to the reference's lazy check,
    because suppression only depends on lines accepted before the pixel is
    visited).
    """
    if max_lines == 0:
        return []

    max_gap_f = float(max_gap)

    ys, xs = np.nonzero(mask == 255)
    if ys.size == 0:
        return []
    cx = xs.astype(np.float64)
    cy = ys.astype(np.float64)
    alive = np.ones(ys.size, dtype=bool)

    def suppress(line: Line) -> None:
        dx = float(line.p1.x) - float(line.p0.x)
        dy = float(line.p1.y) - float(line.p0.y)
        denom = dx * dx + dy * dy
        if denom == 0.0:
            nx = np.full_like(cx, float(line.p0.x))
            ny = np.full_like(cy, float(line.p0.y))
        else:
            u = ((cx - float(line.p0.x)) * dx + (cy - float(line.p0.y)) * dy) / denom
            nx = float(line.p0.x) + u * dx
            ny = float(line.p0.y) + u * dy
        d2 = (cx - nx) ** 2 + (cy - ny) ** 2
        alive[d2 < C.LSD_DEDUP_DIST_SQR] = False

    lines: list[Line] = []
    n = ys.size

    if find_longest_lines_batch is None:
        i = 0
        while i < n:
            if not alive[i]:
                i += 1
                continue
            alive[i] = False
            pt = Point(float(xs[i]), float(ys[i]))
            pt = get_centre(mask, pt)

            longest, max_length = find_longest_line(mask, pt, max_gap_f)

            if max_length > C.LSD_MIN_LENGTH_SQR:
                longest = Line(longest.p0, get_centre(mask, longest.p1))
                lines.append(longest)
                if len(lines) == max_lines:
                    break
                suppress(longest)
            i += 1
        return lines

    # Speculative seed batching: march the next `batch_size` unsuppressed
    # candidates in ONE device dispatch, then replay acceptance/suppression
    # sequentially on the results. A candidate suppressed by a line accepted
    # earlier *within the batch* is simply discarded — the oracle would have
    # skipped it before marching, and marching is pure, so outcomes and
    # ordering are identical to the sequential scan.
    i = 0
    while i < n and len(lines) < max_lines:
        batch_idx: list[int] = []
        j = i
        while j < n and len(batch_idx) < batch_size:
            if alive[j]:
                batch_idx.append(j)
            j += 1
        if not batch_idx:
            break

        pts = [get_centre(mask, Point(float(xs[k]), float(ys[k]))) for k in batch_idx]
        results = find_longest_lines_batch(mask, pts, max_gap_f)

        for k, (longest, max_length) in zip(batch_idx, results):
            if not alive[k]:
                continue  # suppressed by an earlier in-batch acceptance
            alive[k] = False
            if max_length > C.LSD_MIN_LENGTH_SQR:
                longest = Line(longest.p0, get_centre(mask, longest.p1))
                lines.append(longest)
                if len(lines) == max_lines:
                    break
                suppress(longest)
        i = j

    return lines
