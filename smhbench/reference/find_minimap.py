"""Minimap-bounds detection: march a cross outward from the map centre.

Port of upstream src/vision/find_minimap.rs:9-146. Used to align
heightmaps with the on-screen minimap. Operates on the BGRA frame view of the
map ROI.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .geometry import Rect

EDGINESS_THRESHOLD = 0.01


def get_edginess(view: np.ndarray, x: int, y: int) -> float:
    """Max abs-diff (summed over B,G,R) to the 8 neighbours, / 765
    (find_minimap.rs:9-46)."""
    c = view[y, x, :3].astype(np.int16)
    best = 0
    for py in (y - 1, y, y + 1):
        for px in (x - 1, x, x + 1):
            if px == x and py == y:
                continue
            d = int(np.abs(c - view[py, px, :3].astype(np.int16)).sum())
            if d > best:
                best = d
    return best / 765.0


def find_minimap(view: np.ndarray) -> Optional[Rect]:
    """Find the minimap rectangle within the map ROI view (BGRA u8).

    From the centre, march each of the 4 directions to the first
    low-edginess pixel that begins a straight quiet line at least half the
    span long (find_minimap.rs:48-146). Returns None if any direction fails.
    """
    h, w = view.shape[:2]
    if w < 3 or h < 3:
        return None

    def find_edge(x0: int, y0: int, direction: str) -> Optional[int]:
        xy = [x0, y0]
        if direction == "up":
            c, c_max, oc, oc_max, cod = 1, h, 0, w, -1
        elif direction == "down":
            c, c_max, oc, oc_max, cod = 1, h, 0, w, 1
        elif direction == "left":
            c, c_max, oc, oc_max, cod = 0, w, 1, h, -1
        else:
            c, c_max, oc, oc_max, cod = 0, w, 1, h, 1

        min_line_length = abs(oc_max - xy[oc]) // 2 - 1
        c_max -= 3
        oc_max -= 3

        while True:
            xy[c] += cod
            if xy[c] > c_max:
                return c_max + 2
            if xy[c] < 3:
                return 0

            if get_edginess(view, xy[0], xy[1]) <= EDGINESS_THRESHOLD:
                ret = xy[c]
                wxy = list(xy)
                remaining = min_line_length
                ok = True
                while remaining > 0:
                    wxy[oc] -= cod
                    if wxy[oc] < 3 or wxy[oc] > oc_max:
                        ok = False
                        break
                    if get_edginess(view, wxy[0], wxy[1]) <= EDGINESS_THRESHOLD:
                        remaining -= 1
                    else:
                        ok = False
                        break
                if ok:
                    return ret - cod

    x, y = w // 2, h // 2
    left = find_edge(x, y, "left")
    right = find_edge(x, y, "right")
    top = find_edge(x, y, "up")
    bottom = find_edge(x, y, "down")

    if left is None or right is None or top is None or bottom is None:
        return None
    return Rect(left=left, top=top, right=right, bottom=bottom)
