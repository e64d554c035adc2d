"""Firing solutions: distance / altitude delta / bearing / milliradians.

This is the map-space port of the marker overlay math in
the reference's src/ui/markers.rs:23-214 (the reference computes it in
viewport space; all the ratios are invariant under the viewport's affine
transform, so map-pixel space gives identical results) plus the
meters-from-ratio fallback of src/ui/mod.rs:124-141. The reference's JS
client mirrors the same math (web/www/map.js, squadex.js).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..geometry import Line, Rect
from . import milliradians
from .heightmaps import Heightmap


@dataclasses.dataclass(frozen=True)
class Solution:
    meters: float
    alt_delta: Optional[float]  # None when no heightmap is in play
    bearing_fwd: float
    bearing_bck: float
    mil_fwd: float  # NaN => out of range ("RANGE!")
    mil_bck: float


def bearings(line: Line) -> tuple[float, float]:
    """Forward/backward compass bearings of a marker line
    (markers.rs:98-110)."""
    angle = math.atan2(line.p0.y - line.p1.y, line.p0.x - line.p1.x)
    bearing_fwd = math.degrees(angle)
    if bearing_fwd > 0.0:
        bearing_fwd -= 90.0
        if bearing_fwd < 0.0:
            bearing_fwd += 360.0
    else:
        bearing_fwd += 270.0
    bearing_fwd = _round_half_away(bearing_fwd) % 360.0
    bearing_bck = _round_half_away(bearing_fwd + 180.0) % 360.0
    return bearing_fwd, bearing_bck


def _round_half_away(v: float) -> float:
    # Rust f32/f64::round rounds half away from zero (Python's round() is
    # banker's rounding and would diverge on exact .5 values).
    return math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)


def heightmap_meters(
    line: Line,
    minimap_bounds: Rect,
    hm: Heightmap,
    fit_to_minimap: bool,
) -> Optional[tuple[float, float]]:
    """(meters, alt_delta) through the heightmap, or None if either endpoint
    projects outside it (markers.rs:37-91)."""
    if fit_to_minimap:
        off_x, off_y = 0.0, 0.0
    else:
        bx = float(hm.bounds[0][0])
        by = float(hm.bounds[0][1])
        sf_w = minimap_bounds.width() / (hm.width + bx)
        sf_h = minimap_bounds.height() / (hm.height + by)
        off_x = bx * sf_w
        off_y = by * sf_h

    left = minimap_bounds.left + off_x
    top = minimap_bounds.top + off_y
    vw = minimap_bounds.right - left
    vh = minimap_bounds.bottom - top
    if vw <= 0 or vh <= 0:
        return None

    p0x = (line.p0.x - left) / vw * hm.width
    p0y = (line.p0.y - top) / vh * hm.height
    p1x = (line.p1.x - left) / vw * hm.width
    p1y = (line.p1.y - top) / vh * hm.height

    meters = math.sqrt((p0x - p1x) ** 2 + (p0y - p1y) ** 2)

    # Rust f64::round semantics (half away from zero), markers.rs:74-77.
    i0x, i0y = int(_round_half_away(p0x)), int(_round_half_away(p0y))
    i1x, i1y = int(_round_half_away(p1x)), int(_round_half_away(p1y))
    if not (
        0 <= i0x < hm.width
        and 0 <= i0y < hm.height
        and 0 <= i1x < hm.width
        and 0 <= i1y < hm.height
    ):
        return None

    alt_delta = hm.height_at(i1x, i1y) - hm.height_at(i0x, i0y)
    return meters, alt_delta


def solve(
    line: Line,
    meters_to_px_ratio: Optional[float] = None,
    minimap_bounds: Optional[Rect] = None,
    heightmap: Optional[Heightmap] = None,
    fit_to_minimap: bool = False,
) -> Optional[Solution]:
    """Full firing solution for a marker line in map-pixel coordinates.

    Prefers heightmap-derived distance/altitude when available, falling back
    to scale-ratio distance (src/ui/mod.rs:131-139); returns None when
    neither source can produce a distance.
    """
    meters: Optional[float] = None
    alt_delta: Optional[float] = None

    if minimap_bounds is not None and heightmap is not None:
        hm_result = heightmap_meters(line, minimap_bounds, heightmap, fit_to_minimap)
        if hm_result is not None:
            meters, alt_delta = hm_result

    if meters is None and meters_to_px_ratio is not None:
        meters = line.length() * meters_to_px_ratio

    if meters is None:
        return None

    bearing_fwd, bearing_bck = bearings(line)
    ad = alt_delta if alt_delta is not None else 0.0
    return Solution(
        meters=meters,
        alt_delta=alt_delta,
        bearing_fwd=bearing_fwd,
        bearing_bck=bearing_bck,
        mil_fwd=milliradians.calc(meters, ad),
        mil_bck=milliradians.calc(meters, -ad),
    )
