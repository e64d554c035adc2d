"""Mortar ballistics: meters + altitude delta -> milliradians.

Port of the reference's src/squadex/milliradians.rs:1-9. Returns NaN when the
target is out of range (the UI renders that as "RANGE!",
src/ui/markers.rs:142-147).
"""

from __future__ import annotations

import math

GRAVITY = 9.8
VELOCITY = 109.890938


def calc(meters: float, alt_delta: float) -> float:
    """Firing angle in milliradians (6400 mil = 360 deg)."""
    disc = VELOCITY**4 - GRAVITY * (GRAVITY * meters**2 + 2.0 * alt_delta * VELOCITY**2)
    if disc < 0.0:
        return math.nan  # Rust: sqrt of negative -> NaN propagates
    p1 = math.sqrt(disc)
    denom = GRAVITY * meters
    if denom == 0.0:
        # Rust: x/0.0 = +inf, atan(+inf) = pi/2 (straight up)
        a1 = math.pi / 2.0
    else:
        a1 = math.atan((VELOCITY**2 + p1) / denom)
    return math.degrees(a1) / (360.0 / 6400.0)
