"""Pixel inspector: per-fireteam HSV predicate breakdown for debugging.

Counterpart of the reference's debug-UI pixel inspector
(/root/reference/src/ui/debug.rs:350-475), which shows a pixel's HSV and a
pass/fail breakdown of each fireteam's hue/sat/vib checks (via
debug_is_map_marker_color, vision-common/src/markers/mod.rs:26-38). Exposed
as a plain function so any surface (CLI, web debug endpoint, tests) can use
it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import consts as C
from . import pixmath as pm

FIRETEAMS = {
    "alpha": C.ALPHA_MARKER_COLOR_HSV,
    "bravo": C.BRAVO_MARKER_COLOR_HSV,
    "charlie": C.CHARLIE_MARKER_COLOR_HSV,
}


@dataclasses.dataclass(frozen=True)
class FireteamChecks:
    hue_ok: bool
    sat_ok: bool  # includes the player-direction-arc alternate band
    vib_ok: bool

    @property
    def passed(self) -> bool:
        return self.hue_ok and self.sat_ok and self.vib_ok


@dataclasses.dataclass(frozen=True)
class PixelInspection:
    rgb: tuple[int, int, int]
    h: int
    s: int
    v: int
    min_sat_ok: bool
    fireteams: dict[str, FireteamChecks]

    @property
    def is_marker(self) -> bool:
        return self.min_sat_ok and any(ft.passed for ft in self.fireteams.values())


def inspect_pixel(r: int, g: int, b: int) -> PixelInspection:
    rgb = np.array([[r, g, b]], dtype=np.uint8)
    h, s, v = pm.rgb_to_hsv_u8(rgb)
    h, s, v = int(h[0]), int(s[0]), int(v[0])

    fts = {}
    for name, (mh, ms, mv) in FIRETEAMS.items():
        sat_primary = abs(s - ms) <= C.FIND_MARKER_HSV_SAT_TOLERANCE
        sat_arc = abs(s - (ms - C.FIND_MARKER_PLAYER_DIR_ARC_SAT)) <= C.FIND_MARKER_HSV_SAT_TOLERANCE
        fts[name] = FireteamChecks(
            hue_ok=abs(h - mh) <= C.FIND_MARKER_HSV_HUE_TOLERANCE,
            sat_ok=sat_primary or sat_arc,
            vib_ok=abs(v - mv) <= C.FIND_MARKER_HSV_VIB_TOLERANCE,
        )

    return PixelInspection(
        rgb=(r, g, b),
        h=h,
        s=s,
        v=v,
        min_sat_ok=s >= C.FIND_MARKER_HSV_MIN_SAT,
        fireteams=fts,
    )


def inspect_frame_pixel(frame_bgra: np.ndarray, x: int, y: int) -> PixelInspection:
    b, g, r = (int(v) for v in frame_bgra[y, x, :3])
    return inspect_pixel(r, g, b)
