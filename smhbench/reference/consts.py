"""Typed constants loaded from consts.toml, and the screen-relative ROIs.

A frozen copy of the port's constants for the benchmark's plain reference:
the values mirror the reference's tunables
(vision-common/src/consts/consts.toml:1-67) and its screen ROI arithmetic
(vision-common/src/screen.rs:4-67, vision-common/src/consts/mod.rs:7-19).
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys
import tomllib
from typing import Union

_HERE = pathlib.Path(__file__).resolve().parent

def _load_raw() -> dict:
    with open(_HERE / "consts.toml", "rb") as f:
        return tomllib.load(f)


_RAW = _load_raw()

# Export every constant as a module attribute (ints stay ints, f32/f64 floats,
# arrays become tuples).
_this = sys.modules[__name__]
for _name, _spec in _RAW.items():
    _value = _spec["value"]
    if isinstance(_value, list):
        _value = tuple(_value)
    setattr(_this, _name, _value)


# ---------------------------------------------------------------------------
# Screen-relative bounds DSL.
#
# A bound is a fraction of the screen width or height; corner-anchored 2D
# bounds resolve to absolute [x, y, w, h] pixels. Semantics (rounding via
# f64 round-half-away-from-zero, Right/Bottom anchoring) follow
# upstream vision-common/src/screen.rs:10-65.
# ---------------------------------------------------------------------------


def _round_half_up(v: float) -> int:
    # Rust f64::round rounds half away from zero; Python round() is
    # banker's rounding, so do it explicitly. All our values are positive.
    return int(v + 0.5)


@dataclasses.dataclass(frozen=True)
class ScreenW:
    frac: float

    def absolute(self, screen_w: int, screen_h: int) -> int:
        return _round_half_up(self.frac * screen_w)


@dataclasses.dataclass(frozen=True)
class ScreenH:
    frac: float

    def absolute(self, screen_w: int, screen_h: int) -> int:
        return _round_half_up(self.frac * screen_h)


RelBound = Union[ScreenW, ScreenH]


@dataclasses.dataclass(frozen=True)
class Left:
    bound: RelBound


@dataclasses.dataclass(frozen=True)
class Right:
    bound: RelBound


@dataclasses.dataclass(frozen=True)
class Top:
    bound: RelBound


@dataclasses.dataclass(frozen=True)
class Bottom:
    bound: RelBound


@dataclasses.dataclass(frozen=True)
class RelativeBounds2D:
    """Corner-anchored relative rectangle -> absolute [x, y, w, h]."""

    x: Union[Left, Right]
    y: Union[Top, Bottom]
    w: RelBound
    h: RelBound

    def into_absolute(self, screen_w: int, screen_h: int) -> tuple[int, int, int, int]:
        w = self.w.absolute(screen_w, screen_h)
        h = self.h.absolute(screen_w, screen_h)
        if isinstance(self.x, Left):
            x = self.x.bound.absolute(screen_w, screen_h)
        else:
            x = screen_w - self.x.bound.absolute(screen_w, screen_h) - w
        if isinstance(self.y, Top):
            y = self.y.bound.absolute(screen_w, screen_h)
        else:
            y = screen_h - self.y.bound.absolute(screen_w, screen_h) - h
        return (x, y, w, h)


# The in-game deployment map ROI. NOTE: consumers treat `w` as "space NOT
# occupied by the map": the map's real width is screen_w - w and its real x is
# screen_w - x - (screen_w - w)  (see vision-cpu/src/lib.rs:71-75,137-141).
# Use map_geometry() below, which resolves all of that.
MAP_BOUNDS = RelativeBounds2D(
    x=Left(ScreenH(0.018522135)),
    y=Bottom(ScreenH(0.07421875)),
    w=ScreenH(0.864930556),
    h=ScreenH(0.761078559),
)

CLOSE_DEPLOYMENT_BUTTON_BOUNDS = RelativeBounds2D(
    x=Right(ScreenH(0.0078125)),
    y=Bottom(ScreenH(0.0078125)),
    w=ScreenH(0.236132813),
    h=ScreenH(0.038205295),
)


@dataclasses.dataclass(frozen=True)
class MapGeometry:
    """Resolved per-resolution pixel geometry of the deployment map."""

    frame_w: int
    frame_h: int
    # Map ROI within the frame.
    map_x: int
    map_y: int
    map_w: int
    map_h: int
    # Bottom-right quadrant of the map (OCR + scales region), frame coords.
    brq_x: int
    brq_y: int
    brq_w: int
    brq_h: int
    # Close-deployment-button ROI, frame coords.
    btn_x: int
    btn_y: int
    btn_w: int
    btn_h: int


def map_geometry(frame_w: int, frame_h: int) -> MapGeometry:
    """Resolve the map / BRQ / button ROIs for a frame resolution.

    Mirrors the "map fills remaining space" arithmetic of
    vision-cpu/src/lib.rs:137-145 exactly.
    """
    bx, by, bw, bh = MAP_BOUNDS.into_absolute(frame_w, frame_h)
    map_w = frame_w - bw
    map_x = frame_w - bx - map_w
    map_h = bh
    map_y = by
    brq_w = map_w // 2
    brq_h = map_h // 2
    btn_x, btn_y, btn_w, btn_h = CLOSE_DEPLOYMENT_BUTTON_BOUNDS.into_absolute(frame_w, frame_h)
    return MapGeometry(
        frame_w=frame_w,
        frame_h=frame_h,
        map_x=map_x,
        map_y=map_y,
        map_w=map_w,
        map_h=map_h,
        brq_x=map_x + brq_w,
        brq_y=map_y + brq_h,
        brq_w=brq_w,
        brq_h=brq_h,
        btn_x=btn_x,
        btn_y=btn_y,
        btn_w=btn_w,
        btn_h=btn_h,
    )
