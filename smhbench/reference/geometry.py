"""Geometry primitives: Point, Line, Rect, BBox.

Counterpart of the reference's util geometry types
(upstream util/src/geometry.rs:5-187). Plain dataclasses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class Point:
    x: float
    y: float

    def __add__(self, other: "Point") -> "Point":
        return Point(self.x + other.x, self.y + other.y)

    def __sub__(self, other: "Point") -> "Point":
        return Point(self.x - other.x, self.y - other.y)

    def __mul__(self, s: float) -> "Point":
        return Point(self.x * s, self.y * s)

    __rmul__ = __mul__

    def distance_sqr(self, other: "Point") -> float:
        dx = self.x - other.x
        dy = self.y - other.y
        return dx * dx + dy * dy

    def distance(self, other: "Point") -> float:
        return math.sqrt(self.distance_sqr(other))

    def as_tuple(self) -> tuple[float, float]:
        return (self.x, self.y)


@dataclasses.dataclass(frozen=True)
class Line:
    p0: Point
    p1: Point

    def length_sqr(self) -> float:
        return self.p0.distance_sqr(self.p1)

    def length(self) -> float:
        return self.p0.distance(self.p1)

    def midpoint(self) -> Point:
        return Point((self.p0.x + self.p1.x) / 2.0, (self.p0.y + self.p1.y) / 2.0)

    def as_tuple(self) -> tuple[tuple[float, float], tuple[float, float]]:
        return (self.p0.as_tuple(), self.p1.as_tuple())

    @staticmethod
    def from_tuple(t) -> "Line":
        (x0, y0), (x1, y1) = t
        return Line(Point(float(x0), float(y0)), Point(float(x1), float(y1)))


@dataclasses.dataclass(frozen=True)
class Rect:
    """Edge-addressed rectangle (left/top/right/bottom), like util Rect."""

    left: int
    top: int
    right: int
    bottom: int

    def width(self) -> int:
        return self.right - self.left

    def height(self) -> int:
        return self.bottom - self.top

    def contains(self, x: float, y: float) -> bool:
        return self.left <= x <= self.right and self.top <= y <= self.bottom


@dataclasses.dataclass(frozen=True)
class BBox:
    """Origin+size rectangle (x/y/w/h)."""

    x: int
    y: int
    w: int
    h: int

    def as_rect(self) -> Rect:
        return Rect(left=self.x, top=self.y, right=self.x + self.w, bottom=self.y + self.h)

    def __iter__(self) -> Iterator[int]:
        return iter((self.x, self.y, self.w, self.h))

