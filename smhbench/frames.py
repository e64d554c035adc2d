"""Drawing the benchmark's frames: a synthetic deployment-map screenshot.

A frozen copy of the port's frame drawing (its testing.make_frame): a flat
background that neither the marker classifier nor the OCR keep-mask takes,
the red close-deployment button that opens the map, marker lines in the
alpha fireteam's colour (Bresenham, thickened by the L1 dilation), the
|----| scale bar and its "<N>m" label in DejaVu Sans. Map-ROI coordinates
for the lines, bottom-right-quadrant (BRQ) coordinates for the legend.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

from .reference import consts as C
from .reference.pixmath import dilate_l1_radius1

# HSV (105, 100, 100): passes the alpha-fireteam marker classifier.
ALPHA_MARKER_RGB = (64, 255, 0)
BUTTON_RED_RGB = tuple(int(v) for v in C.CLOSE_DEPLOYMENT_BUTTON_COLOR)
BACKGROUND_RGB = (90, 80, 70)
TEXT_LEVEL = 236  # bright monochrome: the OCR preprocess keeps it
FONT = pathlib.Path(__file__).resolve().parent / "fonts" / "DejaVuSans.ttf"
FONT_PX = 20  # smhocr reads 20 px glyphs at ~95 % confidence


def plot_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, value) -> None:
    """Bresenham's line into a 2D array, clipped to it."""
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


def _put_rgb(bgra: np.ndarray, ys, xs, rgb) -> None:
    bgra[ys, xs, 0] = rgb[2]
    bgra[ys, xs, 1] = rgb[1]
    bgra[ys, xs, 2] = rgb[0]


def background(w: int, h: int, with_button: bool = True) -> np.ndarray:
    """A BGRA u8 frame with the background and the open map's button."""
    g = C.map_geometry(w, h)
    frame = np.empty((h, w, 4), np.uint8)
    frame[..., 0], frame[..., 1], frame[..., 2], frame[..., 3] = BACKGROUND_RGB[2], BACKGROUND_RGB[1], BACKGROUND_RGB[0], 255
    if with_button:
        _put_rgb(frame, slice(g.btn_y, g.btn_y + g.btn_h), slice(g.btn_x, g.btn_x + g.btn_w), BUTTON_RED_RGB)
    return frame


def draw_lines(frame: np.ndarray, lines, thickness: int = 2) -> None:
    """Marker lines ((x0, y0), (x1, y1)) in map-ROI pixels, in place."""
    g = C.map_geometry(frame.shape[1], frame.shape[0])
    view = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
    mask = np.zeros(view.shape[:2], np.uint8)
    for (x0, y0), (x1, y1) in lines:
        plot_line(mask, x0, y0, x1, y1, 255)
    for _ in range(thickness - 1):
        mask = dilate_l1_radius1(mask)
    ys, xs = np.nonzero(mask)
    _put_rgb(view, ys, xs, ALPHA_MARKER_RGB)


@functools.lru_cache(maxsize=16)
def glyphs(text: str) -> tuple:
    """(ys, xs) of the text's pixels as DejaVu Sans draws it at FONT_PX."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(str(FONT), FONT_PX)
    img = Image.new("L", (FONT_PX * len(text) + 8, 30), 0)
    ImageDraw.Draw(img).text((2, 2), text, fill=255, font=font)
    return np.nonzero(np.asarray(img) > 128)


def draw_legend(frame: np.ndarray, text: str, tx: int, ty: int, bar: tuple) -> None:
    """The scale label at (tx, ty) and its bar (x, y, width) in BRQ pixels:
    a 1-px black line with 4-px end ticks, as the map draws it."""
    g = C.map_geometry(frame.shape[1], frame.shape[0])
    brq = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
    x, y, width = bar
    brq[y, x : x + width + 1, :3] = 0
    brq[y : y + 4, x, :3] = 0
    brq[y : y + 4, x + width, :3] = 0
    ys, xs = glyphs(text)
    ys, xs = ys + ty, xs + tx
    keep = (ys >= 0) & (ys < brq.shape[0]) & (xs >= 0) & (xs < brq.shape[1])
    brq[ys[keep], xs[keep], :3] = TEXT_LEVEL


def draw_patch(frame: np.ndarray, x: int, y: int, w: int, h: int) -> None:
    """A white block at (x, y) in BRQ pixels."""
    g = C.map_geometry(frame.shape[1], frame.shape[0])
    brq = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
    brq[y : y + h, x : x + w, :3] = 255
