"""Synthetic frames for the port's tests and chip smoke.

`make_frame` equals smh_tpu.testing.make_frame byte for byte, but renders
scale texts with the DejaVu Sans copy bundled in `smh_tpu_torch/fonts/`
(the device templates read the same files), so frames with real glyphs can
be made on machines without system fonts.
"""

from __future__ import annotations

import numpy as np

from smh_tpu import consts as C
from smh_tpu import testing as _testing

from .ops.scales_device import FONTS


def fonts_present() -> dict:
    """{font path: exists} for the fonts the templates and frames read."""
    return {str(p): p.exists() for p in FONTS}


def make_frame(
    frame_w: int = 1920,
    frame_h: int = 1080,
    marker_lines=(),
    with_button: bool = True,
    scale_bars=(),
    scale_texts=(),
    background=(90, 80, 70),
    line_thickness: int = 2,
) -> np.ndarray:
    """BGRA u8 frame: smh_tpu.testing.make_frame, with scale texts stamped
    from the bundled font (same size, placement and colour)."""
    from PIL import Image, ImageDraw, ImageFont

    frame = _testing.make_frame(
        frame_w, frame_h, marker_lines=marker_lines, with_button=with_button,
        scale_bars=scale_bars, scale_texts=(), background=background,
        line_thickness=line_thickness,
    )
    if not scale_texts:
        return frame
    g = C.map_geometry(frame_w, frame_h)
    brq_view = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
    font = ImageFont.truetype(str(FONTS[0]), 20)
    for text, (tx, ty) in scale_texts:
        img = Image.new("L", (20 * len(text) + 8, 30), 0)
        ImageDraw.Draw(img).text((2, 2), text, fill=255, font=font)
        ys, xs = np.nonzero(np.asarray(img) > 128)
        for yy, xx in zip(ys, xs):
            py, px = ty + yy, tx + xx
            if 0 <= py < brq_view.shape[0] and 0 <= px < brq_view.shape[1]:
                brq_view[py, px, :3] = 236  # bright monochrome: OCR keeps it
    return frame
