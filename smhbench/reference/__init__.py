"""The benchmark's plain reference: one frame in, the answers a user sees out.

A frozen numpy copy of the per-frame pipeline's semantics (upstream
src/vision/mod.rs:36-240 over the vision-cpu stages): the red-button gate,
the minimap bounds, the marker lines (HSV classify, dilate, the seed scan
and ray march of the LSD) and the meters-to-px ratio (OCR preprocess, a
template reader of "<N>m", the scale-bar scan). It imports nothing of the
program under test and takes nothing the program made: only the frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import consts as C
from . import find_minimap as fm
from . import mpx_ratio as mpx
from .backend import ReferenceBackend
from .engine import OCR_BINARY_THRESHOLD
from .smhocr import SmhOcrEngine


@dataclasses.dataclass(frozen=True)
class Answer:
    """What one frame says: None for all three while the map is closed."""

    sleeping: bool
    markers: tuple  # ((x0, y0), (x1, y1)) per line, in map-ROI pixels
    ratio: Optional[float]
    minimap: Optional[tuple]  # (left, top, right, bottom)


def parse_scales(ocr_results) -> tuple[list, Optional[int]]:
    """The "<N>m" texts, at most 3 distinct scales (src/vision/mod.rs:160-193)."""
    scales: list = []
    start_y: Optional[int] = None
    for ocr in ocr_results:
        if not ocr.text.isascii():
            continue
        m = ocr.text.rfind("m")
        if m < 0:
            continue
        prefix = ocr.text[:m]
        if not prefix.isdigit():
            continue
        scale = int(prefix)
        if scale == 0:
            continue
        start_y = ocr.bottom if start_y is None else min(start_y, ocr.bottom)
        if any(s == scale for s, _ in scales):
            continue
        scales.append((scale, ((ocr.left + ocr.right) // 2, ocr.bottom)))
        if len(scales) == 3:
            break
    return scales, start_y


def run(frame_bgra: np.ndarray, dpi: Optional[int] = 96, detect_markers: bool = True) -> tuple:
    """(the Answer for one BGRA u8 frame, as the per-frame pipeline gives
    it; what the frame's transport needs: `nz` non-zero u32 words of the
    marker mask's bit rows, `win` (rows, cols) of the mask's bounding box,
    `band` rows from the first to the last row of OCR text)."""
    be = ReferenceBackend()
    be.load_frame(frame_bgra)
    cropped = be.crop_to_map(True)
    if cropped is None:
        return Answer(True, (), None, None), {"nz": 0, "win": (0, 0), "band": 0}
    x, y, w, h = cropped[1]
    rect = fm.find_minimap(frame_bgra[y : y + h, x : x + w])
    minimap = None if rect is None else (rect.left, rect.top, rect.right, rect.bottom)

    be.mask_marker_lines()
    mask = be.lsd_image == 255
    markers: tuple = ()
    if detect_markers:
        markers = tuple(((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in be.find_marker_lines(C.LSD_MAX_GAP))

    ocr_image = be.ocr_preprocess()
    ratio = None
    scales, start_y = parse_scales(SmhOcrEngine().read(ocr_image, dpi))
    if scales and start_y is not None:
        ratio = mpx.calc_meters_to_px_ratio(scales, be.find_scales_preprocess(start_y))
    return Answer(False, markers, ratio, minimap), needs(mask, ocr_image)


def needs(mask: np.ndarray, ocr_image: np.ndarray) -> dict:
    """What a frame's transport must carry, from the marker mask and the OCR image."""
    bits = np.packbits(mask, axis=1)
    words = np.pad(bits, ((0, 0), (0, (-bits.shape[1]) % 4))).view(">u4")
    ys, xs = np.nonzero(mask)
    win = (int(ys.max() - ys.min() + 1), int(xs.max() - xs.min() + 1)) if ys.size else (0, 0)
    rows = np.nonzero((ocr_image < OCR_BINARY_THRESHOLD).any(axis=1))[0]
    band = int(rows[-1] - rows[0] + 1) if rows.size else 0
    return {"nz": int(np.count_nonzero(words)), "win": win, "band": band}
