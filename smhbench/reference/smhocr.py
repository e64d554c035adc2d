"""Self-contained scale-text OCR: template matching for "<N>m" strings.

The pipeline only ever needs to read the map's scale labels — short strings
of digits followed by "m" (src/vision/mod.rs:160-182 parses exactly that).
A full LSTM OCR stack is overkill for ten digits and one letter, and
Tesseract's traineddata is an external asset. This engine:

  1. thresholds the OCR-preprocessed image (dark text on a white field),
  2. finds connected components (glyphs) and groups them into words by
     baseline overlap + horizontal proximity,
  3. classifies each glyph against rendered DejaVu Sans templates
     (digits + 'm') by normalized template distance.

It is the default fallback when no tesseract traineddata is available, and
it validates on the reference's real screenshots (see tests): the ratios
derived from multiple scale bars must agree with each other, which is only
possible when the digits are read correctly.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Optional

import numpy as np

from .engine import OCR_BINARY_THRESHOLD, OcrResult

GLYPH_W, GLYPH_H = 12, 16
CHARS = "0123456789m"
# DejaVu Sans regular + bold, the benchmark's own copy (license beside them).
FONT_DIR = pathlib.Path(__file__).resolve().parent.parent / "fonts"
FONTS = (FONT_DIR / "DejaVuSans.ttf", FONT_DIR / "DejaVuSans-Bold.ttf")
_FONTS = tuple(str(f) for f in FONTS)

TEXT_THRESHOLD = OCR_BINARY_THRESHOLD  # background == 255, text <= ~125
MIN_GLYPH_PX = 8
MIN_GLYPH_H = 5
MAX_GLYPH_H = 48
MIN_CONFIDENCE = 0.55


@functools.lru_cache(maxsize=1)
def _templates() -> list[tuple[str, np.ndarray]]:
    from PIL import Image, ImageDraw, ImageFont

    out = []
    for path in _FONTS:
        try:
            font = ImageFont.truetype(path, 32)
        except OSError:
            continue
        for ch in CHARS:
            img = Image.new("L", (64, 64), 0)
            d = ImageDraw.Draw(img)
            d.text((8, 8), ch, fill=255, font=font)
            arr = np.asarray(img)
            ys, xs = np.nonzero(arr > 64)
            if ys.size == 0:
                continue
            crop = arr[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
            t = _normalize(crop.astype(np.float32) / 255.0)
            out.append((ch, t))
    return out


def _normalize(glyph: np.ndarray) -> np.ndarray:
    """Resize a cropped glyph to the canonical GLYPH_W x GLYPH_H box."""
    from PIL import Image

    img = Image.fromarray((np.clip(glyph, 0, 1) * 255).astype(np.uint8))
    img = img.resize((GLYPH_W, GLYPH_H), Image.BILINEAR)
    arr = np.asarray(img).astype(np.float32) / 255.0
    # zero-mean/unit-norm so correlation is brightness invariant
    arr = arr - arr.mean()
    n = np.linalg.norm(arr)
    return arr / n if n > 1e-6 else arr


def _classify(glyph_mask: np.ndarray) -> tuple[str, float]:
    t = _normalize(glyph_mask.astype(np.float32))
    best_ch, best_score = "?", -1.0
    for ch, tpl in _templates():
        score = float((t * tpl).sum())
        if score > best_score:
            best_ch, best_score = ch, score
    return best_ch, best_score


class SmhOcrEngine:
    """Digits+'m' word reader over the preprocessed BRQ image."""

    name = "smhocr"

    def read(self, gray: np.ndarray, dpi: Optional[int] = None) -> list[OcrResult]:
        from scipy import ndimage

        text = gray < TEXT_THRESHOLD
        if not text.any():
            return []

        labels, n = ndimage.label(text)
        objects = ndimage.find_objects(labels)
        sizes = ndimage.sum(text, labels, range(1, n + 1))

        glyphs = []  # (x0, y0, x1, y1, label_idx)
        for i, sl in enumerate(objects):
            if sl is None or sizes[i] < MIN_GLYPH_PX:
                continue
            y0, y1 = sl[0].start, sl[0].stop
            x0, x1 = sl[1].start, sl[1].stop
            h = y1 - y0
            w = x1 - x0
            if not (MIN_GLYPH_H <= h <= MAX_GLYPH_H) or w > MAX_GLYPH_H:
                continue
            glyphs.append((x0, y0, x1, y1, i + 1))
        if not glyphs:
            return []

        # Group glyphs into words: same baseline band + small horizontal gap.
        words: list[list[tuple]] = []
        for g in sorted(glyphs, key=lambda g: g[0]):
            placed = False
            for word in words:
                last = word[-1]
                v_overlap = min(g[3], last[3]) - max(g[1], last[1])
                min_h = min(g[3] - g[1], last[3] - last[1])
                gap = g[0] - last[2]
                if v_overlap > 0.5 * min_h and -2 <= gap <= max(4, int(0.9 * min_h)):
                    word.append(g)
                    placed = True
                    break
            if not placed:
                words.append([g])

        results = []
        for word in words:
            chars = []
            scores = []
            for x0, y0, x1, y1, lab in word:
                mask = (labels[y0:y1, x0:x1] == lab).astype(np.float32)
                ch, score = _classify(mask)
                chars.append(ch if score >= MIN_CONFIDENCE else "?")
                scores.append(max(score, 0.0))
            text_s = "".join(chars)
            wx0 = min(g[0] for g in word)
            wy0 = min(g[1] for g in word)
            wx1 = max(g[2] for g in word)
            wy1 = max(g[3] for g in word)
            results.append(
                OcrResult(
                    text=text_s,
                    confidence=float(np.mean(scores)) * 100.0,
                    left=int(wx0),
                    top=int(wy0),
                    right=int(wx1),
                    bottom=int(wy1),
                )
            )
        return results
