"""Canned OCR engine for tests and the fake-input harness."""

from __future__ import annotations

from typing import Optional

from .engine import OcrResult


class FakeOcrEngine:
    """Returns pre-scripted results; records what it was asked to read."""

    binary_ok = True  # never reads pixel values
    # Canned results do NOT derive from the image, so row-band transport
    # (which only ships the text neighbourhood) must stay off for this
    # engine — its fabricated bboxes may point anywhere.
    image_derived = False

    def __init__(self, results: list[OcrResult]) -> None:
        self._results = list(results)
        self.calls: list[tuple[tuple[int, int], Optional[int]]] = []

    def read(self, gray, dpi: Optional[int] = None) -> list[OcrResult]:
        self.calls.append((tuple(gray.shape), dpi))
        return list(self._results)
