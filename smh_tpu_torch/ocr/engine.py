"""The OCR engine contract.

Counterpart of the reference's OCR surface (vision-ocr/src/lib.rs:31-46 and
ocr.cpp:26-55): recognize a preprocessed grayscale image, iterate TEXTLINE
results with text/confidence/bbox. Engines are injectable so the pipeline's
scales branch is testable without a trained model (the reference cannot do
that — its Tesseract is a hard dependency).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

# Text threshold shared by every binary-capable engine and the device-side
# bit-pack (ops/pipeline packs `ocr_img < OCR_BINARY_THRESHOLD`): the
# preprocessed image is 255 background / inverted-luma text, and binary_ok
# engines only ever evaluate this predicate, so a bit mask of it is an exact
# transport. One definition — engines and kernels import it from here.
OCR_BINARY_THRESHOLD = 200


@dataclasses.dataclass(frozen=True)
class OcrResult:
    text: str
    confidence: float
    left: int
    top: int
    right: int
    bottom: int


class OcrEngine(Protocol):
    # Engines that only *threshold* the image (template matchers, canned
    # fakes) set binary_ok = True: the backend then ships the OCR input as a
    # bit-packed text mask (8x less D2H) and reconstructs a 0/255 image —
    # exact for any engine that never reads intermediate gray levels.
    binary_ok: bool = False
    # True (default) for engines whose results derive from the image pixels:
    # lets the backend ship only the text-row band (exact). Test doubles
    # returning canned results set False.
    image_derived: bool = True

    def read(self, gray, dpi: Optional[int] = None) -> list[OcrResult]:
        """Recognize text lines in a grayscale u8 image [h, w]."""
        ...
