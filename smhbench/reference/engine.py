"""What the OCR reader returns, and the threshold it reads text by."""

from __future__ import annotations

import dataclasses

# The preprocessed image is 255 background and inverted-luma text; a pixel
# under this threshold is text.
OCR_BINARY_THRESHOLD = 200


@dataclasses.dataclass(frozen=True)
class OcrResult:
    text: str
    confidence: float
    left: int
    top: int
    right: int
    bottom: int
