"""OCR: engine contract, Tesseract C-API binding, fake engine for tests."""

from .engine import OcrEngine, OcrResult  # noqa: F401
from .fake import FakeOcrEngine  # noqa: F401
