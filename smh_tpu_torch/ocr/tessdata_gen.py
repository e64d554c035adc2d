"""Generate the vendored SMHT traineddata consumed by the smhtess C library.

The reference embeds a 23 MB eng.traineddata in its binary and initializes
Tesseract from memory (the reference's vision-ocr/src/lib.rs:129-159). This
image ships libtesseract but NO traineddata and has zero egress, so the real
LSTM model cannot exist here. Instead the repo vendors a model in its own
format: the same DejaVu digit+'m' templates the smhocr engine uses, packed
into a small binary file that `native/smhtess.cpp` — a C implementation of
the Tesseract C API subset — loads through TessBaseAPIInit2 exactly like
tesseract loads a traineddata. The ctypes binding in ocr/tesseract.py runs
unmodified against either library.

Format (little-endian):
  magic  "SMHT"            4 bytes
  u32    version (1)
  u32    glyph_w, glyph_h
  u32    binary threshold  (gray < threshold => text)
  u32    n_templates
  repeat n_templates:
    u8   character
    f32  template[glyph_h * glyph_w]   (zero-mean, unit-norm)
"""

from __future__ import annotations

import pathlib
import struct

from .engine import OCR_BINARY_THRESHOLD
from .smhocr import GLYPH_H, GLYPH_W, _templates

MAGIC = b"SMHT"
VERSION = 1


def write_traineddata(path: str | pathlib.Path) -> pathlib.Path:
    """Render the glyph templates and write `<path>` (e.g. eng.traineddata)."""
    path = pathlib.Path(path)
    tpls = _templates()
    if not tpls:
        raise RuntimeError("no fonts available to render glyph templates")
    out = bytearray()
    out += MAGIC
    out += struct.pack("<IIIII", VERSION, GLYPH_W, GLYPH_H, OCR_BINARY_THRESHOLD, len(tpls))
    for ch, t in tpls:
        assert t.shape == (GLYPH_H, GLYPH_W)
        out += struct.pack("<B", ord(ch))
        out += t.astype("<f4").tobytes()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(out))
    return path


def ensure_default(tessdata_dir: str | pathlib.Path, lang: str = "eng") -> pathlib.Path:
    """Write `<dir>/<lang>.traineddata` if absent; return its path."""
    p = pathlib.Path(tessdata_dir) / f"{lang}.traineddata"
    if not p.exists():
        write_traineddata(p)
    return p


if __name__ == "__main__":  # pragma: no cover
    import sys

    print(write_traineddata(sys.argv[1] if len(sys.argv) > 1 else "eng.traineddata"))
