"""Tesseract binding via the system libtesseract C API (ctypes).

Counterpart of the reference's vision-ocr crate: a 5-function C++ shim over
TessBaseAPI (/root/reference/vision-ocr/src/ocr.cpp:7-55) linked statically.
Here the system library already exports a complete C API, so the binding is
ctypes-direct — same configuration: OEM_LSTM_ONLY, PSM_SPARSE_TEXT, TEXTLINE
iteration, optional source DPI (ocr.cpp:10-17,26-30).

Gated gracefully: if libtesseract or eng.traineddata is missing, `available()`
is False and the pipeline simply runs without the scales branch (equivalent to
OCR finding no text).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import pathlib
import threading
from typing import Optional

import numpy as np

from .engine import OcrResult

# tesseract/publictypes.h
OEM_LSTM_ONLY = 1
PSM_SPARSE_TEXT = 11
RIL_TEXTLINE = 2

_LIB_CANDIDATES = (
    "libtesseract.so.5",
    "libtesseract.so",
    "tesseract",
)

_TESSDATA_CANDIDATES = (
    "/usr/share/tesseract-ocr/5/tessdata",
    "/usr/share/tesseract-ocr/4.00/tessdata",
    "/usr/share/tessdata",
    "/usr/local/share/tessdata",
)


def _find_lib() -> Optional[ctypes.CDLL]:
    # Explicit override first: tests (and traineddata-less hosts) point this
    # at native/libsmhtess.so, the in-repo C implementation of this API.
    override = os.environ.get("SMH_TESS_LIB")
    if override:
        try:
            return ctypes.CDLL(override)
        except OSError:
            return None
    for name in _LIB_CANDIDATES:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    path = ctypes.util.find_library("tesseract")
    if path:
        try:
            return ctypes.CDLL(path)
        except OSError:
            pass
    return None


def find_tessdata(lang: str = "eng") -> Optional[str]:
    env = os.environ.get("TESSDATA_PREFIX")
    candidates = ((env,) if env else ()) + _TESSDATA_CANDIDATES
    for d in candidates:
        if d and (pathlib.Path(d) / f"{lang}.traineddata").exists():
            return d
    return None


class TesseractEngine:
    """Thread-safe (lock-serialized, like the reference's singleton mutex,
    vision-ocr/src/lib.rs:57-71) Tesseract TEXTLINE reader."""

    # Reads gray levels (LSTM), so no binary transport; results derive from
    # the pixels, so the row-band transport is exact for it.
    binary_ok = False
    image_derived = True

    def __init__(self, lang: str = "eng", tessdata: Optional[str] = None) -> None:
        self._lib = _find_lib()
        if self._lib is None:
            raise RuntimeError("libtesseract not found")
        tessdata = tessdata or find_tessdata(lang)
        if tessdata is None:
            raise RuntimeError(f"no {lang}.traineddata found (set TESSDATA_PREFIX)")

        lib = self._lib
        lib.TessBaseAPICreate.restype = ctypes.c_void_p
        lib.TessBaseAPIInit2.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.TessBaseAPISetImage.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.TessBaseAPIGetIterator.restype = ctypes.c_void_p
        lib.TessBaseAPIGetIterator.argtypes = [ctypes.c_void_p]
        lib.TessResultIteratorGetUTF8Text.restype = ctypes.c_void_p
        lib.TessResultIteratorGetUTF8Text.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.TessResultIteratorConfidence.restype = ctypes.c_float
        lib.TessResultIteratorConfidence.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.TessResultIteratorGetPageIterator.restype = ctypes.c_void_p
        lib.TessResultIteratorGetPageIterator.argtypes = [ctypes.c_void_p]
        lib.TessPageIteratorBoundingBox.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.TessResultIteratorNext.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.TessResultIteratorDelete.argtypes = [ctypes.c_void_p]
        lib.TessDeleteText.argtypes = [ctypes.c_void_p]
        lib.TessBaseAPISetSourceResolution.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.TessBaseAPISetPageSegMode.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.TessBaseAPIRecognize.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

        self._api = lib.TessBaseAPICreate()
        rc = lib.TessBaseAPIInit2(
            self._api, tessdata.encode(), lang.encode(), OEM_LSTM_ONLY
        )
        if rc != 0:
            raise RuntimeError(f"Tesseract init failed (rc={rc})")
        lib.TessBaseAPISetPageSegMode(self._api, PSM_SPARSE_TEXT)
        self._lock = threading.Lock()

    def read(self, gray: np.ndarray, dpi: Optional[int] = None) -> list[OcrResult]:
        assert gray.dtype == np.uint8 and gray.ndim == 2
        gray = np.ascontiguousarray(gray)
        h, w = gray.shape
        lib = self._lib
        results: list[OcrResult] = []

        with self._lock:
            lib.TessBaseAPISetImage(
                self._api, gray.ctypes.data_as(ctypes.c_void_p), w, h, 1, w
            )
            if dpi and dpi > 0:
                lib.TessBaseAPISetSourceResolution(self._api, int(dpi))
            lib.TessBaseAPIRecognize(self._api, None)

            it = lib.TessBaseAPIGetIterator(self._api)
            if not it:
                return results
            page_it = lib.TessResultIteratorGetPageIterator(it)
            try:
                while True:
                    txt_ptr = lib.TessResultIteratorGetUTF8Text(it, RIL_TEXTLINE)
                    if not txt_ptr:
                        break
                    text = ctypes.string_at(txt_ptr).decode("utf-8", "replace").strip()
                    lib.TessDeleteText(txt_ptr)

                    conf = lib.TessResultIteratorConfidence(it, RIL_TEXTLINE)
                    x1 = ctypes.c_int()
                    y1 = ctypes.c_int()
                    x2 = ctypes.c_int()
                    y2 = ctypes.c_int()
                    lib.TessPageIteratorBoundingBox(
                        page_it,
                        RIL_TEXTLINE,
                        ctypes.byref(x1),
                        ctypes.byref(y1),
                        ctypes.byref(x2),
                        ctypes.byref(y2),
                    )
                    results.append(
                        OcrResult(
                            text=text,
                            confidence=float(conf),
                            left=x1.value,
                            top=y1.value,
                            right=x2.value,
                            bottom=y2.value,
                        )
                    )
                    if not lib.TessResultIteratorNext(it, RIL_TEXTLINE):
                        break
            finally:
                lib.TessResultIteratorDelete(it)

        return results


_availability: Optional[bool] = None


def available(lang: str = "eng") -> bool:
    global _availability
    if _availability is None:
        _availability = _find_lib() is not None and find_tessdata(lang) is not None
    return _availability


def create_default_engine():
    """Tesseract when the system has it + traineddata; otherwise the
    self-contained template engine (smhocr) so the scales path still works
    with zero external assets; None only if neither can start."""
    if available():
        try:
            return TesseractEngine()
        except RuntimeError:
            pass
    try:
        from .smhocr import SmhOcrEngine

        return SmhOcrEngine()
    except Exception:
        return None
