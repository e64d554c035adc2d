"""Build-on-first-use for the smhtess shared library.

smhtess.cpp implements the Tesseract C API subset the ctypes binding uses
(see its header comment); this module compiles it and hands back the .so
path so `ocr/tesseract.py` can be pointed at it via SMH_TESS_LIB, and so
tests can exercise the binding end-to-end on hosts without a real
traineddata (reference counterpart: the embedded-traineddata init in
vision-ocr/src/lib.rs:129-159). As native/__init__.py builds smhnative, the
library lands in `smh_tpu_torch/build/smhtess-<hash>/`, keyed by a hash of
the source and the flags (never in the source tree), under a temporary name
that is renamed into place, so concurrent builders never load a torn file.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pathlib
import subprocess
import threading
from typing import Optional

log = logging.getLogger(__name__)

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "smhtess.cpp"
_BUILD_ROOT = _HERE.parent / "build"
_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()


def lib_path() -> Optional[pathlib.Path]:
    """Compile (unless this source and flags are built) and return the
    smhtess library path; None on failure."""
    with _lock:
        digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
        so = _BUILD_ROOT / f"smhtess-{digest}" / "libsmhtess.so"
        if so.exists():
            return so
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError) as e:
            log.warning("smhtess build failed: %s", e)
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, so)  # atomic: a concurrent loader never sees a torn file
        return so
