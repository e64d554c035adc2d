"""Native C++ host module: build-on-first-use, ctypes-loaded, optional.

The reference ships its host hot loops as Rust+rayon; here they are C++
(+OpenMP) behind a C ABI. The library and its generated consts header are
built into `smh_tpu_torch/build/native-<hash>/`, keyed by a hash of the
source, the consts and the flags (never into the source tree), under a
temporary name that is renamed into place, so concurrent builders never
load a torn file. One process builds at a time (an `fcntl.flock` on a file
in the build directory); the others wait for it and load its library
instead of compiling their own. If the toolchain or build fails, `load()`
returns None
and `build_error` keeps the compiler's message: the numpy oracle needs no
native module, while CudaBackend raises with that message.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from .. import consts as C
from ..geometry import Line, Point

log = logging.getLogger(__name__)

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "smhnative.cpp"
_BUILD_ROOT = _HERE.parent / "build"
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None  # the failed build's command and stderr


def lib_path() -> pathlib.Path:
    """Where this source + consts + flags build lands."""
    h = hashlib.sha256()
    h.update(_SRC.read_bytes())
    h.update(C.generate_c_header().encode())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libsmhnative.so"


def _build(out: pathlib.Path) -> bool:
    # Emit the shared consts header (the counterpart of the reference's
    # toml-consts codegen, which pre-includes consts.cu into nvcc builds).
    global build_error
    tmp = out.parent / f"tmp.{os.getpid()}.{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        (tmp / "smh_consts.h").write_text(C.generate_c_header())
        cmd = ["g++", *_FLAGS, "-I", str(tmp), "-o", str(tmp / out.name), str(_SRC), "-lm"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
        except subprocess.CalledProcessError as e:
            build_error = f"{' '.join(cmd)} (exit {e.returncode}):\n{e.stderr}"
        except (subprocess.TimeoutExpired, FileNotFoundError) as e:
            build_error = f"{' '.join(cmd)}: {e}"
        if build_error is not None:
            log.warning("native build failed: %s", build_error)
            return False
        os.replace(tmp / "smh_consts.h", out.parent / "smh_consts.h")
        os.replace(tmp / out.name, out)  # atomic: a concurrent loader never sees a torn file
        return True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = lib_path()
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            with open(so.parent / "build.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # another process's build finishes first
                if not so.exists() and not _build(so):
                    return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.warning("native load failed: %s", e)
            return None

        lib.smh_find_longest_line.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.smh_find_lines.restype = ctypes.c_int
        lib.smh_find_lines.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.smh_diff_subchunks.restype = ctypes.c_int
        lib.smh_diff_subchunks.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.smh_gather_subchunks.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.smh_pack_diff.restype = ctypes.c_int
        lib.smh_pack_diff.argtypes = [
            ctypes.c_void_p,  # map bgra
            ctypes.c_int64,   # map pitch
            ctypes.c_int,     # mh
            ctypes.c_int,     # mw
            ctypes.c_void_p,  # btn bgra
            ctypes.c_int64,   # btn pitch
            ctypes.c_int,     # bh
            ctypes.c_int,     # bw
            ctypes.c_int64,   # total
            ctypes.c_void_p,  # packed out
            ctypes.c_void_p,  # mirror (NULL = pack only)
            ctypes.c_void_p,  # dirty scratch
            ctypes.c_void_p,  # out idx
        ]
        lib.smh_pack_diff_roll.restype = ctypes.c_int
        lib.smh_pack_diff_roll.argtypes = [
            ctypes.c_void_p,  # map bgra
            ctypes.c_int64,   # map pitch
            ctypes.c_int,     # mh
            ctypes.c_int,     # mw
            ctypes.c_void_p,  # btn bgra
            ctypes.c_int64,   # btn pitch
            ctypes.c_int,     # bh
            ctypes.c_int,     # bw
            ctypes.c_int64,   # total
            ctypes.c_void_p,  # roll (mirror in, packed out)
            ctypes.c_void_p,  # dirty scratch
            ctypes.c_void_p,  # out idx
        ]
        lib.smh_find_lines_view.restype = ctypes.c_int
        lib.smh_find_lines_view.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,  # ch
            ctypes.c_int,  # cw
            ctypes.c_int,  # fh
            ctypes.c_int,  # fw
            ctypes.c_int,  # ox
            ctypes.c_int,  # oy
            ctypes.c_int,  # max_gap
            ctypes.c_int,  # max_lines
            ctypes.c_float,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def find_longest_line(mask: np.ndarray, pt: Point, max_gap: float) -> tuple[Line, float]:
    lib = load()
    assert lib is not None
    mask = np.ascontiguousarray(mask)
    h, w = mask.shape
    out = (ctypes.c_float * 5)()
    lib.smh_find_longest_line(
        mask.ctypes.data_as(ctypes.c_void_p), h, w,
        ctypes.c_float(pt.x), ctypes.c_float(pt.y), ctypes.c_float(max_gap), out,
    )
    line = Line(Point(out[0], out[1]), Point(out[2], out[3]))
    return line, float(out[4])


def find_lines(
    mask: np.ndarray,
    max_gap: int,
    max_lines: int = C.LSD_MAX_LINES,
    full_shape: Optional[tuple[int, int]] = None,
    offset: tuple[int, int] = (0, 0),
) -> list[Line]:
    """Seed scan + march. `mask` may be a windowed crop of a larger plane:
    pass full_shape=(fh, fw) and offset=(ox, oy) and the scan runs in
    full-plane coordinates, bit-identical to scanning the full mask (the
    crop must cover every white pixel; see hostpack v2)."""
    lib = load()
    assert lib is not None
    mask = np.ascontiguousarray(mask)
    h, w = mask.shape
    fh, fw = full_shape if full_shape is not None else (h, w)
    ox, oy = offset
    out = (ctypes.c_float * (max_lines * 4))()
    n = lib.smh_find_lines_view(
        mask.ctypes.data_as(ctypes.c_void_p), h, w, int(fh), int(fw),
        int(ox), int(oy), int(max_gap), int(max_lines),
        ctypes.c_float(C.LSD_MIN_LENGTH_SQR), ctypes.c_float(C.LSD_DEDUP_DIST_SQR), out,
    )
    return [
        Line(Point(out[i * 4], out[i * 4 + 1]), Point(out[i * 4 + 2], out[i * 4 + 3]))
        for i in range(n)
    ]


def diff_subchunks(a: np.ndarray, b: np.ndarray, out_idx: np.ndarray) -> int:
    """Indices of differing 32 B sub-chunks of two equal-size u8 buffers
    (the delta transport's upload granularity) — exactly the set the numpy
    two-level refine produces, at memory speed with no bool temporaries.
    out_idx: int32 scratch with a.size // 32 capacity. Returns the count."""
    lib = load()
    assert lib is not None
    assert a.dtype == np.uint8 and a.flags.c_contiguous
    assert b.dtype == np.uint8 and b.flags.c_contiguous
    assert a.size == b.size and a.size % 32 == 0
    assert out_idx.dtype == np.int32 and out_idx.size >= a.size // 32
    return lib.smh_diff_subchunks(
        a.ctypes.data_as(ctypes.c_void_p),
        b.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(a.size),
        out_idx.ctypes.data_as(ctypes.c_void_p),
    )


def pack_diff(
    map_roi: np.ndarray, btn_roi: np.ndarray, packed: np.ndarray,
    mirror: "np.ndarray | None", dirty: "np.ndarray | None",
    out_idx: "np.ndarray | None",
) -> int:
    """Fused planarize + delta diff: ONE sweep packs both BGRA ROI views
    into the flat upload layout (_pack_rois_bgr's: plane-major BGR map,
    interleaved-BGR button, zeroed tail) while diffing against `mirror`,
    emitting the changed 32 B sub-chunk indices ascending — the exact set
    (and order) of diff_subchunks over the two-pass result, without ever
    re-reading the packed buffer from DRAM. mirror=None packs only
    (returns -1). dirty: u8 scratch of packed.size//32; out_idx: int32 of
    the same capacity (both unused in pack-only mode)."""
    lib = load()
    assert lib is not None
    for roi in (map_roi, btn_roi):
        assert roi.dtype == np.uint8 and roi.ndim == 3 and roi.shape[2] == 4
        assert roi.strides[2] == 1 and roi.strides[1] == 4
    assert packed.dtype == np.uint8 and packed.flags.c_contiguous
    assert packed.size % 32 == 0
    mh, mw = map_roi.shape[:2]
    bh, bw = btn_roi.shape[:2]
    assert packed.size >= (mh * mw + bh * bw) * 3
    if mirror is not None:
        assert mirror.dtype == np.uint8 and mirror.flags.c_contiguous
        assert mirror.size == packed.size
        n_sub = packed.size // 32
        assert dirty is not None and dirty.dtype == np.uint8 and dirty.size >= n_sub
        assert out_idx is not None and out_idx.dtype == np.int32 and out_idx.size >= n_sub
    return lib.smh_pack_diff(
        map_roi.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(map_roi.strides[0]), mh, mw,
        btn_roi.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(btn_roi.strides[0]), bh, bw,
        ctypes.c_int64(packed.size),
        packed.ctypes.data_as(ctypes.c_void_p),
        mirror.ctypes.data_as(ctypes.c_void_p) if mirror is not None else None,
        dirty.ctypes.data_as(ctypes.c_void_p) if mirror is not None else None,
        out_idx.ctypes.data_as(ctypes.c_void_p) if mirror is not None else None,
    )


def pack_diff_roll(
    map_roi: np.ndarray, btn_roi: np.ndarray, roll: np.ndarray,
    dirty: np.ndarray, out_idx: np.ndarray,
) -> int:
    """In-place rolling pack+diff: `roll` is BOTH the diff base (previous
    frame's packed bytes, which must equal the device-resident content) and
    the output (this frame's packed bytes). Unchanged 32 B windows are
    compared but never stored, so a mostly-static frame costs read
    bandwidth only — the separate mirror buffer, its read, and the
    full-buffer write of pack_diff all vanish. Same changed-index set and
    final bytes as pack_diff against an equal-content mirror (pinned by
    tests). Gather the changed payloads out of `roll` before the next
    frame's call overwrites them."""
    lib = load()
    assert lib is not None
    for roi in (map_roi, btn_roi):
        assert roi.dtype == np.uint8 and roi.ndim == 3 and roi.shape[2] == 4
        assert roi.strides[2] == 1 and roi.strides[1] == 4
    assert roll.dtype == np.uint8 and roll.flags.c_contiguous
    assert roll.size % 32 == 0
    mh, mw = map_roi.shape[:2]
    bh, bw = btn_roi.shape[:2]
    assert roll.size >= (mh * mw + bh * bw) * 3
    n_sub = roll.size // 32
    assert dirty.dtype == np.uint8 and dirty.size >= n_sub
    assert out_idx.dtype == np.int32 and out_idx.size >= n_sub
    return lib.smh_pack_diff_roll(
        map_roi.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(map_roi.strides[0]), mh, mw,
        btn_roi.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(btn_roi.strides[0]), bh, bw,
        ctypes.c_int64(roll.size),
        roll.ctypes.data_as(ctypes.c_void_p),
        dirty.ctypes.data_as(ctypes.c_void_p),
        out_idx.ctypes.data_as(ctypes.c_void_p),
    )


def gather_subchunks(
    packed: np.ndarray, idx: np.ndarray, n_changed: int, bucket: int,
    out: np.ndarray,
) -> None:
    """Build the delta upload buffer: int32 index table padded to `bucket`
    by repeating the last index, then the 32 B payloads (the numpy tail of
    load_frame, one pass, no fancy-index temporaries)."""
    lib = load()
    assert lib is not None
    assert packed.dtype == np.uint8 and packed.flags.c_contiguous
    assert idx.dtype == np.int32 and idx.flags.c_contiguous
    assert 1 <= n_changed <= bucket and idx.size >= n_changed
    assert out.dtype == np.uint8 and out.size == bucket * 4 + bucket * 32
    lib.smh_gather_subchunks(
        packed.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.c_void_p),
        n_changed,
        bucket,
        out.ctypes.data_as(ctypes.c_void_p),
    )
