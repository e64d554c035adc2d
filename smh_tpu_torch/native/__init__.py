"""Native C++ host module: build-on-first-use, ctypes-loaded, optional.

The reference ships its host hot loops as Rust+rayon; here they are C++
(+OpenMP) behind a C ABI: `smhnative.cpp` (the JAX package's source) and
`smhroll.cpp` (the batch delta path's banded roll) make one library. The
library and its generated consts header are built into
`smh_tpu_torch/build/native-<hash>/`, keyed by a hash of the sources, the
consts and the flags (never into the source tree), under a
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
_ROLL_SRC = _HERE / "smhroll.cpp"
_BUILD_ROOT = _HERE.parent / "build"
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None  # the failed build's command and stderr


def lib_path() -> pathlib.Path:
    """Where these sources + consts + flags build lands."""
    h = hashlib.sha256()
    h.update(_SRC.read_bytes())
    h.update(_ROLL_SRC.read_bytes())
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
        cmd = ["g++", *_FLAGS, "-I", str(tmp), "-o", str(tmp / out.name), str(_SRC), str(_ROLL_SRC), "-lm"]
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
        lib.smh_roll_band_cap.restype = ctypes.c_int64
        lib.smh_roll_band_cap.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64]
        lib.smh_roll_band.restype = None
        lib.smh_roll_band.argtypes = [
            ctypes.c_void_p,  # map ROI pointers, one a frame
            ctypes.c_void_p,  # map pitches
            ctypes.c_void_p,  # button ROI pointers
            ctypes.c_void_p,  # button pitches
            ctypes.c_int,     # frames
            ctypes.c_int,     # mh
            ctypes.c_int,     # mw
            ctypes.c_int,     # bh
            ctypes.c_int,     # bw
            ctypes.c_int64,   # total
            ctypes.c_int,     # y0
            ctypes.c_int,     # y1
            ctypes.c_void_p,  # roll (shared by the bands)
            ctypes.c_void_p,  # dirty scratch (the band's own)
            ctypes.c_int64,   # cap: entries a frame
            ctypes.c_void_p,  # out idx [frames, cap]
            ctypes.c_void_p,  # out data [frames, cap, 32]
            ctypes.c_void_p,  # out counts [frames, 3]
        ]
        lib.smh_roll_merge.restype = None
        lib.smh_roll_merge.argtypes = [
            ctypes.c_int,     # bands
            ctypes.c_int,     # frames
            ctypes.c_void_p,  # each band's idx
            ctypes.c_void_p,  # each band's data
            ctypes.c_void_p,  # each band's counts
            ctypes.c_void_p,  # each band's cap
            ctypes.c_int,     # bucket (0: count only)
            ctypes.c_int,     # batch rows of out
            ctypes.c_void_p,  # out: the batch delta buffer
            ctypes.c_void_p,  # counts a frame
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



def roll_band_cap(mh: int, mw: int, y0: int, y1: int, total: int) -> int:
    """Entries roll_band can write a frame for rows [y0, y1) of an mh x mw
    map in a `total`-byte layout: every sub-chunk the band's bytes touch."""
    lib = load()
    assert lib is not None
    assert 0 <= y0 < y1 <= mh and total % 32 == 0
    return int(lib.smh_roll_band_cap(mh, mw, y0, y1, ctypes.c_int64(total)))


def _ptrs(arrays: list) -> np.ndarray:
    return np.array([a.ctypes.data for a in arrays], dtype=np.uintp)


def roll_frames(map_rois: list, btn_rois: list) -> tuple:
    """A batch's BGRA map and button ROI views as roll_band reads them,
    checked once for all its bands: the views (kept alive by the tuple),
    their pointers and row pitches, and the shapes (mh, mw, bh, bw)."""
    n = len(map_rois)
    assert n == len(btn_rois) and n >= 1
    for roi in (*map_rois, *btn_rois):
        assert roi.dtype == np.uint8 and roi.ndim == 3 and roi.shape[2] == 4
        assert roi.strides[2] == 1 and roi.strides[1] == 4
    mh, mw = map_rois[0].shape[:2]
    bh, bw = btn_rois[0].shape[:2]
    assert all(m.shape[:2] == (mh, mw) for m in map_rois) and all(b.shape[:2] == (bh, bw) for b in btn_rois)
    return (
        map_rois, btn_rois, _ptrs(map_rois), np.array([m.strides[0] for m in map_rois], np.int64),
        _ptrs(btn_rois), np.array([b.strides[0] for b in btn_rois], np.int64), (mh, mw, bh, bw),
    )


def roll_band(
    frames: tuple, roll: np.ndarray, y0: int, y1: int, dirty: np.ndarray,
    idx: np.ndarray, data: np.ndarray, cnt: np.ndarray,
) -> None:
    """Roll the map rows [y0, y1) of pack_diff_roll's flat layout (over the
    whole map) through a batch of frames (roll_frames), in place in `roll`,
    which the bands of one batch share: each writes only its own rows'
    bytes. Frame f's entries go to idx[f] (int32, bitwise NOT where
    unchanged) and data[f] (32 B payloads), counted per plane in cnt[f]:
    its changed sub-chunks, and the partial ones at the band's edges and
    sub-chunk 0 changed or not, gathered before the next frame overwrites
    them. The band with the map's last rows also rolls the button and the
    zero tail. dirty: the band's own u8 scratch of roll.size // 32; idx
    [frames, cap] and data [frames, cap, 32] with cap >= roll_band_cap.
    roll_merge joins the bands."""
    lib = load()
    assert lib is not None
    maps, _, map_ptrs, map_pitch, btn_ptrs, btn_pitch, (mh, mw, bh, bw) = frames
    n = len(maps)
    assert roll.dtype == np.uint8 and roll.flags.c_contiguous and roll.size % 32 == 0
    assert roll.size >= (mh * mw + bh * bw) * 3
    cap = roll_band_cap(mh, mw, y0, y1, roll.size)
    assert dirty.dtype == np.uint8 and dirty.size >= roll.size // 32
    assert idx.dtype == np.int32 and idx.flags.c_contiguous and idx.shape[0] >= n and idx.shape[1] >= cap
    assert data.dtype == np.uint8 and data.flags.c_contiguous and data.shape == (*idx.shape, 32)
    assert cnt.dtype == np.int32 and cnt.flags.c_contiguous and cnt.shape[0] >= n and cnt.shape[1] == 3
    lib.smh_roll_band(
        map_ptrs.ctypes.data, map_pitch.ctypes.data, btn_ptrs.ctypes.data, btn_pitch.ctypes.data,
        n, mh, mw, bh, bw, ctypes.c_int64(roll.size), y0, y1, roll.ctypes.data, dirty.ctypes.data,
        ctypes.c_int64(idx.shape[1]), idx.ctypes.data, data.ctypes.data, cnt.ctypes.data,
    )


def roll_merge(
    idxs: list, datas: list, cnts: list, n_frames: int, bucket: int = 0, out: "np.ndarray | None" = None,
) -> np.ndarray:
    """Join the row bands' roll_band entries (idxs, datas, cnts: one of each
    a band, in the order of their rows) of each of n_frames frames: one
    ascending list of changed sub-chunks a frame, an edge sub-chunk's
    entries ORed. -> int32 [n_frames]: each frame's count of changed
    sub-chunks. With bucket > 0, also writes the batch delta buffer `out`
    ([B*bucket int32 indices | B*bucket 32 B payloads]): row f < n_frames
    holds frame f's sub-chunks padded to `bucket` by repeating the last
    (sub-chunk 0 where the frame did not change); the rows past n_frames
    are the caller's."""
    lib = load()
    assert lib is not None
    assert idxs and len(idxs) == len(datas) == len(cnts)
    for idx, data, cnt in zip(idxs, datas, cnts):
        assert idx.dtype == np.int32 and idx.flags.c_contiguous and idx.shape[0] >= n_frames >= 1
        assert data.dtype == np.uint8 and data.flags.c_contiguous and data.shape == (*idx.shape, 32)
        assert cnt.dtype == np.int32 and cnt.flags.c_contiguous and cnt.shape[0] >= n_frames and cnt.shape[1] == 3
    rows = 0
    if bucket > 0:
        assert out is not None and out.dtype == np.uint8 and out.flags.c_contiguous
        rows = out.size // (bucket * 36)
        assert out.size == rows * bucket * 36 and rows >= n_frames
    counts = np.empty(n_frames, np.int32)
    caps = np.array([idx.shape[1] for idx in idxs], np.int64)
    pi, pd, pc = _ptrs(idxs), _ptrs(datas), _ptrs(cnts)  # held until the call returns
    lib.smh_roll_merge(
        len(idxs), n_frames, pi.ctypes.data, pd.ctypes.data, pc.ctypes.data, caps.ctypes.data, int(bucket), rows, out.ctypes.data if bucket > 0 else None, counts.ctypes.data,
    )
    return counts
