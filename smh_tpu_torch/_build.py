"""Build and load the port's hand-written CUDA kernels.

Every `smh_tpu_torch/csrc/*.cu` file is compiled by its own `nvcc` process
(all started together, `-I csrc` for the shared `*.cuh` headers) and the
objects are linked into ONE shared library with a plain C interface, loaded
with ctypes. The library lands in `smh_tpu_torch/build/<hash>/`, keyed by a
hash of the sources, the headers and the flags, so an unchanged checkout
builds once and a changed source or header never loads a stale binary. The
build runs at first use (the first CUDA launch), never at import: the CPU
tests import every module on machines with no `nvcc`.

Each C entry point takes its pointers and the CUDA stream as `void*` and
returns `cudaGetLastError()` after its launch; `check()` turns a non-zero
code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

from .utils.timeshares import WORK, add, span

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "build"
LIB_NAME = "libsmh_torch_kernels.so"

# -O3 without --use_fast_math keeps `/` correctly rounded; the float kernels
# also spell every multiply/add/divide as a __f*_rn intrinsic, which nvcc
# never contracts into an FMA (the classify kernel must be bit-exact).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# C signatures of the entry points (every pointer and the stream as void*).
_SIGNATURES = {
    # () -> bytes of the classify tables
    "smh_classify_tables_bytes": [],
    # (tables, params, stream)
    "smh_classify_tables": [_VP, _VP, _VP],
    # (r, g, b, marker, luma, n, B, in_stride, out_stride, tables, stream);
    # the strides are between the B frames, in bytes
    "smh_classify_luma": [_VP, _VP, _VP, _VP, _VP, _I64, _I, _I64, _I64, _VP, _VP],
    # (p0, p1, p2, scratch, out, B, H, W, frame_stride (bytes), out_stride (i32s), stream)
    "smh_quiet_walk": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I64, _I64, _VP],
    # (r, g, b, bits, H, W, B, in_stride, out_stride, tables, stream)
    "smh_fused_mask": [_VP, _VP, _VP, _VP, _I, _I, _I, _I64, _I64, _VP, _VP],
    # (mask, H, W, pts, B, cos, sin, N, max_gap, k_total, end_x, end_y,
    #  best_x, best_y, best_len, stream)
    "smh_ray_march": [_VP, _I, _I, _VP, _I, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    # smh_ray_march on the oracle's positions (the offset accumulated a step at a time)
    "smh_ray_march_acc": [_VP, _I, _I, _VP, _I, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    # (masks, mask_stride (bytes), H, W, pts, B, ...): smh_ray_march with
    # seed b's mask at masks + b * mask_stride
    "smh_ray_march_masks": [_VP, _I64, _I, _I, _VP, _I, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    # (text, text_stride, sbool, sbool_stride (bytes between frames), tpl, T,
    #  H, W, B, budget, out, stream)
    "smh_scales_read": [_VP, _I64, _VP, _I64, _VP, _I, _I, _I, _I, _I, _VP, _VP],
    # (r, g, b, pitch, stride, luma, luma_pitch, luma_stride, spack,
    #  spack_stride, text, sbool, plane_stride, scheck, scratch, h, w, B,
    #  row0, total_h, mono, bright, edge_mono, edge_bright, text_threshold,
    #  stream); pitches and strides in bytes
    "smh_brq_preprocess": [_VP, _VP, _VP, _I64, _I64, _VP, _I64, _I64, _VP, _I64, _VP, _VP, _I64, _VP, _VP,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    # (H, W) -> tiles of a frame, or -1 where the kernel does not take it
    "smh_mask_words_tiles": [_I, _I],
    # (bits, frame_stride (bytes), H, W, B, budget, scratch, scratch_words,
    #  out, stream)
    "smh_mask_words": [_VP, _I64, _I, _I, _I, _I, _VP, _I64, _VP, _VP],
    # (resident, bytes, buf, bucket, chunk, B, out, stream)
    "smh_delta_apply": [_VP, _I64, _VP, _I, _I, _I, _VP, _VP],
    # (p0, p1, p2, n_planes, step, pitch, stride, h, w, btn, btn_stride,
    #  btn_px, r, g, b, tol, table, n_sections, out, out_stride, red_off,
    #  ui_off, B, scratch, stream); steps, pitches and strides in bytes
    "smh_hostpack": [_VP, _VP, _VP, _I, _I64, _I64, _I64, _I, _I, _VP, _I64, _I, _I, _I, _I, _I, _VP, _I, _VP,
                     _I64, _I, _I, _I, _VP, _VP],
    # (bits, bits_stride (bytes), H, W, words, words_stride (i32s), crop_h,
    #  crop_w, margin, B, out, out_stride (bytes), stream)
    "smh_window_crop": [_VP, _I64, _I, _I, _VP, _I64, _I, _I, _I, _I, _VP, _I64, _VP],
    # (text, text_stride, sbits, sbits_stride, ocr, ocr_stride, h, w, band,
    #  binary, B, out, out_stride, stream); strides in bytes
    "smh_ocr_band": [_VP, _I64, _VP, _I64, _VP, _I64, _I, _I, _I, _I, _I, _VP, _I64, _VP],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build (None: cached)


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    """nvcc on PATH, else in $CUDA_HOME (default /usr/local/cuda), as
    PyTorch's own extension builder looks for it."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources() + headers():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_commands(objdir: pathlib.Path, nvcc: str = "nvcc") -> list[list[str]]:
    """One `nvcc -c` per source, each writing `<objdir>/<stem>.o`."""
    return [
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(objdir / f"{src.stem}.o")]
        for src in sources()
    ]


def link_command(out: pathlib.Path, objdir: pathlib.Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, "-shared", "-o", str(out), *(str(objdir / f"{s.stem}.o") for s in sources())]


def lib_path() -> pathlib.Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> pathlib.Path:
    """Compile the sources unless this hash is already built; return the .so."""
    global build_seconds
    out = lib_path()
    if out.exists():
        return out
    objdir = out.parent / f"obj.{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in compile_commands(objdir, nvcc)
    ]
    failures = []
    try:
        for proc in procs:
            log, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                failures.append(f"{' '.join(proc.args)} ({proc.returncode}):\n{log}")
    finally:
        for proc in procs:  # a timeout leaves no compiler behind
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if not failures:
        link = subprocess.run(
            link_command(tmp, objdir, nvcc), capture_output=True, text=True, timeout=300
        )
        if link.returncode != 0:
            failures.append(f"link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    shutil.rmtree(objdir, ignore_errors=True)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a torn file
    build_seconds = time.perf_counter() - t0
    add("setup.nvcc", WORK, t0, t0 + build_seconds)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (and found with no lock
    after it); the first call is the span `setup.kernels`, its build (on a
    cache miss) `setup.nvcc`."""
    global _lib
    if _lib is not None:
        return _lib
    with span("setup.kernels"), _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {code}")
