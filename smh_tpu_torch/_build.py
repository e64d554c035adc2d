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
    # (r, g, b, marker, luma, n, params, stream)
    "smh_classify_luma": [_VP, _VP, _VP, _VP, _VP, _I64, _VP, _VP],
    # (p0, p1, p2, colbits, rowbits, B, H, W, cy, lv, cx, lh, stream)
    "smh_quiet_walk": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP],
    # (r, g, b, bits, H, W, params, stream)
    "smh_fused_mask": [_VP, _VP, _VP, _VP, _I, _I, _VP, _VP],
    # (mask, H, W, pts, B, cos, sin, N, max_gap, k_total, end_x, end_y,
    #  best_x, best_y, best_len, stream)
    "smh_ray_march": [_VP, _I, _I, _VP, _I, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
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
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
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
