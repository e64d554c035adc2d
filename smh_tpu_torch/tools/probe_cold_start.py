"""Decompose the cold start: per-stage wall time of the FIRST frames.

A fresh process pays for its first frame far more than for the next ones
(PERF.md has the card's numbers). This probe times the steps that come
first, in order, so the dominant term gets a name: the interpreter's
start to main() (smh_tpu_torch imports torch, so that holds the torch
import; a fresh interpreter's `import torch` is timed beside it), the CUDA context, the kernels' library (`_build.load()`:
nvcc, or the cached .so), the native host module (g++, or its cached .so),
the classify tables, VisionState and CudaBackend construction, the first
H2D copy, and then the first three process() calls with the pipeline's
own stage waterfall.

    python -m smh_tpu_torch.tools.probe_cold_start [--res 4k|1440p|1080p]
        [--device cuda|cuda:N|cpu]

Prints one JSON line, seconds throughout. A step that the device does not
have (on the CPU: the CUDA context, the kernels' build, the tables and the
H2D copy) is null.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

IMPORT_TORCH = "import time; t0 = time.perf_counter(); import torch; print(time.perf_counter() - t0)"


def since_process_start() -> Optional[float]:
    """Seconds since this process started (Linux /proc, 10 ms ticks as a
    rule), None elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="4k", choices=["4k", "1440p", "1080p"])
    ap.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu" (the plain versions)')
    args = ap.parse_args(argv)
    w, h = {"4k": (3840, 2160), "1440p": (2560, 1440), "1080p": (1920, 1080)}[args.res]

    out: dict = {}
    to_main = since_process_start()
    out["to_main_s"] = None if to_main is None else round(to_main, 4)
    child = subprocess.run([sys.executable, "-c", IMPORT_TORCH], capture_output=True, text=True, check=True)
    out["import_torch_s"] = round(float(child.stdout), 4)
    import torch

    from .. import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out["device"] = str(dev)
    out["device_name"] = torch.cuda.get_device_name(dev) if cuda else "cpu"

    def timed(key: str, fn, on_cpu: bool = False):
        """Time fn() (synchronized on the card) into out[key]; null where
        the CPU has no such step."""
        if not (cuda or on_cpu):
            out[key] = None
            return None
        t0 = time.perf_counter()
        res = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        out[key] = round(time.perf_counter() - t0, 4)
        return res

    timed("cuda_context_s", lambda: torch.zeros(1, device=dev))
    from .. import _build

    lib = timed("kernel_build_s", _build.load)
    out["nvcc_s"] = None if _build.build_seconds is None else round(_build.build_seconds, 4)
    from .. import native

    timed("native_build_s", native.load, on_cpu=True)
    out["native_available"] = native.available()
    from ..ops import kernels as K

    timed("classify_tables_s", lambda: K._classify_tables(lib, dev))
    import numpy as np

    from .. import testing
    from ..ocr.smhocr import SmhOcrEngine
    from ..settings import Settings
    from ..squadex.capture import Frame
    from ..vision.pipeline import DebugBox, VisionState

    def build_state():
        settings = Settings(path=None)
        settings.set("hardware_acceleration", True, save=False)
        return VisionState(settings=settings, ocr_engine=SmhOcrEngine(), device=dev)

    state = timed("build_state_s", build_state, on_cpu=True)
    timed("build_backend_s", state.delegate.current, on_cpu=True)
    timed("first_h2d_s", lambda: torch.from_numpy(np.zeros((256, 256), np.uint8)).to(dev))

    frames = []
    for i in range(3):
        frames.append(
            testing.make_frame(
                w,
                h,
                marker_lines=[((120 + 7 * i, 150), (700 + 7 * i, 520))],
                scale_texts=[("300m", (60, 170))],
                scale_bars=[(60, 200, 120, 1)],
            )
        )

    try:
        for i in range(3):
            debug = DebugBox()
            t0 = time.perf_counter()
            res = state.process(Frame(frames[i], 96), debug=debug)
            total = time.perf_counter() - t0
            if res is None:
                raise RuntimeError(f"frame {i}: the map gate closed")
            out[f"frame{i}_s"] = round(total, 4)
            out[f"frame{i}_stages_s"] = {k: round(v, 4) for k, v in debug.timeshares.as_dict().items()}
            out[f"frame{i}_unattributed_s"] = round(
                total - sum(debug.timeshares.stages.values()), 4
            )
    finally:
        state.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
