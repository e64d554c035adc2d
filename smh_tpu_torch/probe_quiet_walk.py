"""Where the quiet-walk kernel's device time goes, on the card.

Builds csrc/quiet_walk.cu as it is and with parts of it switched off (the
global loads of the staged tile, the byte-SIMD SAD, the last block's walks,
and all three), each into its own library under smh_tpu_torch/build/probe-*,
and prints each variant's device time per call (torch.profiler, the kernel's
own row; the scratch clear is printed apart) on random maps at the two map
shapes of 1080p and 4K, B=1 and 2. The variants compute wrong rects: they
only time. Needs a CUDA device and nvcc:

    python -m smh_tpu_torch.probe_quiet_walk
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import _build, _probe

SOURCE = _build.CSRC / "quiet_walk.cu"
# (what the patch removes, text to find, replacement)
_STAGE = (
    "(sh != 0 && reinterpret_cast<const uint8_t*>(al + 1) < row + W) ? al[1] : 0u;",
    "0u;",
)
_STAGE_V = ("v = __funnelshift_r(al[0], hi, 8 * sh);", "v = (uint32_t)(gx * 0x01010101 + gy) ^ hi ^ (uint32_t)sh;")
_SAD_BEGIN = "      uint32_t m = 0;  // bytewise max over the 8 neighbours' SADs\n"
_SAD_END = "      int rbits = 0;\n"
_TAIL = ("  // The last block of this batch element runs the walks.\n",
         "  return;\n  // The last block of this batch element runs the walks.\n")
VARIANTS = {
    "as built": (),
    "no tile loads": ("stage",),
    "no SAD": ("sad",),
    "no walks": ("tail",),
    "none of the three": ("stage", "sad", "tail"),
}
SHAPES = ((1, 822, 986), (2, 822, 986), (1, 1644, 1972), (2, 1644, 1972))


def patched(parts) -> str:
    src = SOURCE.read_text()

    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"probe patch does not apply: {old!r}")
        return text.replace(old, new)

    if "stage" in parts:
        src = sub(sub(src, *_STAGE), *_STAGE_V)
    if "sad" in parts:
        head, rest = src.split(_SAD_BEGIN)
        _, tail = rest.split(_SAD_END, 1)
        src = head + "      uint32_t m = ctr[0] ^ ctr[1] ^ ctr[2];\n" + _SAD_END + tail
    if "tail" in parts:
        src = sub(src, *_TAIL)
    return src


def build_variants() -> dict:
    """{variant: ctypes library}; one nvcc per variant, all started together."""
    return _probe.build({name: {SOURCE.name: patched(parts)} for name, parts in VARIANTS.items()}, (SOURCE.name,))


def device_us(lib, planes, calls: int = 50) -> dict:
    """{profiler row: device us per call} over `calls` C calls."""
    from torch.profiler import ProfilerActivity, profile

    bsz, h, w = planes[0].shape
    out = torch.empty((bsz, 4), dtype=torch.int32, device=planes[0].device)
    scratch = torch.empty(bsz * (w + h + 1), dtype=torch.int32, device=planes[0].device)

    def call():
        code = lib.smh_quiet_walk(*(p.data_ptr() for p in planes), scratch.data_ptr(), out.data_ptr(),
                                  bsz, h, w, h * w, 4, torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_quiet_walk")

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {("kernel" if "quiet_walk" in e.key else e.key): e.self_device_time_total / calls for e in rows}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_quiet_walk needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build_variants()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for bsz, h, w in SHAPES:
        planes = [torch.from_numpy(rng.integers(0, 256, (bsz, h, w), dtype=np.uint8)).to(dev) for _ in range(3)]
        for rep in range(2):
            times = {name: device_us(lib, planes) for name, lib in libs.items()}
            kernel = ", ".join(f"{name} {t['kernel']:.2f}" for name, t in times.items())
            clear = {k: round(v, 2) for k, v in times["as built"].items() if k != "kernel"}
            print(f"B={bsz} {h}x{w} round {rep}: kernel us per call: {kernel}; scratch clear {clear}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
