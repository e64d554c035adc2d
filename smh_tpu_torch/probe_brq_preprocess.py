"""Where kernel 6's device time goes, on the card, and what its variants
cost.

Builds csrc/brq_preprocess.cu as it is, with a variant that keeps its
outputs (without the register cap of 4 blocks a SM), with parts of it switched off
(the checksums' global atomics; the output stores; the R, G, B loads) and,
with --against DIR, DIR/smh_tpu_torch/csrc/brq_preprocess.cu (another
commit's kernel, or any copy of the file under DIR/smh_tpu_torch/csrc),
each into its own library under smh_tpu_torch/build/probe-*, and prints
each build's device time per call (torch.profiler, the kernel's own row;
the checksums' memset is printed apart) in turns, on the quadrants of
random text-like maps at 1080p and 4K (411 x 493 and 822 x 986) and on B =
8 quadrants of 411 x 493. The builds that keep the outputs are held to the
plain twin first; the ablations compute wrong outputs: they only time.
Needs a CUDA device and nvcc:

    python -m smh_tpu_torch.probe_brq_preprocess [--against DIR]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess

import numpy as np
import torch

from . import _build, _probe, consts as C, testing
from .ocr.engine import OCR_BINARY_THRESHOLD
from .ops import kernels as K

SOURCE = _build.CSRC / "brq_preprocess.cu"
_BOUNDS = ("__global__ void __launch_bounds__(THREADS, 4)\n", "__global__ void __launch_bounds__(THREADS)\n")
_ATOMICS = ("  if (tid < 4) atomicAdd(check + tid, sums[tid]);\n", "")
_STORES = (
    "    if (inside) {\n      const int64_t at = (int64_t)y * w + x;\n",
    "    if (inside && v == 7u) {\n      const int64_t at = (int64_t)y * w + x;\n",
)
_BITS = ("    if (lane < 4 && col < bpr) {\n", "    if (lane < 4 && col < bpr && word == 7u) {\n")
_LOADS = (
    "      rgb[i] = __ldg(r8 + off) | (uint32_t)__ldg(g8 + off) << 8 | (uint32_t)__ldg(b8 + off) << 16;\n",
    "      rgb[i] = (uint32_t)off * 0x9e3779b9u;\n",
)
# variant: (patches, keeps the outputs)
VARIANTS = {
    "as built": ((), True),
    "no register cap": ((_BOUNDS,), True),
    "no checksum atomics": ((_ATOMICS,), False),
    "no output stores": ((_STORES, _BITS), False),
    "no plane loads": ((_LOADS,), False),
}


def build_variants(against: pathlib.Path | None = None) -> dict:
    """{variant: ctypes library}; one nvcc per variant, all started
    together; "against" is DIR's kernel."""
    builds = {name: _probe.patched(_build.CSRC, (SOURCE.name,), {SOURCE.name: list(p)}) for name, (p, _) in
              VARIANTS.items()}
    if against is not None:
        builds["against"] = {SOURCE.name: (against / "smh_tpu_torch" / "csrc" / SOURCE.name).read_text()}
    return _probe.build(builds, (SOURCE.name,), ptxas_of="as built")


def launcher(lib, planes: tuple):
    """A call of lib's smh_brq_preprocess on (r, g, b, luma), as
    kernels.brq_preprocess makes it, and the outputs it writes."""
    r8, g8, b8, luma = planes
    h, w = r8.shape[-2:]
    lead = r8.shape[:-2]
    bsz = r8.shape[0] if r8.dim() == 3 else 1
    pitch, stride = K._strided_planes((r8, g8, b8))
    lpitch, lstride = K._strided_planes((luma,))
    bpr = (w + 7) // 8
    spack = torch.empty((*lead, h * bpr + h * w), dtype=torch.uint8, device=r8.device)
    planes_out = torch.empty((2, *lead, h, w), dtype=torch.uint8, device=r8.device)
    scheck = torch.empty((*lead, 4), dtype=torch.int32, device=r8.device)

    def call():
        code = lib.smh_brq_preprocess(
            r8.data_ptr(), g8.data_ptr(), b8.data_ptr(), pitch, stride, luma.data_ptr(), lpitch, lstride,
            spack.data_ptr(), h * bpr + h * w, planes_out[0].data_ptr(), planes_out[1].data_ptr(), h * w,
            scheck.data_ptr(), h, w, bsz, 0, h, C.OCR_PREPROCESS_MONOCHROMATICY_THRESHOLD,
            C.OCR_PREPROCESS_BRIGHTNESS_THRESHOLD, C.OCR_PREPROCESS_SIMILARITY_EDGE_THRESHOLD,
            C.OCR_PREPROCESS_BRIGHTNESS_EDGE_THRESHOLD, OCR_BINARY_THRESHOLD, torch.cuda.current_stream().cuda_stream,
        )
        _build.check(code, "smh_brq_preprocess")

    return call, lambda: K._brq_outputs(spack, planes_out[0], planes_out[1], scheck, h, w)


def device_us(call, calls: int = 50) -> dict:
    """{profiler row: device us per call} over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {("kernel" if "brq_preprocess" in e.key else e.key): e.self_device_time_total / calls for e in rows}


def quadrants(rng, dev, bsz: int, h: int, w: int) -> tuple:
    """(r, g, b, luma) windows of the bottom-right quadrant of B random
    text-like maps h x w, plane-major in the rows of one buffer."""
    rows = torch.zeros((bsz, 3 * h * w), dtype=torch.uint8, device=dev)
    for i in range(bsz):
        rgb = testing.text_rgb(rng, h, w, 0.2)
        rows[i] = torch.from_numpy(np.moveaxis(rgb[..., ::-1], -1, 0).reshape(-1)).to(dev)
    planes = rows.view(bsz, 3, h, w)
    b8, g8, r8 = planes[:, 0], planes[:, 1], planes[:, 2]
    luma = K.classify_luma_planes_plain(r8, g8, b8)[1]
    out = tuple(p[:, h // 2 :, w // 2 :] for p in (r8, g8, b8, luma))
    return out if bsz > 1 else tuple(p[0] for p in out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_brq_preprocess needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build_variants(args.against)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for bsz, h, w in ((1, 822, 986), (1, 1644, 1972), (8, 822, 986)):
        planes = quadrants(rng, dev, bsz, h, w)
        want = K.brq_preprocess_plain(*planes)
        calls = {}
        for name, lib in libs.items():
            call, outputs = launcher(lib, planes)
            call()
            if name == "against" or VARIANTS[name][1]:
                got = outputs()
                if not all(torch.equal(got[k], want[k]) for k in want):
                    raise SystemExit(f"{name} != plain at B={bsz} {h // 2}x{w // 2}")
            calls[name] = call
        for rep in range(2):
            order = list(calls) if rep == 0 else list(reversed(calls))
            times = {name: device_us(calls[name]) for name in order}
            kernel = ", ".join(f"{name} {times[name]['kernel']:.2f}" for name in calls)
            other = {k: round(v, 2) for k, v in times["as built"].items() if k != "kernel"}
            print(f"B={bsz} {h // 2}x{w // 2} round {rep}: kernel us per call: {kernel}; memset {other}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
