"""Where kernel 6's device time goes, on the card, what its variants cost,
and its chain floor; with --against, beside another tree's kernel, in turns.

Builds csrc/brq_preprocess.cu as it is, with variants that keep its
outputs (a register cap of 64, 4 blocks an SM; 16-row tiles, or 8-row
tiles, at every shape, where the kernel takes 8-row tiles only where
16-row tiles would leave SMs idle), with parts of it switched off (the checksums' atomics; the output stores; the
plane loads; everything: an empty kernel of the same grid) and with longer
chains (CHAIN: 32 more block barriers, 32 more dependent global atomics),
and with --against DIR, DIR/smh_tpu_torch/csrc/brq_preprocess.cu (another
commit's kernel: its entry may take no scratch and clear the checks with a
memset, as its first design did), each into its own library under
smh_tpu_torch/build/probe-*, and prints each build's device time per call
(chip_smoke.device_profile: every CUDA row of the call, so a memset
counts) and its CUDA launches per call, in turns (against, as built, as
built, against; then the variants), on the quadrants of random text-like
maps at 1080p and 4K (411 x 493 and 822 x 986) and on B = 8 quadrants of
411 x 493 cut from the rows of one buffer. Builds that keep the outputs are
held to the plain twin first, over two calls (the second shows that the
scratch came back clean); the ablations compute wrong outputs and only
time. Then the chain floor (chain_floor): the launch, one dependent load
(a pointer chase), CHAIN_STEPS of each step, beside the kernel. Run from
the root of a checkout (the chase and the profiler come from
probe_scales_read and chip_smoke.py). Needs a CUDA device and nvcc:

    python -m smh_tpu_torch.probe_brq_preprocess [--against DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from . import _build, _probe, consts as C, testing
from .ocr.engine import OCR_BINARY_THRESHOLD
from .ops import kernels as K
from .probe_scales_read import CHASE, load_latency_us
from .probe_scales_read import VARIANTS as _SCALES_VARIANTS

SOURCE = _build.CSRC / "brq_preprocess.cu"
_BOUNDS = ("__global__ void __launch_bounds__(THREADS)\n", "__global__ void __launch_bounds__(THREADS, 4)\n")
_SMALL = "  const bool small = cols * ((h + TH - 1) / TH) * B <= n_sm;\n"
_ATOMICS = ("  if (tid < 4) {  // checksum tid", "  if (h > 0) return;  // probe\n  if (tid < 4) {  // checksum tid")
_STORES = ("  if (lane == 0) return;\n  const int s", "  if (lane >= 0) return;  // probe\n  const int s")
_BITS = ("      bits[(int64_t)y * bpr + col] = (uint8_t)byte;\n", "")
_LOADS = ("  if (x < 0 || x >= w) return 0u;\n  const uintptr_t a",
          "  if (w > 0) return (uint32_t)(reinterpret_cast<uintptr_t>(row) + x) * 0x9e3779b9u;  // probe\n"
          "  const uintptr_t a")
_EMPTY = ("  const int64_t f = blockIdx.z;\n  r8 += f * stride;", "  if (h > 0) return;  // probe\n"
          "  const int64_t f = blockIdx.z;\n  r8 += f * stride;")
_BEFORE_DILATE = "  // The dilate along the rows, with the neighbour words' carry bits.\n"
_FINAL = "      check[tid] = (uint32_t)(old + v);"
# variant: (patches, keeps the outputs)
VARIANTS = {
    "as built": ((), True),
    "a register cap of 64": ((_BOUNDS,), True),
    "16-row tiles everywhere": (((_SMALL, "  const bool small = n_sm < 0;  // probe\n"),), True),
    "8-row tiles everywhere": (((_SMALL, "  const bool small = n_sm > 0;  // probe\n"),), True),
    "ablation: no checksum atomics": ((_ATOMICS,), False),
    "ablation: no output stores": ((_STORES, _BITS), False),
    "ablation: no plane loads": ((_LOADS,), False),
    "ablation: empty": ((_EMPTY,), False),
}
# Timing variants that lengthen the chain by N more of one dependent step:
# (time - as built) / N is that step's latency on the card.
CHAIN = {
    "chain: 32 more block barriers": (32, "block barrier", (
        (_BEFORE_DILATE, "  for (int i = 0; i < 32; ++i) __syncthreads();  // probe\n" + _BEFORE_DILATE),)),
    "chain: 32 more dependent atomics": (32, "global atomic", (
        (_FINAL, "      unsigned long long u = 0ull;  // probe\n"
                 "      for (int i = 0; i < 32; ++i) u = atomicAdd(slot + (u >> 63), 0ull);\n"
                 "      if (u == 1ull) check[tid] = 0u;\n" + _FINAL),)),
}
VARIANTS.update({name: (patches, False) for name, (_n, _step, patches) in CHAIN.items()})
VARIANTS[CHASE] = (tuple(_SCALES_VARIANTS[CHASE]), False)
# The steps of one tile's chain that the design cannot overlap: the launch
# (the empty kernel), one load round trip (every plane and luma load is
# issued before any is used), the three block barriers (the staged words,
# the dilate, the partial sums), and one global atomic that returns a value
# (a checksum's count-and-sum add, whose last adder writes the sum).
CHAIN_STEPS = {"launch": 1, "dependent load": 1, "block barrier": 3, "global atomic": 1}


def build_variants(against: pathlib.Path | None = None) -> dict:
    """{variant: ctypes library}; one nvcc per variant, all started
    together; "against" is DIR's kernel."""
    builds = {name: _probe.patched(_build.CSRC, (SOURCE.name,), {SOURCE.name: list(p)}) for name, (p, _) in
              VARIANTS.items()}
    if against is not None:
        builds["against"] = {SOURCE.name: (against / "smh_tpu_torch" / "csrc" / SOURCE.name).read_text()}
    libs = _probe.build(builds, (SOURCE.name,), ptxas_of="as built")
    if against is not None and "void* scratch" not in builds["against"][SOURCE.name]:
        fn = libs["against"].smh_brq_preprocess  # the entry before the scratch: no scratch argument
        fn.argtypes = [t for i, t in enumerate(_build._SIGNATURES["smh_brq_preprocess"]) if i != 14]
    return libs


def launcher(lib, planes: tuple):
    """A call of lib's smh_brq_preprocess on (r, g, b, luma), as
    kernels.brq_preprocess makes it (with a scratch of the probe's own where
    the entry takes one), and the outputs it writes."""
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
    fn = lib.smh_brq_preprocess
    scratch = torch.zeros(K.BRQ_SCRATCH * bsz, dtype=torch.int32, device=r8.device)
    takes_scratch = len(fn.argtypes) == len(_build._SIGNATURES["smh_brq_preprocess"])

    def call():
        extra = (scratch.data_ptr(),) if takes_scratch else ()  # the closure keeps the scratch alive
        code = fn(
            r8.data_ptr(), g8.data_ptr(), b8.data_ptr(), pitch, stride, luma.data_ptr(), lpitch, lstride,
            spack.data_ptr(), h * bpr + h * w, planes_out[0].data_ptr(), planes_out[1].data_ptr(), h * w,
            scheck.data_ptr(), *extra, h, w, bsz, 0, h, C.OCR_PREPROCESS_MONOCHROMATICY_THRESHOLD,
            C.OCR_PREPROCESS_BRIGHTNESS_THRESHOLD, C.OCR_PREPROCESS_SIMILARITY_EDGE_THRESHOLD,
            C.OCR_PREPROCESS_BRIGHTNESS_EDGE_THRESHOLD, OCR_BINARY_THRESHOLD, torch.cuda.current_stream().cuda_stream,
        )
        _build.check(code, "smh_brq_preprocess")

    return call, lambda: K._brq_outputs(spack, planes_out[0], planes_out[1], scheck, h, w)


def quadrants(rng, dev, bsz: int, h: int, w: int) -> tuple:
    """(r, g, b, luma) windows of the bottom-right quadrant of B random
    text-like maps h x w, plane-major in the rows of one buffer whose rows
    lie an odd number of bytes apart."""
    rows = torch.zeros((bsz, 3 * h * w + 37), dtype=torch.uint8, device=dev)
    for i in range(bsz):
        rgb = testing.text_rgb(rng, h, w, 0.2)
        rows[i, : 3 * h * w] = torch.from_numpy(np.moveaxis(rgb[..., ::-1], -1, 0).reshape(-1)).to(dev)
    planes = rows[:, : 3 * h * w].view(bsz, 3, h, w)
    b8, g8, r8 = planes[:, 0], planes[:, 1], planes[:, 2]
    luma = K.classify_luma_planes_plain(r8, g8, b8)[1]
    out = tuple(p[:, h // 2 :, w // 2 :] for p in (r8, g8, b8, luma))
    return out if bsz > 1 else tuple(p[0] for p in out)


def chain_floor(libs: dict, planes: tuple, profile) -> dict:
    """The chain floor on these planes: each step of CHAIN_STEPS timed on the
    card (profile: chip_smoke.device_profile) and counted. libs: {variant:
    library} holding "as built", "ablation: empty", the CHAIN variants and
    the chase."""
    us = {n: profile(launcher(libs[n], planes)[0], n=50)["us"] for n in ("as built", "ablation: empty", *CHAIN)}
    latency = {"launch": us["ablation: empty"],
               "dependent load": load_latency_us(libs[CHASE], profile, planes[0].device)}
    for name, (n, step, _patches) in CHAIN.items():
        latency[step] = (us[name] - us["as built"]) / n
    floor = sum(k * latency[step] for step, k in CHAIN_STEPS.items())
    return {"kernel_us": us["as built"], "latency_us": latency, "steps": CHAIN_STEPS, "floor_us": floor}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_brq_preprocess needs a CUDA device")
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = build_variants(args.against)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    summary, chain = [], None
    for bsz, h, w in ((1, 822, 986), (1, 1644, 1972), (8, 822, 986)):
        planes = quadrants(rng, dev, bsz, h, w)
        label = f"B={bsz} {h // 2}x{w // 2}"
        want = K.brq_preprocess_plain(*planes)
        calls = {}
        for name, lib in libs.items():
            if name == CHASE:
                continue
            call, outputs = launcher(lib, planes)
            if name == "against" or VARIANTS[name][1]:
                for rep in range(2):
                    call()
                    got = outputs()
                    if not all(torch.equal(got[k], want[k]) for k in want):
                        raise SystemExit(f"{name} != plain at {label}, call {rep}")
            calls[name] = call
        order = (["against"] if "against" in calls else []) + ["as built"]
        order = order + order[::-1] + [n for n in calls if n not in order and not n.startswith("chain")]
        times = {n: [] for n in order}
        launches = {}
        for name in order:
            prof = cs.device_profile(calls[name], n=50)
            times[name].append(prof["us"])
            launches[name] = prof["launches"]
        print(f"{label}: device us per call: " + "; ".join(
            f"{n} " + " / ".join(f"{t:.2f}" for t in ts) + f" ({launches[n]:.0f} launches)" for n, ts in times.items()),
            flush=True)
        summary.append({"input": label, "device_us": times, "launches_per_call": launches, "card": card})
        if bsz == 1 and h == 822:
            chain = chain_floor(libs, planes, cs.device_profile)
            print(f"chain floor at {label}: " + " + ".join(
                f"{k} x {step} {chain['latency_us'][step]:.3f}" for step, k in CHAIN_STEPS.items())
                + f" = {chain['floor_us']:.2f} us beside the kernel's {chain['kernel_us']:.2f} us", flush=True)
    print(json.dumps({"inputs": summary, "chain": chain}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
