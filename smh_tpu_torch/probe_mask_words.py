"""Kernel 7's device time on the card, in turns with another tree's build.

Builds csrc/mask_words.cu as it is and, with --against DIR,
DIR/smh_tpu_torch/csrc/mask_words.cu, each into its own library under
smh_tpu_torch/build/probe-*, holds both to the plain twin, and prints each
build's device time per call (torch.profiler, the kernel's row) in turns on
sparse masks (a marker line's share of non-zero words) and a dense one at
the 1080p and 4K map shapes (822 x 986 and 1644 x 1972), at the sparse
ladder's starting budget, and on B = 8 sparse masks at 822 x 986. Needs a
CUDA device and nvcc:

    python -m smh_tpu_torch.probe_mask_words [--against DIR]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess

import numpy as np
import torch

from . import _build, _probe
from .ops import kernels as K

SOURCE = _build.CSRC / "mask_words.cu"
BUDGET = 1024  # vision/cuda_backend.py::_SPARSE_BUDGETS[_SP_RUNG_DEFAULT]


def launcher(lib, bits: torch.Tensor, w: int):
    """A call of lib's smh_mask_words on bits, as kernels.mask_bbox_sparse
    makes it, and its output."""
    bsz = bits.shape[0] if bits.dim() == 3 else 1
    out = torch.empty((*bits.shape[:-2], K.MASK_META + 2 * BUDGET), dtype=torch.int32, device=bits.device)
    stride = K._frame_stride((bits,))

    def call():
        code = lib.smh_mask_words(bits.data_ptr(), stride, bits.shape[-2], w, bsz, BUDGET, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(code, "smh_mask_words")

    return call, out


def device_us(call, calls: int = 50) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "mask_words" in e.key) / calls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=pathlib.Path, help="a tree whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_mask_words needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    builds = {"as built": {SOURCE.name: SOURCE.read_text()}}
    if args.against is not None:
        builds["against"] = {SOURCE.name: (args.against / "smh_tpu_torch" / "csrc" / SOURCE.name).read_text()}
    libs = _probe.build(builds, (SOURCE.name,), ptxas_of="as built")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    cases = [(1, 822, 986, 0.0005), (1, 822, 986, 0.5), (1, 1644, 1972, 0.0005), (1, 1644, 1972, 0.5),
             (8, 822, 986, 0.0005)]
    for bsz, h, w, density in cases:
        bits = torch.from_numpy(np.packbits(rng.random((bsz, h, w)) < density, axis=-1)).to(dev)
        bits = bits if bsz > 1 else bits[0]
        want = K.mask_bbox_sparse_plain(bits, w, BUDGET)
        calls = {}
        for name, lib in libs.items():
            call, out = launcher(lib, bits, w)
            call()
            if not torch.equal(out, want):
                raise SystemExit(f"{name} != plain at B={bsz} {h}x{w} density {density}")
            calls[name] = call
        for rep in range(2):
            order = list(calls) if rep == 0 else list(reversed(calls))
            times = {name: device_us(calls[name]) for name in order}
            print(f"B={bsz} {h}x{w} density {density} (nz {int(want.reshape(-1, want.shape[-1])[0, 6])}) round {rep}: "
                  + ", ".join(f"{name} {times[name]:.2f}" for name in calls) + " us per call", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
