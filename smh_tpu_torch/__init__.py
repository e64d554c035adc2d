"""smh_tpu_torch — the PyTorch + CUDA port of smh_tpu for an NVIDIA H100.

The JAX package `smh_tpu` stays the reference; this package runs the live
frame -> markers + scales path on a CUDA device and imports neither JAX nor
anything of smh_tpu:

  * smh_tpu_torch.ops     — the fused per-frame pass in PyTorch, the on-device
                            scales read, the device ray march, and the wrappers
                            of the four hand-written CUDA kernels (csrc/, built
                            by _build.py with nvcc on first use)
  * smh_tpu_torch.vision  — CudaBackend, the driver (VisionState, VisionLoop)
                            that selects it, and the numpy oracle
  * the host half         — native/ (C++, built with g++ on first use), ocr/,
                            squadex/, web/, heightmaps/, utils/, consts,
                            geometry, settings, app, testing: the port's own
                            copies of smh_tpu's, pinned to them by the tests

The device is always explicit: there is no silent fall back from CUDA to
the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:N" or "cpu"); raises when a
    CUDA device is asked for and none is available, or "cuda:N" names a
    card that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA device is available "
                "(pass device='cpu' to run the plain PyTorch path)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r}: {torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
