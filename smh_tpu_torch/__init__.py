"""smh_tpu_torch — the PyTorch + CUDA port of smh_tpu for an NVIDIA H100.

The JAX package `smh_tpu` stays the reference; this package runs the live
frame -> markers + scales path on a CUDA device and imports no JAX:

  * smh_tpu_torch.ops     — the fused per-frame pass in PyTorch, the on-device
                            scales read, and the two hand-written CUDA kernels
                            (csrc/, built by _build.py with nvcc on first use)
  * smh_tpu_torch.vision  — CudaBackend and the VisionState that selects it

Host code that never imported JAX (the native module, the numpy oracle, the
pipeline loop, the OCR engines, capture) is reused from smh_tpu as it is.
The device is always explicit: there is no silent fall back from CUDA to
the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:N" or "cpu"); raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA device is available "
                "(pass device='cpu' to run the plain PyTorch path)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
