"""The port's per-frame pipeline: smh_tpu's VisionState with a backend
delegate that selects the CUDA backend.

smh_tpu.vision.pipeline.VisionState is backend-agnostic (it probes optional
capabilities with hasattr), so the port reuses it whole and only replaces
the delegate its constructor builds. Unlike smh_tpu's BackendDelegate, a
CUDA backend that fails to initialise raises: nothing falls back to numpy
behind the caller's back. (VisionState.process itself falls back only for a
backend named "tpu", so failures of the "cuda" backend propagate too.)
"""

from __future__ import annotations

from typing import Optional

from smh_tpu.settings import Settings
from smh_tpu.vision import pipeline as _pipeline
from smh_tpu.vision.pipeline import VisionLoop  # noqa: F401  (the loop is backend-agnostic)
from smh_tpu.vision.reference import ReferenceBackend

from .. import resolve_device
from .cuda_backend import CudaBackend


class TorchBackendDelegate(_pipeline.BackendDelegate):
    """hardware_acceleration selects CudaBackend on `device`, otherwise the
    numpy reference backend. Backend init failures propagate."""

    def __init__(self, settings: Settings, device) -> None:
        super().__init__(settings)
        self._device = resolve_device(device)

    def current(self):
        want = "cuda" if self._settings.hardware_acceleration() else "numpy"
        if self._backend is None or self._backend.name != want:
            self._backend = CudaBackend(self._device) if want == "cuda" else ReferenceBackend()
        return self._backend


class VisionState(_pipeline.VisionState):
    """smh_tpu's per-frame pipeline running on the port's CUDA backend.

    device: "cuda" (default) / "cuda:N" runs the CUDA kernels; "cpu" runs
    their plain PyTorch versions. A CUDA device that is absent raises here."""

    def __init__(
        self,
        settings: Optional[Settings] = None,
        ocr_engine=None,
        device="cuda",
        **kwargs,
    ) -> None:
        super().__init__(settings=settings, ocr_engine=ocr_engine, **kwargs)
        self.delegate = TorchBackendDelegate(self.settings, device)
