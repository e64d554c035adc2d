"""The vision backend contract (the reference's `Vision` trait).

Counterpart of the reference's vision-common/src/lib.rs:30-61 adapted to
Python: images are numpy arrays (or lazy fetchers for display-only outputs),
errors are exceptions. Implemented by:

  * vision.reference.ReferenceBackend — the numpy oracle
  * vision.cuda_backend.CudaBackend   — the PyTorch + CUDA path

Optional capabilities the driver probes with hasattr():
  * set_debug(bool)                — materialize debug intermediates
  * scales_enabled: bool           — OCR payload on/off (heightmap mode)
  * minimap_rect() -> Rect|None    — device-computed minimap bounds
  * _find_longest_lines_batch(...) — batched seed marching
"""

from __future__ import annotations

from typing import Callable, Optional, Protocol, Union, runtime_checkable

import numpy as np

from ..geometry import Line, Point

# crop_to_map may return the RGBA ui image eagerly, or a zero-arg fetcher
# that materializes it on demand (it is display-only, not detection-path).
UiMap = Union[np.ndarray, Callable[[], np.ndarray]]


@runtime_checkable
class VisionBackend(Protocol):
    name: str

    def thread_ctx(self) -> None:
        """Per-thread backend state (no-op everywhere but kept for parity:
        the reference needed per-rayon-thread CUDA contexts)."""

    def load_frame(self, frame_bgra: np.ndarray) -> None:
        """Ingest a BGRA u8 [H, W, 4] frame (reallocates on resize)."""

    def get_cpu_frame(self) -> np.ndarray:
        """The current frame as a host array (minimap fallback path)."""

    def crop_to_map(self, grayscale: bool) -> Optional[tuple[UiMap, tuple[int, int, int, int]]]:
        """Red-button gate + crops. None => map closed ("sleeping")."""

    def ocr_preprocess(self) -> np.ndarray:
        """Whiteish-text isolation of the BRQ -> gray u8 for the OCR engine."""

    def find_scales_preprocess(self, scales_start_y: int) -> np.ndarray:
        """Binarized BRQ for the scale-bar scan."""

    def isolate_map_markers(self) -> None:
        """Blacken non-marker pixels (may be fused into crop_to_map)."""

    def mask_marker_lines(self) -> None:
        """Produce the dilated binary LSD mask (may be fused)."""

    def find_longest_line(self, mask: np.ndarray, pt: Point, max_gap: float) -> tuple[Line, float]:
        """3600-ray march from a seed; returns (line, squared length)."""

    def find_marker_lines(self, max_gap: int) -> list[Line]:
        """Full seed scan -> detected marker lines."""

    def get_debug_view(self, choice) -> Optional[np.ndarray]:
        """One of the 5 intermediate images as RGBA, or None."""
