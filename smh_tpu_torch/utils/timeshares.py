"""Per-stage wall-clock "timeshares" for the vision pipeline.

Counterpart of the reference's Timeshares struct + debug_waterfall! guard
(/root/reference/vision-common/src/debug.rs:3-29,
 /root/reference/src/vision/mod.rs:14-20,54-64). Stage names and legend
colors match so a UI can render the same waterfall.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional, Tuple

STAGES: Dict[str, Tuple[float, float, float]] = {
    "load_frame": (0.0, 1.0, 1.0),
    "crop_to_map": (1.0, 0.4, 0.0),
    "find_minimap": (0.0, 0.0, 1.0),
    "ocr_preprocess": (0.0, 0.35, 1.0),
    "ocr": (0.35, 0.0, 1.0),
    "find_scales_preprocess": (1.0, 0.0, 1.0),
    "calc_meters_to_px_ratio": (1.0, 0.0, 0.4),
    "isolate_map_markers": (0.0, 1.0, 0.0),
    "filter_map_marker_icons": (1.0, 0.65, 0.0),
    "mask_marker_lines": (1.0, 1.0, 0.0),
    "find_marker_lines": (1.0, 0.0, 0.0),
}


class Timeshares:
    """Mutable per-frame stage timing record (seconds)."""

    def __init__(self) -> None:
        self.entire_frame: Optional[float] = None
        self.stages: Dict[str, float] = {}

    def record(self, stage: str, seconds: float) -> None:
        self.stages[stage] = seconds

    def iter(self) -> Iterator[Tuple[str, Tuple[float, float, float], float]]:
        for name, color in STAGES.items():
            if name in self.stages:
                yield name, color, self.stages[name]

    def as_dict(self) -> Dict[str, float]:
        d = dict(self.stages)
        if self.entire_frame is not None:
            d["entire_frame"] = self.entire_frame
        return d


@contextlib.contextmanager
def timeshare(shares: Optional[Timeshares], stage: str):
    """Context manager recording elapsed wall time into `shares`."""
    if shares is None:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        shares.record(stage, time.perf_counter() - start)
