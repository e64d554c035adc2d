"""The plain numpy backend: every stage of the per-frame pipeline.

A frozen copy of the counterpart of upstream's CPU backend
(vision-cpu/src/lib.rs:55-461): a straightforward, exact implementation of
each stage, slow where that is simpler.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import consts as C
from .geometry import Line, Point
from . import lsd, pixmath as pm

F32 = np.float32


def find_longest_line(mask: np.ndarray, pt: Point, max_gap: float) -> tuple[Line, float]:
    """Ray-march LSD_NUM_ANGLES rays from `pt`, return the longest segment.

    Vectorized over angles but stepped sequentially with float32
    accumulation, reproducing vision-cpu/src/lib.rs:387-449 exactly:
      * pixel sampled at trunc(pos) before each advance;
      * a gap run is tolerated until it reaches max_gap+1 consecutive
        non-white pixels, at which point the ray aborts and restores the
        position of the run's first pixel;
      * on plain out-of-bounds exit, the final positional check clamps
        negative coords to 0 (Rust saturating `as u32`), and a non-black
        (or out-of-bounds) final pixel yields a zero-length line;
      * ties between angles resolve to the *last* longest (the reference's
        fold keeps the right operand on ties).
    """
    h, w = mask.shape
    n = C.LSD_NUM_ANGLES

    theta = (np.arange(n, dtype=F32) / F32(10.0)) * (F32(np.pi) / F32(180.0))
    dx = np.cos(theta).astype(F32)
    dy = np.sin(theta).astype(F32)

    x_start = F32(pt.x)
    y_start = F32(pt.y)

    x = np.full(n, x_start, dtype=F32)
    y = np.full(n, y_start, dtype=F32)
    x_off = np.zeros(n, dtype=F32)
    y_off = np.zeros(n, dtype=F32)
    gap0 = np.zeros(n, dtype=F32)
    gap_sx = np.zeros(n, dtype=F32)
    gap_sy = np.zeros(n, dtype=F32)
    done = np.zeros(n, dtype=bool)

    wf = F32(w)
    hf = F32(h)
    max_gap_f = F32(max_gap)

    while True:
        active = ~done
        if not active.any():
            break

        inb = (x >= 0) & (y >= 0) & (x < wf) & (y < hf)
        done |= active & ~inb  # out-of-bounds exit: keep current pos
        act = active & inb
        if not act.any():
            continue

        white = np.zeros(n, dtype=bool)
        xi = x[act].astype(np.int64)
        yi = y[act].astype(np.int64)
        white[act] = mask[yi, xi] == 255

        black = act & ~white
        abort = black & (gap0 >= max_gap_f)
        start_gap = black & ~abort & (gap0 == 0)
        cont_gap = black & ~abort & (gap0 != 0)

        # Abort: restore the saved run-start position and stop this lane.
        x = np.where(abort, gap_sx, x)
        y = np.where(abort, gap_sy, y)
        done |= abort

        reset = act & white
        gap_sx = np.where(start_gap, x, np.where(reset, F32(0.0), gap_sx))
        gap_sy = np.where(start_gap, y, np.where(reset, F32(0.0), gap_sy))
        gap0 = np.where(
            reset, F32(0.0), np.where(start_gap, F32(1.0), np.where(cont_gap, gap0 + F32(1.0), gap0))
        )

        adv = act & ~abort
        x_off = np.where(adv, x_off + dx, x_off)
        y_off = np.where(adv, y_off + dy, y_off)
        x = np.where(adv, x_off + x_start, x)
        y = np.where(adv, y_off + y_start, y)

    # Final check (vision-cpu:426-429): Rust `f32 as u32` saturates negatives
    # to zero, so a ray that exited leftward/upward re-checks the clamped cell.
    xi = np.where(x < 0, F32(0.0), x).astype(np.int64)
    yi = np.where(y < 0, F32(0.0), y).astype(np.int64)
    inb = (xi < w) & (yi < h)
    pix_black = np.zeros(n, dtype=bool)
    pix_black[inb] = mask[yi[inb], xi[inb]] == 0

    x_end = np.where(pix_black, x - dx, x_start)
    y_end = np.where(pix_black, y - dy, y_start)

    lengths = (x_start - x_end) ** 2 + (y_start - y_end) ** 2  # f32
    best = n - 1 - int(np.argmax(lengths[::-1]))  # last max wins on ties

    line = Line(
        Point(float(x_start), float(y_start)),
        Point(float(x_end[best]), float(y_end[best])),
    )
    return line, float(lengths[best])


class ReferenceBackend:
    """Numpy implementation of the vision backend contract.

    Mirrors the `Vision` trait (upstream vision-common/src/lib.rs:30-61)
    adapted to Python: images are numpy arrays, errors are exceptions.
    """

    name = "numpy"

    def __init__(self) -> None:
        self.frame: Optional[np.ndarray] = None  # BGRA u8 [H, W, 4]
        self.geom: Optional[C.MapGeometry] = None
        self.cropped_map: Optional[np.ndarray] = None  # RGB u8 [mh, mw, 3]
        self.cropped_brq: Optional[np.ndarray] = None  # RGB u8 [bh, bw, 3]
        self.ocr_out: Optional[np.ndarray] = None  # gray u8
        self.scales_preprocessed: Optional[np.ndarray] = None  # gray u8
        self.lsd_image: Optional[np.ndarray] = None  # gray u8

    # -- lifecycle ---------------------------------------------------------

    def thread_ctx(self) -> None:
        """No-op; kept for backend-contract parity (vision-cpu:64-67)."""

    def load_frame(self, frame_bgra: np.ndarray) -> None:
        assert frame_bgra.dtype == np.uint8 and frame_bgra.ndim == 3 and frame_bgra.shape[2] == 4
        h, w = frame_bgra.shape[:2]
        if self.geom is None or (self.geom.frame_w, self.geom.frame_h) != (w, h):
            self.geom = C.map_geometry(w, h)
        self.frame = frame_bgra

    def get_cpu_frame(self) -> np.ndarray:
        assert self.frame is not None
        return self.frame

    # -- stages ------------------------------------------------------------

    def crop_to_map(self, grayscale: bool) -> Optional[tuple[np.ndarray, tuple[int, int, int, int]]]:
        """Red-button gate + three crops (vision-cpu:110-171).

        Returns (ui_map RGBA, (x, y, w, h) of the map ROI) or None when the
        deployment map is closed ("sleeping").
        """
        g = self.geom
        frame = self.frame
        assert g is not None and frame is not None

        btn = frame[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
        red = pm.close_button_red_mask(pm.bgra_to_rgb(btn))
        red_ratio = F32(np.int64(red.sum())) / F32(g.btn_w * g.btn_h)
        if red_ratio < F32(C.CLOSE_DEPLOYMENT_BUTTON_RED_PIXEL_THRESHOLD):
            return None

        map_view = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
        self.cropped_map = np.ascontiguousarray(pm.bgra_to_rgb(map_view))
        self.cropped_brq = np.ascontiguousarray(
            pm.bgra_to_rgb(
                frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
            )
        )

        ui_map = np.empty((g.map_h, g.map_w, 4), dtype=np.uint8)
        if grayscale:
            l8 = pm.luma8(self.cropped_map)
            ui_map[..., 0] = l8
            ui_map[..., 1] = l8
            ui_map[..., 2] = l8
        else:
            ui_map[..., :3] = self.cropped_map
        ui_map[..., 3] = 255

        return ui_map, (g.map_x, g.map_y, g.map_w, g.map_h)

    def ocr_preprocess(self) -> np.ndarray:
        assert self.cropped_brq is not None
        self.ocr_out = pm.ocr_preprocess(self.cropped_brq)
        return self.ocr_out

    def find_scales_preprocess(self, scales_start_y: int) -> np.ndarray:
        assert self.cropped_brq is not None
        self.scales_preprocessed = pm.find_scales_binarize(self.cropped_brq)
        return self.scales_preprocessed

    def isolate_map_markers(self) -> None:
        assert self.cropped_map is not None
        keep = pm.is_any_map_marker_color(self.cropped_map)
        self.cropped_map = np.where(keep[..., None], self.cropped_map, np.uint8(0))

    def mask_marker_lines(self) -> None:
        assert self.cropped_map is not None
        mask = pm.is_any_map_marker_color(self.cropped_map)
        self.lsd_image = pm.dilate_l1_radius1(np.where(mask, np.uint8(255), np.uint8(0)))

    def find_longest_line(self, mask: np.ndarray, pt: Point, max_gap: float) -> tuple[Line, float]:
        return find_longest_line(mask, pt, max_gap)

    def find_marker_lines(self, max_gap: int) -> list[Line]:
        assert self.lsd_image is not None
        return lsd.find_lines(self.lsd_image, max_gap, self.find_longest_line)
