"""CUDA vision backend: the port's counterpart of smh_tpu's TpuBackend.

Implements the consume surface VisionState._process uses
(smh_tpu/vision/pipeline.py) on top of the fused PyTorch pass:

  * load_frame packs the map ROI as plane-major BGR plus the interleaved-BGR
    button ROI into one flat host buffer (the native pack, else numpy);
  * dispatch uploads it with ONE host-to-device copy and runs ONE
    `analyze_packed_flat` (two CUDA kernels + PyTorch ops, one stream);
  * crop_to_map copies the hostpack back with one synchronous `.cpu()` and
    parses it: red gate, checksums, the sparse (or full-plane) LSD mask, the
    device-read scale records and the minimap rect;
  * the markers come from the native host LSD (`native.find_lines`) on the
    bbox slice of the reconstructed mask; the scale ratio from the decoded
    records, or — for engines that do not read on device, or a device read
    that lost structure — from the host engine over the lazily fetched
    scalespack.

Not ported yet: the delta upload, the pipelined loop (snapshot_job and the
async copy), the window-crop rungs, the binary/gray/band scales transports,
debug views and the device ray march.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smh_tpu import consts as C
from smh_tpu import native

from .. import resolve_device
from ..ops import pipeline as ops_pipeline
from ..ops import scales_device as ops_scales_device

# Maps whose full bit-mask is at most this many bytes skip the sparse
# transport (tiny frames: the full plane is already small).
_MIN_WINDOWED_MASK_BYTES = 16 * 1024
# The flat upload is padded to a multiple of this many bytes: the native
# packer needs whole 32 B sub-chunks, and 128 gives smh_tpu's buffer size.
_PACK_PAD = 128

# -- sparse mask transport (copy of smh_tpu/vision/tpu_backend.py) -------------
# The LSD mask travels as its compacted nonzero u32 words under a word budget
# rung ladder: escalate on overflow (that frame falls back to fetching the
# full bit-mask) or when a frame nears the budget, shrink after a streak.
_SPARSE_BUDGETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
_SP_RUNG_DEFAULT = 2  # 1024 words
_SP_SLACK_NUM, _SP_SLACK_DEN = 5, 4  # escalate when nz * 5/4 > budget
_SP_OFF_AFTER = 3  # consecutive misses before sparse steps aside
_SP_WARM_MAX = _SP_RUNG_DEFAULT + 2  # highest rung proactive escalation reaches
_SHRINK_AFTER = 30  # fitting frames before a rung shrinks / probation length


def _pack_rois_bgr(map_roi: np.ndarray, btn_roi: np.ndarray, pad_to: int) -> np.ndarray:
    """Flatten both BGRA ROI views into one u8 buffer: the map as plane-major
    BGR (B, G, R planes), the button ROI interleaved BGR, zeroed padding up
    to a multiple of pad_to (smh_tpu's _pack_rois_bgr / _split_planes without
    the cv2 fast path)."""
    mh, mw = map_roi.shape[:2]
    bh, bw = btn_roi.shape[:2]
    msz = mh * mw
    used = msz * 3 + bh * bw * 3
    total = ((used + pad_to - 1) // pad_to) * pad_to
    packed = np.empty(total, dtype=np.uint8)
    packed[used:] = 0
    for c in range(3):
        packed[c * msz : (c + 1) * msz].reshape(mh, mw)[...] = map_roi[..., c]
    packed[msz * 3 : used].reshape(bh, bw, 3)[...] = btn_roi[..., :3]
    return packed


class _AdaptState:
    """Cross-frame transport adaptation + display caches (the fields of
    smh_tpu's _AdaptState this backend uses: the sparse rung ladder and the
    ui-map cache). One object, so a later consume view can share it."""

    __slots__ = (
        "ui_check", "ui_map_cache",
        "sp_rung", "sp_streak", "sp_miss_streak", "sp_probation",
    )

    def __init__(self) -> None:
        self.ui_check: Optional[tuple] = None
        self.ui_map_cache: Optional[np.ndarray] = None
        self.sp_rung = _SP_RUNG_DEFAULT
        self.sp_streak = 0  # comfortably-fitting frames (shrink hysteresis)
        self.sp_miss_streak = 0  # consecutive misses (dense-content detector)
        self.sp_probation = 0  # frames since sparse stepped aside


class CudaBackend:
    name = "cuda"

    def __init__(self, device="cuda") -> None:
        """device: "cuda" / "cuda:N" runs the CUDA kernels; "cpu" runs their
        plain PyTorch versions. Raises when CUDA is asked for and absent, and
        when the native host module (the LSD engine) is unavailable."""
        self.device = resolve_device(device)
        if not native.available():
            raise RuntimeError("CudaBackend needs the native host module (native.find_lines)")
        self._templates = ops_scales_device.templates_to_device(
            ops_scales_device.device_templates(), self.device
        )
        self.frame_np: Optional[np.ndarray] = None
        self.geom: Optional[C.MapGeometry] = None
        self._pending: Optional[np.ndarray] = None  # packed host buffer to upload
        self._rois: Optional[torch.Tensor] = None  # the uploaded buffer
        self._results: Optional[dict] = None
        self._host: Optional[dict] = None  # parsed hostpack sections
        self._scalespack_host: Optional[np.ndarray] = None
        self._lsd_crop_host: Optional[np.ndarray] = None  # u8 0/255 crop
        self._lsd_offset: tuple[int, int] = (0, 0)  # (x, y) of crop in map
        self._grayscale = True
        self._dispatch_flags: tuple = (True, True, True, "none", None)
        self._adapt = _AdaptState()
        self.stats = {
            "lsd_window_misses": 0,
            "lsd_sparse_misses": 0,
            "scalespack_fetches": 0,
            "scales_band_misses": 0,
            "frames": 0,
            "delta_frames": 0,
            "full_uploads": 0,
            "h2d_bytes": 0,
            "device_scales_frames": 0,
            "device_scales_fallbacks": 0,
        }
        # Set per frame by VisionState._prepare.
        self.scales_enabled = True  # off: heightmap mode or no OCR engine
        self.scales_device_ok = False  # engine replaceable by the device read
        self.quiet_enabled = True  # minimap cadence

    # -- lifecycle -------------------------------------------------------------

    def set_debug(self, enabled: bool) -> None:
        if enabled:
            raise NotImplementedError("debug views are not ported to the CUDA backend yet")

    def thread_ctx(self) -> None:
        """No-op: every tensor and launch names its device explicitly."""

    def load_frame(self, frame_bgra: np.ndarray) -> None:
        if frame_bgra.dtype != np.uint8 or frame_bgra.ndim != 3 or frame_bgra.shape[2] != 4:
            raise ValueError("expected a BGRA u8 [H, W, 4] frame")
        h, w = frame_bgra.shape[:2]
        if self.geom is None or (self.geom.frame_w, self.geom.frame_h) != (w, h):
            self.geom = C.map_geometry(w, h)
        g = self.geom
        self.frame_np = frame_bgra
        map_roi = frame_bgra[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
        btn_roi = frame_bgra[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
        if frame_bgra.strides[2] == 1 and frame_bgra.strides[1] == 4:
            used = (g.map_h * g.map_w + g.btn_h * g.btn_w) * 3
            packed = np.empty(((used + _PACK_PAD - 1) // _PACK_PAD) * _PACK_PAD, np.uint8)
            native.pack_diff(map_roi, btn_roi, packed, None, None, None)
        else:
            packed = _pack_rois_bgr(map_roi, btn_roi, _PACK_PAD)
        self._pending = packed
        self._results = None
        self._host = None
        self._scalespack_host = None
        self._lsd_crop_host = None

    def get_cpu_frame(self) -> np.ndarray:
        assert self.frame_np is not None
        return self.frame_np

    # -- sparse rung ladder ------------------------------------------------------

    def _sparse_budget(self) -> Optional[int]:
        """Word budget for THIS dispatch, or None for the full-plane mask
        (tiny maps, or dense content that made sparse step aside).
        Steps the probation counter: call exactly once per dispatch."""
        a = self._adapt
        g = self.geom
        mask_bytes = g.map_h * ((g.map_w + 7) // 8)
        if mask_bytes <= _MIN_WINDOWED_MASK_BYTES:
            return None
        if a.sp_probation > 0:  # stepped aside: re-probe periodically
            a.sp_probation += 1
            if a.sp_probation <= _SHRINK_AFTER:
                return None
            a.sp_probation = 0
            a.sp_miss_streak = 0
        # Largest rung that still undercuts shipping the full plane.
        a.sp_rung = min(a.sp_rung, len(_SPARSE_BUDGETS) - 1)
        budget = _SPARSE_BUDGETS[a.sp_rung]
        while budget * 8 >= mask_bytes and a.sp_rung > 0:
            a.sp_rung -= 1
            budget = _SPARSE_BUDGETS[a.sp_rung]
        if budget * 8 >= mask_bytes:
            return None
        return budget

    def _adapt_sp_rung(self, nz: int, budget: int) -> None:
        """Escalate proactively within the 5/4 slack (capped at
        _SP_WARM_MAX), escalate on a miss, shrink after a sustained streak;
        the rung is always clamped to the ladder."""
        a = self._adapt
        top = len(_SPARSE_BUDGETS) - 1
        need = nz * _SP_SLACK_NUM // _SP_SLACK_DEN
        want = 0
        for i, b in enumerate(_SPARSE_BUDGETS):
            want = i
            if b >= need:
                break
        if nz > budget:
            a.sp_miss_streak += 1
            a.sp_rung = min(max(a.sp_rung + 1, want), top)
            a.sp_streak = 0
            if a.sp_miss_streak >= _SP_OFF_AFTER:
                a.sp_probation = 1  # dense content: step aside, re-probe later
            return
        a.sp_miss_streak = 0
        if want > a.sp_rung:
            a.sp_rung = min(want, top, max(a.sp_rung, _SP_WARM_MAX))
            a.sp_streak = 0
        elif want < a.sp_rung:
            a.sp_streak += 1
            if a.sp_streak >= _SHRINK_AFTER:
                a.sp_rung -= 1
                a.sp_streak = 0
        else:
            a.sp_streak = 0

    # -- stages ----------------------------------------------------------------

    def dispatch(self, grayscale: Optional[bool] = None) -> None:
        """Upload the loaded frame (if not yet uploaded) and queue the fused
        pass on the device's current stream."""
        if self.geom is None or (self._pending is None and self._rois is None):
            raise RuntimeError("dispatch before load_frame")
        if grayscale is not None:
            self._grayscale = grayscale
        g = self.geom
        if self._pending is not None:
            packed, self._pending = self._pending, None
            self._rois = torch.from_numpy(packed).to(self.device)
            self.stats["full_uploads"] += 1
            self.stats["h2d_bytes"] += packed.size
        sparse = self._sparse_budget()
        inline = "device" if (self.scales_enabled and self.scales_device_ok) else "none"
        self._dispatch_flags = (
            self.scales_enabled, self.quiet_enabled, self._grayscale, inline, sparse,
        )
        self._results = ops_pipeline.analyze_packed_flat(
            self._rois,
            map_h=g.map_h,
            map_w=g.map_w,
            btn_h=g.btn_h,
            btn_w=g.btn_w,
            grayscale=self._grayscale,
            with_ocr=self.scales_enabled,
            with_quiet=self.quiet_enabled,
            scales_inline=inline,
            sparse_budget=sparse,
            templates=self._templates,
        )

    def crop_to_map(self, grayscale: bool) -> Optional[tuple]:
        if self.geom is None:
            raise RuntimeError("crop_to_map before load_frame")
        g = self.geom
        if self._results is None or self._grayscale != grayscale:
            self._grayscale = grayscale
            self.dispatch()
        with_ocr, with_quiet, _, inline, sparse = self._dispatch_flags
        pack = self._results["hostpack"].cpu().numpy()  # the one D2H per frame
        layout = ops_pipeline.hostpack_layout(
            g.map_h, g.map_w, with_ocr=with_ocr, with_quiet=with_quiet,
            scales_inline=inline, sparse_budget=sparse,
        )

        def sect(name):
            off, size = layout[name]
            return pack[off : off + size]

        red_ratio = float(sect("red_ratio").view(np.float32)[0])
        if red_ratio < C.CLOSE_DEPLOYMENT_BUTTON_RED_PIXEL_THRESHOLD:
            return None

        self.stats["frames"] += 1
        y0, y1, x0, x1, _cy0, _cx0 = (int(v) for v in sect("lsd_meta").view(np.int32))
        self._host = {
            "ui_check": tuple(int(v) for v in sect("ui_check").view(np.uint32)),
            "lsd_bbox": (y0, y1, x0, x1),
        }
        if with_ocr:
            self._host["scales_check"] = tuple(int(v) for v in sect("scales_check").view(np.uint32))
            if inline == "device":
                self._host["scales_records"] = ops_scales_device.decode_records(
                    sect("scales_rec").view(np.int16)
                )
        if with_quiet:
            self._host["minimap_rect"] = tuple(int(v) for v in sect("minimap_rect").view(np.int32))

        if y0 >= y1 or x0 >= x1:  # empty mask
            self._host["lsd_crop_bits"] = None
            self._host["lsd_offset"] = (0, 0)
            self._host["lsd_crop_shape"] = (0, 0)
            if sparse is not None:
                self._adapt_sp_rung(int(sect("lsd_nz").view(np.int32)[0]), sparse)
        else:
            if sparse is not None:
                nz = int(sect("lsd_nz").view(np.int32)[0])
                if nz <= sparse:
                    # Exact reconstruction of the full bit plane.
                    bits = ops_pipeline.sparse_mask_host(
                        nz,
                        sect("lsd_sp_idx").view(np.int32),
                        sect("lsd_sp_dat").view(np.uint32),
                        g.map_h,
                        g.map_w,
                    )
                else:
                    # Sparse miss: fetch the full bit-mask (one extra copy).
                    self.stats["lsd_sparse_misses"] += 1
                    bits = self._results["lsd_bits"].cpu().numpy()
                self._adapt_sp_rung(nz, sparse)
            else:
                bits = sect("lsd_crop").reshape(g.map_h, (g.map_w + 7) // 8)
            self._host["lsd_crop_bits"] = bits
            self._host["lsd_offset"] = (0, 0)
            self._host["lsd_crop_shape"] = (g.map_h, g.map_w)

        # The ui map is display-only: a lazy fetcher, reused while the
        # device checksum is unchanged.
        results = self._results
        ui_check_host = self._host["ui_check"]
        adapt = self._adapt

        def fetch_ui_map() -> np.ndarray:
            check = (*ui_check_host, grayscale)
            if (
                adapt.ui_map_cache is not None
                and check == adapt.ui_check
                and adapt.ui_map_cache.shape[:2] == (g.map_h, g.map_w)
            ):
                return adapt.ui_map_cache
            ui = results["ui"].cpu().numpy()
            ui_map = np.empty((g.map_h, g.map_w, 4), dtype=np.uint8)
            if ui.ndim == 2:
                ui_map[..., 0] = ui_map[..., 1] = ui_map[..., 2] = ui
            else:
                ui_map[..., :3] = ui
            ui_map[..., 3] = 255
            adapt.ui_check = check
            adapt.ui_map_cache = ui_map
            return ui_map

        return fetch_ui_map, (g.map_x, g.map_y, g.map_w, g.map_h)

    def minimap_rect(self):
        """Minimap bounds computed on the device in the fused pass, or None
        when the dispatch skipped it."""
        from smh_tpu.geometry import Rect

        if self._host is None or self.geom is None or "minimap_rect" not in self._host:
            return None
        if self.geom.map_w < 3 or self.geom.map_h < 3:
            return None
        l, t, r, b = self._host["minimap_rect"]
        return Rect(left=l, top=t, right=r, bottom=b)

    # -- scales branch ------------------------------------------------------------

    def scales_check(self) -> Optional[tuple]:
        """Device-computed checksum of (scales binarize, OCR image)."""
        if self._host is None:
            return None
        return self._host.get("scales_check")

    def scales_fingerprint(self) -> Optional[int]:
        check = self.scales_check()
        if check is None:
            return None
        return hash(check) & 0xFFFFFFFF

    def device_scales(self):
        """(ocr_results, ratio) read on the device this frame, or None when
        the dispatch packed no records or they lost structure with no trusted
        read (the caller then takes the image path)."""
        dev = (self._host or {}).get("scales_records")
        if dev is None:
            return None
        ratio = ops_scales_device.ratio_from_records(dev)
        if ratio is not None or dev.complete:
            self.stats["device_scales_frames"] += 1
            return dev.words, ratio
        self.stats["device_scales_fallbacks"] += 1
        return None

    def _fetch_scalespack(self) -> np.ndarray:
        if self._scalespack_host is None:
            if self._results is None or "scalespack" not in self._results:
                raise RuntimeError("scales branch consumed but the dispatch packed no scalespack")
            self._scalespack_host = self._results["scalespack"].cpu().numpy()
            self.stats["scalespack_fetches"] += 1
        return self._scalespack_host

    def ocr_preprocess(self) -> np.ndarray:
        g = self.geom
        off, size = ops_pipeline.scalespack_layout(g.map_h, g.map_w)["ocr_img"]
        return self._fetch_scalespack()[off : off + size].reshape(g.brq_h, g.brq_w)

    def find_scales_preprocess(self, scales_start_y: int) -> np.ndarray:
        """The binarized BRQ as 0/255 u8 (bit-unpacked)."""
        g = self.geom
        off, size = ops_pipeline.scalespack_layout(g.map_h, g.map_w)["scales_bits"]
        bits = self._fetch_scalespack()[off : off + size].reshape(g.brq_h, (g.brq_w + 7) // 8)
        return ops_pipeline.unpack_bits_host(bits, g.brq_w) * np.uint8(255)

    # -- markers branch -------------------------------------------------------------

    def isolate_map_markers(self) -> None:
        """Fused into the crop_to_map dispatch."""

    def mask_marker_lines(self) -> None:
        """Unpacks only the mask-bbox slice of the reconstructed mask."""
        bits = self._host["lsd_crop_bits"]
        if bits is None:  # empty mask
            self._lsd_crop_host = np.zeros((0, 0), dtype=np.uint8)
            self._lsd_offset = (0, 0)
            return
        self._lsd_crop_host, self._lsd_offset = ops_pipeline.bbox_crop_host(
            bits,
            self._host["lsd_bbox"],
            self._host["lsd_offset"],
            self._host["lsd_crop_shape"],
        )

    def find_marker_lines(self, max_gap: int) -> list:
        if self._lsd_crop_host is None:
            self.mask_marker_lines()
        crop = self._lsd_crop_host
        if crop.size == 0:
            return []
        g = self.geom
        return native.find_lines(
            crop, max_gap, full_shape=(g.map_h, g.map_w), offset=self._lsd_offset
        )
