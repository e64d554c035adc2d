"""CUDA vision backend: the port's counterpart of smh_tpu's TpuBackend.

Implements the consume surface VisionState._process uses
(smh_tpu/vision/pipeline.py) on top of the fused PyTorch pass:

  * load_frame packs the map ROI as plane-major BGR plus the interleaved-BGR
    button ROI into one flat host buffer (the native pack) and, once a
    frame is resident on the device, diffs it against the host mirror of
    that buffer: the upload is then only the changed 32 B sub-chunks (the
    delta transport, smh_tpu/vision/tpu_backend.py's), else the full buffer;
  * dispatch stages the upload through pinned memory, copies it to the
    device without blocking, runs ONE `analyze_packed_flat` (or
    `analyze_delta_flat`, which scatters the chunks into a fresh copy of the
    resident buffer first; three CUDA kernels + PyTorch ops, one stream) and
    starts the hostpack's copy back into pinned memory, with a CUDA event
    recorded behind it;
  * snapshot_job freezes the dispatched frame as a consume view, so the
    pipelined VisionLoop can submit frame N+1 while frame N is consumed;
  * crop_to_map waits on that frame's event only, then parses the hostpack:
    red gate, checksums, the LSD mask (sparse words, a window crop or the
    full plane; a sparse or window miss fetches the full bit plane), the
    scales sections (device-read records, or the binary / gray images whole
    or as a row band) and the minimap rect, and steps the transport ladders
    (sparse budget, 2-D window rungs, band rungs, inline -> checksum-only);
  * the markers come from the native host LSD (`native.find_lines`) on the
    bbox slice of the reconstructed mask, or with lsd_engine="cuda" from
    the host seed scan over the device ray march (ops/lsd.py, CUDA kernel
    4); the scale ratio from the decoded records, the inline images, or the
    lazily fetched scalespack (snapshot_scales_job hands the same to the
    async scales step);
  * set_debug(True) adds a debug re-pass that keeps the intermediates
    get_debug_view serves.

The transport choice is smh_tpu's TpuBackend's: sparse words unless
SMH_SPARSE=0 or dense content made them step aside, else the window
ladder; "device" scales for engines the device read replaces, else
"binary" (binary_ok engines) or "gray", banded for image-derived engines,
and "none" once the scales checksum is stable.
"""

from __future__ import annotations

import copy
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from smh_tpu import consts as C
from smh_tpu import native
from smh_tpu.geometry import Line, Point
from smh_tpu.vision import lsd
from smh_tpu.vision.reference import DebugView

from .. import resolve_device
from ..ops import lsd as ops_lsd
from ..ops import pipeline as ops_pipeline
from ..ops import scales_device as ops_scales_device

# Maps whose full bit-mask is at most this many bytes skip the windowing
# and sparse transports (tiny frames: the full plane is already small).
_MIN_WINDOWED_MASK_BYTES = 16 * 1024
# Extra headroom the next frame's window must have over this frame's bbox
# (marker lines grow under the player's drag).
_RUNG_SLACK = 64
# The OCR text band shrinks after a short stable streak (scale-label text
# height is fixed UI chrome; a wrong guess costs one fallback fetch).
_BAND_SHRINK_AFTER = 5
# Consecutive unchanged scales checksums before the scales/OCR images drop
# out of the inline hostpack (static map -> checksum-only transport).
_INLINE_STABLE_AFTER = 3

# -- delta upload (copy of smh_tpu/vision/tpu_backend.py) ------------------------
# The flat ROI buffer stays on the device; a frame uploads only the 32 B
# sub-chunks whose bytes changed against the host mirror of that buffer,
# as an int32 index table padded to a bucket of the ladder, then the chunks.
_DELTA_CHUNK = 128  # the flat buffer is padded to a multiple of this
_DELTA_SUB = 32  # upload granularity, bytes
_DELTA_MIN_BYTES = 1 << 20  # below this a full upload is already cheap
_DELTA_MAX_FRACTION = 0.5  # more change than this -> full upload
# Chunk-count buckets (in _DELTA_SUB units): x2 steps below 512, 1.5x-spaced
# intermediates above.
_DELTA_BUCKETS = tuple(
    sorted({16 << i for i in range(14)} | {48 << i for i in range(4, 13)})
)

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


def _sparse_mode() -> bool:
    return os.environ.get("SMH_SPARSE", "1") != "0"


def _dim_ladder(dim: int) -> list[int]:
    """Window rungs for one dimension: 1/16, 1/8, 1/4, 1/2, 3/4, full.
    Height and width adapt independently."""
    return [
        max(1, dim // 16), max(1, dim // 8), max(1, dim // 4),
        max(1, dim // 2), max(1, (dim * 3) // 4), dim,
    ]


_RUNG_HALF = 3  # ladder index of the dim//2 rung (the starting window)


def _rung_for(ladder: list[int], need: int) -> int:
    for i, d in enumerate(ladder):
        if d >= need:
            return i
    return len(ladder) - 1


# -- inline scales images (jax-free copies of smh_tpu/vision/tpu_backend.py) --


def _paste_band(band_img: np.ndarray, brq_h: int, b0: int, fill: int) -> np.ndarray:
    """Row band -> full-height canvas. Exact: every pixel the OCR engine or
    the bar scan can read lies inside the band."""
    canvas = np.full((brq_h, band_img.shape[1]), np.uint8(fill))
    canvas[b0 : b0 + band_img.shape[0]] = band_img
    return canvas


def _ocr_image_from_host(host: dict, g) -> Optional[np.ndarray]:
    """OCR input from the inline hostpack sections; None -> use scalespack."""
    band = host.get("scales_band")
    if band == "miss":
        return None
    if isinstance(band, tuple) and band[2]:  # textless: all background
        return np.full((g.brq_h, g.brq_w), np.uint8(255))
    if "ocr_img_inline" in host:
        img = host["ocr_img_inline"]
    elif "ocr_bits_inline" in host:
        img = ops_pipeline.binary_ocr_image_host(host["ocr_bits_inline"], g.brq_w)
    else:
        return None
    return _paste_band(img, g.brq_h, band[1], 255) if isinstance(band, tuple) else img


def _scales_image_from_host(host: dict, g) -> Optional[np.ndarray]:
    """Scales binarize (0/255) from the inline sections; None -> scalespack."""
    band = host.get("scales_band")
    if band == "miss":
        return None
    if isinstance(band, tuple) and band[2]:  # textless: nothing readable
        return np.zeros((g.brq_h, g.brq_w), dtype=np.uint8)
    if "scales_bits_inline" in host:
        img = ops_pipeline.unpack_bits_host(host["scales_bits_inline"], g.brq_w) * np.uint8(255)
        return _paste_band(img, g.brq_h, band[1], 0) if isinstance(band, tuple) else img
    return None


def _delta_bucket(n: int, n_chunks: int) -> Optional[int]:
    """Smallest ladder bucket holding n changed chunks, or None when the
    bucketed upload would not materially undercut a full upload."""
    for b in _DELTA_BUCKETS:
        if n <= b:
            if b >= n_chunks * _DELTA_MAX_FRACTION:
                return None
            return b
    return None


def _pack_rois_bgr(
    map_roi: np.ndarray, btn_roi: np.ndarray, pad_to: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    """Flatten both BGRA ROI views into one u8 buffer: the map as plane-major
    BGR (B, G, R planes), the button ROI interleaved BGR, zeroed padding up
    to a multiple of pad_to (smh_tpu's _pack_rois_bgr / _split_planes without
    the cv2 fast path). `out` recycles a pack-pool buffer of the right size."""
    mh, mw = map_roi.shape[:2]
    bh, bw = btn_roi.shape[:2]
    msz = mh * mw
    used = msz * 3 + bh * bw * 3
    total = ((used + pad_to - 1) // pad_to) * pad_to
    packed = out if out is not None and out.size == total else np.empty(total, dtype=np.uint8)
    packed[used:] = 0
    for c in range(3):
        packed[c * msz : (c + 1) * msz].reshape(mh, mw)[...] = map_roi[..., c]
    packed[msz * 3 : used].reshape(bh, bw, 3)[...] = btn_roi[..., :3]
    return packed


class _AdaptState:
    """Cross-frame transport adaptation + display caches (smh_tpu's
    _AdaptState without the relay's chain-depth counters), SHARED by
    reference between the backend and its consume views (snapshot_job), so
    a rung escalated while consuming frame N shapes frame N+1's dispatch.
    Every write is a single int or ref, atomic under the GIL."""

    __slots__ = (
        "ui_check", "ui_map_cache", "ladder_h", "ladder_w",
        "rung_h", "rung_w", "shrink_streak",
        "sp_rung", "sp_streak", "sp_miss_streak", "sp_probation",
        "scales_inline", "scales_last_check", "scales_stable",
        "band_rung", "band_streak", "band_probation",
    )

    def __init__(self) -> None:
        self.ui_check: Optional[tuple] = None
        self.ui_map_cache: Optional[np.ndarray] = None
        # The 2-D window rung ladder (per dimension, built per geometry).
        self.ladder_h: Optional[list[int]] = None
        self.ladder_w: Optional[list[int]] = None
        self.rung_h = _RUNG_HALF  # start at the 1/2 window
        self.rung_w = _RUNG_HALF
        self.shrink_streak = 0
        # The sparse word-budget rung ladder.
        self.sp_rung = _SP_RUNG_DEFAULT
        self.sp_streak = 0  # comfortably-fitting frames (shrink hysteresis)
        self.sp_miss_streak = 0  # consecutive misses (dense-content detector)
        self.sp_probation = 0  # frames since sparse stepped aside
        # Adaptive inline transport of the scales/OCR images.
        self.scales_inline = True
        self.scales_last_check = None
        self.scales_stable = 0
        # The OCR text-row band rung ladder over brq_h.
        self.band_rung = _RUNG_HALF
        self.band_streak = 0
        self.band_probation = 0


class _Flags(NamedTuple):
    """What one dispatch packed (the hostpack layout's inputs)."""

    with_ocr: bool
    with_quiet: bool
    grayscale: bool
    inline: str  # scales transport: none | device | binary | gray
    sparse: Optional[int]  # word budget, or None
    crop_h: Optional[int]  # window (None, None = full plane)
    crop_w: Optional[int]
    band: Optional[int]  # OCR row band height, or None


class CudaBackend:
    name = "cuda"

    def __init__(self, device="cuda", lsd_engine: str = "native") -> None:
        """device: "cuda" / "cuda:N" runs the CUDA kernels; "cpu" runs their
        plain PyTorch versions. lsd_engine: "native" (the C++ host march;
        "auto" means it, since the port requires the native module) or
        "cuda" (the device ray march, kernel 4, batched over seeds). Raises
        when CUDA is asked for and absent, and when the native host module
        (pack/diff and the LSD) is unavailable."""
        self.device = resolve_device(device)
        if not native.available():
            raise RuntimeError("CudaBackend needs the native host module (pack/diff, find_lines)")
        if lsd_engine == "auto":
            lsd_engine = "native"
        if lsd_engine not in ("native", "cuda"):
            raise ValueError(f"unknown lsd_engine {lsd_engine!r}")
        self.lsd_engine = lsd_engine
        self._templates = ops_scales_device.templates_to_device(
            ops_scales_device.device_templates(), self.device
        )
        self.frame_np: Optional[np.ndarray] = None
        self.geom: Optional[C.MapGeometry] = None
        self._results: Optional[dict] = None
        self._fetch: Optional[tuple] = None  # (host hostpack, CUDA event or None)
        self._host: Optional[dict] = None  # parsed hostpack sections
        self._scalespack_host: Optional[np.ndarray] = None
        self._lsd_crop_host: Optional[np.ndarray] = None  # u8 0/255 crop
        self._lsd_offset: tuple[int, int] = (0, 0)  # (x, y) of crop in map
        self._march_max_len: Optional[float] = None  # bbox diagonal bound
        self._debug = False
        self._grayscale = True
        self._dispatch_flags = _Flags(True, True, True, "none", None, None, None, None)
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
        # Delta upload chain (SMH_DELTA: auto|0|1; 1 forces it even for tiny
        # frames, 0 turns it off), owned by the submit half:
        #   _resident      device flat ROI buffer of the LAST DISPATCH (a
        #                  consume view keeps its own frame's)
        #   _mirror        host copy of _resident's contents (the diff base)
        #   _pending       what dispatch() must upload for the loaded frame
        #   _pending_host  host packed buffer of the loaded frame
        self.delta_mode = os.environ.get("SMH_DELTA", "auto")
        self._resident: Optional[torch.Tensor] = None
        self._mirror: Optional[np.ndarray] = None
        self._pending: Optional[tuple] = None
        self._pending_host: Optional[np.ndarray] = None
        # Retired delta-path mirrors, reusable as pack buffers. A buffer that
        # rode a full upload never comes back (smh_tpu's rule; here the
        # upload copies it into pinned memory first, so it would be safe,
        # but the chain stays the reference's).
        self._pack_pool: list[np.ndarray] = []
        self._mirror_recyclable = False
        self._diff_scratch: Optional[np.ndarray] = None  # changed sub-chunk indices
        self._dirty_scratch: Optional[np.ndarray] = None  # native diff bitmap
        # Set per frame by VisionState._prepare.
        self.scales_enabled = True  # off: heightmap mode or no OCR engine
        self.scales_binary_ok = False  # engine only thresholds: bit-packed OCR mask
        self.scales_image_derived = False  # engine reads pixels: the row band is exact
        self.scales_device_ok = False  # engine replaceable by the device read
        self.quiet_enabled = True  # minimap cadence

    # -- lifecycle -------------------------------------------------------------

    def set_debug(self, enabled: bool) -> None:
        """When enabled, crop_to_map also runs the debug re-pass that keeps
        the intermediates get_debug_view serves (extra device work and
        fetches), and the scales band is off."""
        self._debug = enabled

    def thread_ctx(self) -> None:
        """No-op: every tensor and launch names its device explicitly."""

    def _delta_active(self, total_bytes: int) -> bool:
        if self.delta_mode in ("0", "off"):
            return False
        if self.delta_mode in ("1", "on"):
            return True
        return total_bytes >= _DELTA_MIN_BYTES

    def _staging(self, nbytes: int) -> torch.Tensor:
        """A fresh host buffer for one upload: pinned when the device is a
        GPU, so the copy can run without blocking. Fresh per upload: the
        host allocator hands a pinned block out again only after the copy
        that read it has finished."""
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.device.type == "cuda")

    def load_frame(self, frame_bgra: np.ndarray) -> None:
        if frame_bgra.dtype != np.uint8 or frame_bgra.ndim != 3 or frame_bgra.shape[2] != 4:
            raise ValueError("expected a BGRA u8 [H, W, 4] frame")
        h, w = frame_bgra.shape[:2]
        if self.geom is None or (self.geom.frame_w, self.geom.frame_h) != (w, h):
            self.geom = C.map_geometry(w, h)
            self._adapt.ladder_h = None
            self._adapt.ladder_w = None
            self._resident = None  # resolution change: restart the chain
            self._mirror = None
            self._pack_pool.clear()
            self._mirror_recyclable = False
        g = self.geom
        self.frame_np = frame_bgra
        map_roi = frame_bgra[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
        btn_roi = frame_bgra[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
        used = (g.map_h * g.map_w + g.btn_h * g.btn_w) * 3
        total = ((used + _DELTA_CHUNK - 1) // _DELTA_CHUNK) * _DELTA_CHUNK
        n_sub = total // _DELTA_SUB
        fused = frame_bgra.strides[2] == 1 and frame_bgra.strides[1] == 4
        delta_eligible = (
            self._delta_active(total)
            and self._mirror is not None
            and self._mirror.size == total
            and self._resident is not None
        )
        if delta_eligible:
            if self._diff_scratch is None or self._diff_scratch.size < n_sub:
                self._diff_scratch = np.empty(n_sub, np.int32)
                self._dirty_scratch = np.empty(n_sub, np.uint8)
            scratch = self._diff_scratch

        # Diff against the HOST MIRROR of the device-resident buffer, not the
        # previous frame: a loaded-but-never-dispatched frame must not become
        # the diff base.
        if fused:
            # In-place rolling pack+diff when the mirror is a private host
            # buffer (it rode a delta upload) and the previous load WAS
            # dispatched. An undispatched in-place load already rolled the
            # mirror forward, out of step with the device: reseed the chain
            # with a full upload.
            inplace = delta_eligible and self._mirror_recyclable
            if inplace and self._pending is not None and self._pending_host is self._mirror:
                inplace = False
                delta_eligible = False
            if inplace:
                packed = self._mirror
            else:
                recycled = self._pack_pool.pop() if self._pack_pool else None
                packed = (
                    recycled
                    if recycled is not None and recycled.size == total
                    else np.empty(total, dtype=np.uint8)
                )
            if not delta_eligible:
                native.pack_diff(map_roi, btn_roi, packed, None, None, None)
            elif inplace:
                n = native.pack_diff_roll(map_roi, btn_roi, packed, self._dirty_scratch, scratch)
            else:
                n = native.pack_diff(
                    map_roi, btn_roi, packed, self._mirror, self._dirty_scratch, scratch
                )
        else:
            packed = _pack_rois_bgr(
                map_roi, btn_roi, _DELTA_CHUNK,
                out=self._pack_pool.pop() if self._pack_pool else None,
            )
            if delta_eligible:
                n = native.diff_subchunks(packed, self._mirror, scratch)

        delta = None
        if delta_eligible:
            if n == 0:
                scratch[0] = 0  # flags may still differ: a no-op chunk 0
                n = 1
            bucket = _delta_bucket(n, n_sub)
            if bucket is not None:
                buf = self._staging(4 * bucket + bucket * _DELTA_SUB)
                native.gather_subchunks(packed, scratch, n, bucket, buf.numpy())
                delta = (buf, bucket, buf.numel())
        if delta is not None:
            self._pending = ("delta", *delta)
        else:
            self._pending = ("full", packed, packed.size)
        self._pending_host = packed
        self._results = None
        self._fetch = None
        self._host = None
        self._scalespack_host = None
        self._lsd_crop_host = None

    def get_cpu_frame(self) -> np.ndarray:
        assert self.frame_np is not None
        return self.frame_np

    # -- window, sparse and band ladders -------------------------------------------

    def _crop_size(self) -> tuple[Optional[int], Optional[int]]:
        """The static LSD window for the next dispatch (None, None = full)."""
        a = self._adapt
        g = self.geom
        mask_bytes = g.map_h * ((g.map_w + 7) // 8)
        if mask_bytes <= _MIN_WINDOWED_MASK_BYTES:
            return None, None
        if a.ladder_h is None:
            a.ladder_h = _dim_ladder(g.map_h)
            a.ladder_w = _dim_ladder(g.map_w)
            a.rung_h = min(a.rung_h, len(a.ladder_h) - 1)
            a.rung_w = min(a.rung_w, len(a.ladder_w) - 1)
        ch = a.ladder_h[a.rung_h]
        cw = a.ladder_w[a.rung_w]
        if (ch, cw) == (g.map_h, g.map_w):
            return None, None
        return ch, cw

    def _adapt_rung(self, bh: int, bw: int) -> None:
        """Escalate immediately, shrink after a sustained streak; height and
        width adapt independently under one shared streak counter."""
        a = self._adapt
        if a.ladder_h is None:
            return
        pad = 2 * ops_pipeline.LSD_CROP_MARGIN + _RUNG_SLACK
        want_h = _rung_for(a.ladder_h, bh + pad)
        want_w = _rung_for(a.ladder_w, bw + pad)
        if want_h > a.rung_h or want_w > a.rung_w:
            a.rung_h = max(a.rung_h, want_h)
            a.rung_w = max(a.rung_w, want_w)
            a.shrink_streak = 0
        elif want_h < a.rung_h or want_w < a.rung_w:
            a.shrink_streak += 1
            if a.shrink_streak >= _SHRINK_AFTER:
                if want_h < a.rung_h:
                    a.rung_h -= 1
                if want_w < a.rung_w:
                    a.rung_w -= 1
                a.shrink_streak = 0
        else:
            a.shrink_streak = 0

    def _sparse_budget(self) -> Optional[int]:
        """Word budget for THIS dispatch, or None when sparse is off
        (SMH_SPARSE=0, tiny maps, or dense content that made it step aside:
        the window ladder takes over). Steps the probation counter: call
        exactly once per dispatch."""
        if not _sparse_mode():
            return None
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

    def _scales_band_size(self) -> tuple[Optional[int], bool]:
        """Pure query: (OCR row-band height for the next dispatch or None
        for full, ladder maxed). The probation step is _step_band_probation's."""
        if not self.scales_image_derived:
            return None, False  # canned engines: bboxes may point anywhere
        if self._debug:
            return None, False  # debug views want the full-height binarize
        g = self.geom
        if g.brq_h * ((g.brq_w + 7) // 8) <= 4 * 1024:  # tiny frames: no gain
            return None, False
        ladder = _dim_ladder(g.brq_h)
        band = ladder[min(self._adapt.band_rung, len(ladder) - 1)]
        if band >= g.brq_h:
            return None, True
        return band, False

    def _step_band_probation(self, maxed: bool) -> None:
        """Once per dispatch: while the band ladder is maxed out, re-probe a
        smaller band every _SHRINK_AFTER dispatches."""
        a = self._adapt
        if not maxed:
            a.band_probation = 0
            return
        a.band_probation += 1
        if a.band_probation >= _SHRINK_AFTER:
            a.band_probation = 0
            a.band_rung = len(_dim_ladder(self.geom.brq_h)) - 2

    # -- stages ----------------------------------------------------------------

    def dispatch(self, grayscale: Optional[bool] = None) -> None:
        """Upload the loaded frame (if not yet uploaded), queue the fused
        pass on the device's current stream and start the hostpack's copy
        back; returns without waiting for the device."""
        if self.geom is None or (self._pending is None and self._resident is None):
            raise RuntimeError("dispatch before load_frame")
        if grayscale is not None:
            self._grayscale = grayscale
        g = self.geom
        sparse = self._sparse_budget()
        if sparse is not None:
            crop_h = crop_w = None  # the sparse words reconstruct the plane
        else:
            crop_h, crop_w = self._crop_size()
        if not self.scales_enabled:
            inline = "none"
        elif self.scales_device_ok:
            inline = "device"  # records are ~1.2 KB: always inline, no band
        elif not self._adapt.scales_inline:
            inline = "none"
        elif self.scales_binary_ok:
            inline = "binary"
        else:
            inline = "gray"
        band = None
        if inline in ("binary", "gray"):
            band, maxed = self._scales_band_size()
            self._step_band_probation(maxed)
        self._dispatch_flags = _Flags(
            self.scales_enabled, self.quiet_enabled, self._grayscale, inline, sparse,
            crop_h, crop_w, band,
        )
        kw = dict(
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
            crop_h=crop_h,
            crop_w=crop_w,
            scales_band=band,
        )
        pending, self._pending = self._pending, None
        if pending is not None and pending[0] == "delta":
            _, buf, bucket, nbytes = pending
            out = ops_pipeline.analyze_delta_flat(
                self._resident, buf.to(self.device, non_blocking=True),
                bucket=bucket, chunk=_DELTA_SUB, **kw,
            )
            self._resident = out.pop("resident")
            self._retire_mirror(recyclable_next=True)
            self.stats["delta_frames"] += 1
            self.stats["h2d_bytes"] += nbytes
        elif pending is not None:
            # Full upload: seeds the delta chain for the next frame.
            _, packed, nbytes = pending
            stage = self._staging(packed.size)
            stage.numpy()[...] = packed
            self._resident = stage.to(self.device, non_blocking=True)
            out = ops_pipeline.analyze_packed_flat(self._resident, **kw)
            self._retire_mirror(recyclable_next=False)
            self.stats["full_uploads"] += 1
            self.stats["h2d_bytes"] += nbytes
        else:
            # No pending upload (a re-dispatch with new flags): analyse the
            # buffer this frame was uploaded to (a view's own frame).
            out = ops_pipeline.analyze_packed_flat(self._resident, **kw)
        self._results = out
        # Start the hostpack's D2H now, into pinned memory behind an event:
        # crop_to_map waits on this frame's event only.
        pack = out["hostpack"]
        if self.device.type == "cuda":
            host = torch.empty(pack.shape, dtype=pack.dtype, pin_memory=True)
            host.copy_(pack, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._fetch = (host, event)
        else:
            self._fetch = (pack, None)

    def _retire_mirror(self, recyclable_next: bool) -> None:
        """Advance the diff base to the just-dispatched frame's pack buffer.
        The OLD mirror goes back to the pack pool iff its own dispatch rode
        the delta path; in-place rolling frames pack INTO the mirror (the
        old mirror is the new pending host buffer) and nothing retires."""
        old = self._mirror
        if (
            old is not None
            and old is not self._pending_host
            and self._mirror_recyclable
            and len(self._pack_pool) < 2
        ):
            self._pack_pool.append(old)
        self._mirror = self._pending_host
        self._mirror_recyclable = recyclable_next

    def snapshot_job(self) -> "CudaBackend":
        """Freeze the dispatched frame as a CONSUME VIEW: a shallow copy whose
        per-frame fields (results, fetch, geom, dispatch flags, parsed
        sections) stay this frame's, while the adaptation state, the stats
        and the delta chain are shared by reference. VisionState consumes
        frame N on the view while load_frame/dispatch of frame N+1 rebind
        the live backend's fields, from another thread if it likes: submit
        never writes a tensor a view holds (the delta scatter writes a fresh
        buffer) and consume writes only the view and the shared ints."""
        view = copy.copy(self)
        # The view never re-enters the submit half: the chain belongs to the
        # live backend.
        view._pending = None
        view._pending_host = None
        view._host = None
        view._scalespack_host = None
        view._lsd_crop_host = None
        return view

    def crop_to_map(self, grayscale: bool) -> Optional[tuple]:
        if self.geom is None:
            raise RuntimeError("crop_to_map before load_frame")
        g = self.geom
        a = self._adapt
        if self._results is None or self._grayscale != grayscale:
            self._grayscale = grayscale
            self.dispatch()
        f = self._dispatch_flags
        host, event = self._fetch
        if event is not None:
            event.synchronize()  # this frame's copy only, not the stream
        pack = host.numpy()  # the one D2H per frame
        layout = ops_pipeline.hostpack_layout(
            g.map_h, g.map_w, with_ocr=f.with_ocr, with_quiet=f.with_quiet,
            crop_h=f.crop_h, crop_w=f.crop_w, scales_inline=f.inline,
            scales_band=f.band, sparse_budget=f.sparse,
        )

        def sect(name):
            off, size = layout[name]
            return pack[off : off + size]

        red_ratio = float(sect("red_ratio").view(np.float32)[0])
        if red_ratio < C.CLOSE_DEPLOYMENT_BUTTON_RED_PIXEL_THRESHOLD:
            return None

        self.stats["frames"] += 1
        y0, y1, x0, x1, cy0, cx0 = (int(v) for v in sect("lsd_meta").view(np.int32))
        self._host = {
            "ui_check": tuple(int(v) for v in sect("ui_check").view(np.uint32)),
            "lsd_bbox": (y0, y1, x0, x1),
        }
        if f.with_ocr:
            check = tuple(int(v) for v in sect("scales_check").view(np.uint32))
            self._host["scales_check"] = check
            if f.inline == "device":
                self._host["scales_records"] = ops_scales_device.decode_records(
                    sect("scales_rec").view(np.int16)
                )
            if f.inline in ("binary", "gray"):
                self._parse_inline_scales(sect, f)
            # Unchanged checksums (static map) drop the inline images from
            # later packs; any change brings them back.
            if check == a.scales_last_check:
                a.scales_stable += 1
                if a.scales_stable >= _INLINE_STABLE_AFTER:
                    a.scales_inline = False
            else:
                a.scales_last_check = check
                a.scales_stable = 0
                a.scales_inline = True
        if f.with_quiet:
            self._host["minimap_rect"] = tuple(int(v) for v in sect("minimap_rect").view(np.int32))

        full = {"lsd_offset": (0, 0), "lsd_crop_shape": (g.map_h, g.map_w)}
        if y0 >= y1 or x0 >= x1:  # empty mask
            self._host.update(lsd_crop_bits=None, lsd_offset=(0, 0), lsd_crop_shape=(0, 0))
            self._march_max_len = 0.0
            if f.sparse is not None:
                self._adapt_sp_rung(int(sect("lsd_nz").view(np.int32)[0]), f.sparse)
            elif a.ladder_h is not None:
                self._adapt_rung(0, 0)
        elif f.sparse is not None:
            self._march_max_len = math.hypot(y1 - y0, x1 - x0) + 1.0
            nz = int(sect("lsd_nz").view(np.int32)[0])
            if nz <= f.sparse:
                # Exact reconstruction of the full bit plane.
                bits = ops_pipeline.sparse_mask_host(
                    nz, sect("lsd_sp_idx").view(np.int32), sect("lsd_sp_dat").view(np.uint32),
                    g.map_h, g.map_w,
                )
            else:
                # Sparse miss: fetch the full bit-mask (one extra copy).
                self.stats["lsd_sparse_misses"] += 1
                bits = self._results["lsd_bits"].cpu().numpy()
            self._host.update(lsd_crop_bits=bits, **full)
            self._adapt_sp_rung(nz, f.sparse)
        else:
            m = ops_pipeline.LSD_CROP_MARGIN
            ch = g.map_h if f.crop_h is None else f.crop_h
            cw = g.map_w if f.crop_w is None else f.crop_w
            self._march_max_len = math.hypot(y1 - y0, x1 - x0) + 1.0
            if cy0 + ch >= min(y1 + m, g.map_h) and cx0 + cw >= min(x1 + m, g.map_w):
                self._host.update(
                    lsd_crop_bits=sect("lsd_crop").reshape(ch, (cw + 7) // 8),
                    lsd_offset=(cx0, cy0),
                    lsd_crop_shape=(ch, cw),
                )
            else:
                # Window miss: fetch the full bit-mask (one extra copy) and
                # escalate the rung.
                self.stats["lsd_window_misses"] += 1
                self._host.update(lsd_crop_bits=self._results["lsd_bits"].cpu().numpy(), **full)
            if a.ladder_h is not None:
                self._adapt_rung(y1 - y0, x1 - x0)

        if self._debug:
            # Debug views want the intermediates: re-run the pass over this
            # frame's resident buffer and keep them.
            planes = self._resident[: g.map_h * g.map_w * 3].view(3, g.map_h, g.map_w)
            self._results.update(
                ops_pipeline.analyze_map_planar(planes, grayscale=grayscale, with_isolated=True)
            )

        # The ui map is display-only: a lazy fetcher, reused while the
        # device checksum is unchanged.
        results = self._results
        ui_check_host = self._host["ui_check"]

        def fetch_ui_map() -> np.ndarray:
            check = (*ui_check_host, grayscale)
            if (
                a.ui_map_cache is not None
                and check == a.ui_check
                and a.ui_map_cache.shape[:2] == (g.map_h, g.map_w)
            ):
                return a.ui_map_cache
            ui = results["ui"].cpu().numpy()
            ui_map = np.empty((g.map_h, g.map_w, 4), dtype=np.uint8)
            if ui.ndim == 2:
                ui_map[..., 0] = ui_map[..., 1] = ui_map[..., 2] = ui
            else:
                ui_map[..., :3] = ui
            ui_map[..., 3] = 255
            a.ui_check = check
            a.ui_map_cache = ui_map
            return ui_map

        return fetch_ui_map, (g.map_x, g.map_y, g.map_w, g.map_h)

    def _parse_inline_scales(self, sect, f: _Flags) -> None:
        """The binary/gray scales sections -> self._host, with the band
        ladder's adaptation. host["scales_band"] is None (full-height
        images), (band, b0, textless) (a row band at b0), or "miss" (the
        band was too small: the scalespack serves this frame)."""
        g = self.geom
        a = self._adapt
        brq_row = (g.brq_w + 7) // 8
        self._host["scales_band"] = None
        rows = g.brq_h
        if f.band is not None:
            rows = f.band
            oy0, oy1, b0 = (int(v) for v in sect("scales_meta").view(np.int32))
            if oy0 >= oy1:  # no text pixels: empty canvases are exact
                self._host["scales_band"] = (f.band, 0, True)
                return
            need_end = min(oy1 + ops_pipeline.scales_scan_budget(g.brq_w), g.brq_h)
            want = _rung_for(_dim_ladder(g.brq_h), need_end - oy0)
            if b0 + f.band < need_end:
                # The text rows outgrew the band: fall back to the full
                # images and escalate straight to the rung that fits.
                self.stats["scales_band_misses"] += 1
                a.band_rung = max(a.band_rung + 1, want)
                a.band_streak = 0
                self._host["scales_band"] = "miss"
                return
            self._host["scales_band"] = (f.band, b0, False)
            if want < a.band_rung:  # shrink after a streak of small bands
                a.band_streak += 1
                if a.band_streak >= _BAND_SHRINK_AFTER:
                    a.band_rung -= 1
                    a.band_streak = 0
            else:
                a.band_streak = 0
        self._host["scales_bits_inline"] = sect("scales_bits").reshape(rows, brq_row)
        if f.inline == "binary":
            self._host["ocr_bits_inline"] = sect("ocr_bits").reshape(rows, brq_row)
        else:
            self._host["ocr_img_inline"] = sect("ocr_img").reshape(rows, g.brq_w)

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
        img = _ocr_image_from_host(self._host or {}, g)
        if img is not None:
            return img
        off, size = ops_pipeline.scalespack_layout(g.map_h, g.map_w)["ocr_img"]
        return self._fetch_scalespack()[off : off + size].reshape(g.brq_h, g.brq_w)

    def find_scales_preprocess(self, scales_start_y: int) -> np.ndarray:
        """The binarized BRQ as 0/255 u8 (bit-unpacked)."""
        g = self.geom
        img = _scales_image_from_host(self._host or {}, g)
        if img is not None:
            return img
        off, size = ops_pipeline.scalespack_layout(g.map_h, g.map_w)["scales_bits"]
        bits = self._fetch_scalespack()[off : off + size].reshape(g.brq_h, (g.brq_w + 7) // 8)
        return ops_pipeline.unpack_bits_host(bits, g.brq_w) * np.uint8(255)

    def snapshot_scales_job(self) -> Optional[dict]:
        """Self-contained handle for the async scales step: the checksum,
        the device read when it serves this frame (consumed inline), and a
        fetch closure over THIS frame's inline sections, falling back to its
        scalespack — safe to run on a worker while later frames dispatch
        (smh_tpu's TpuBackend.snapshot_scales_job)."""
        if self._host is None or "scales_check" not in self._host:
            return None
        g = self.geom
        host = self._host  # crop_to_map replaces it, never mutates it
        stats = self.stats
        band = host.get("scales_band")
        textless = isinstance(band, tuple) and band[2]
        has_inline = "scales_bits_inline" in host and (
            "ocr_bits_inline" in host or "ocr_img_inline" in host
        )
        records = host.get("scales_records")
        ratio = ops_scales_device.ratio_from_records(records) if records is not None else None
        serves = records is not None and (records.complete or ratio is not None)
        # Pin the device scalespack only when the worker may need it.
        needs_fallback = band == "miss" or not (textless or has_inline or serves)
        spack_dev = self._results.get("scalespack") if needs_fallback else None

        def fetch() -> tuple[np.ndarray, np.ndarray]:
            ocr_img = _ocr_image_from_host(host, g)
            scales_img = _scales_image_from_host(host, g)
            if ocr_img is None or scales_img is None:
                if spack_dev is None:
                    raise RuntimeError("scales fallback needed but no scalespack was kept")
                pack = spack_dev.cpu().numpy()
                stats["scalespack_fetches"] += 1
                layout = ops_pipeline.scalespack_layout(g.map_h, g.map_w)
                so, ss = layout["scales_bits"]
                oo, os_ = layout["ocr_img"]
                scales_img = ops_pipeline.unpack_bits_host(
                    pack[so : so + ss].reshape(g.brq_h, (g.brq_w + 7) // 8), g.brq_w
                ) * np.uint8(255)
                ocr_img = pack[oo : oo + os_].reshape(g.brq_h, g.brq_w)
            return ocr_img, scales_img

        job = {"check": host["scales_check"], "fetch": fetch}
        if records is not None:
            # The device read counts when the consumer takes the job (on a
            # checksum-cache miss), as in the sync path.
            job["count"] = lambda key: stats.__setitem__(key, stats[key] + 1)
            job["had_records"] = True
        if serves:
            job["device"] = (records.words, ratio)
        return job

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

    def _full_mask_host(self) -> np.ndarray:
        """Full-size 0/255 host mask (the LSD_INPUT debug view)."""
        g = self.geom
        return ops_pipeline.unpack_bits_host(self._results["lsd_bits"].cpu().numpy(), g.map_w) * np.uint8(255)

    def _lsd_mask_dev(self) -> torch.Tensor:
        """The u8 0/255 device mask the ray march samples, rebuilt from the
        bit plane (cached per frame)."""
        if "lsd_mask" not in self._results:
            self._results["lsd_mask"] = ops_pipeline.unpack_bits_device(
                self._results["lsd_bits"], self.geom.map_w
            )
        return self._results["lsd_mask"]

    def find_longest_line(self, mask, pt: Point, max_gap: float) -> tuple[Line, float]:
        return ops_lsd.find_longest_line(self._lsd_mask_dev(), pt, max_gap, max_len=self._march_max_len)

    def _find_longest_lines_batch(self, mask, pts: list, max_gap: float):
        return ops_lsd.find_longest_lines_batch(
            self._lsd_mask_dev(), pts, max_gap, max_len=self._march_max_len
        )

    def find_marker_lines(self, max_gap: int) -> list:
        if self._lsd_crop_host is None:
            self.mask_marker_lines()
        crop = self._lsd_crop_host
        if crop.size == 0:
            return []
        g = self.geom
        ox, oy = self._lsd_offset
        if self.lsd_engine == "native":
            return native.find_lines(crop, max_gap, full_shape=(g.map_h, g.map_w), offset=(ox, oy))
        # The device march samples the full device mask, so the seed scan
        # runs in map coordinates over the crop pasted into a full canvas.
        if crop.shape == (g.map_h, g.map_w):
            canvas = crop
        else:
            canvas = np.zeros((g.map_h, g.map_w), dtype=np.uint8)
            canvas[oy : oy + crop.shape[0], ox : ox + crop.shape[1]] = crop
        return lsd.find_lines(
            canvas, max_gap, self.find_longest_line,
            find_longest_lines_batch=self._find_longest_lines_batch,
        )

    # -- debug ------------------------------------------------------------------

    def get_debug_view(self, choice: DebugView) -> Optional[np.ndarray]:
        """RGBA u8 image of an intermediate (smh_tpu's get_debug_view), or
        None when this frame did not keep it."""
        if self._results is None or choice == DebugView.NONE:
            return None

        def rgba(img: np.ndarray) -> np.ndarray:
            out = np.empty((*img.shape[:2], 4), dtype=np.uint8)
            out[..., :3] = img if img.ndim == 3 else img[..., None]
            out[..., 3] = 255
            return out

        host = self._host or {}
        scales_avail = (
            "scalespack" in self._results or "ocr_img_inline" in host or "ocr_bits_inline" in host
        )
        if choice == DebugView.OCR_INPUT:
            return rgba(self.ocr_preprocess()) if scales_avail else None
        if choice == DebugView.FIND_SCALES_INPUT:
            return rgba(self.find_scales_preprocess(0)) if scales_avail else None
        if choice == DebugView.LSD_INPUT:
            return rgba(self._full_mask_host())
        if choice == DebugView.LSD_PREPROCESS and "isolated_map" in self._results:
            return rgba(self._results["isolated_map"].cpu().numpy())
        if choice == DebugView.CROPPED_BRQ and "cropped_brq" in self._results:
            return rgba(self._results["cropped_brq"].cpu().numpy())
        return None
