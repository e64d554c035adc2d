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
    red gate, checksums, the sparse (or full-plane) LSD mask, the
    device-read scale records and the minimap rect;
  * the markers come from the native host LSD (`native.find_lines`) on the
    bbox slice of the reconstructed mask; the scale ratio from the decoded
    records, or — for engines that do not read on device, or a device read
    that lost structure — from the host engine over the lazily fetched
    scalespack (snapshot_scales_job hands the same to the async scales
    step).

Not ported yet: the window-crop rungs, the binary/gray/band scales
transports, debug views and the device ray march.
"""

from __future__ import annotations

import copy
import os
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
    """Cross-frame transport adaptation + display caches (the fields of
    smh_tpu's _AdaptState this backend uses: the sparse rung ladder and the
    ui-map cache), SHARED by reference between the backend and its consume
    views (snapshot_job), so a rung escalated while consuming frame N shapes
    frame N+1's dispatch. Every write is a single int or ref, atomic under
    the GIL."""

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
        when the native host module (pack/diff and the LSD) is unavailable."""
        self.device = resolve_device(device)
        if not native.available():
            raise RuntimeError("CudaBackend needs the native host module (pack/diff, find_lines)")
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
        self.scales_device_ok = False  # engine replaceable by the device read
        self.quiet_enabled = True  # minimap cadence

    # -- lifecycle -------------------------------------------------------------

    def set_debug(self, enabled: bool) -> None:
        if enabled:
            raise NotImplementedError("debug views are not ported to the CUDA backend yet")

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
        """Upload the loaded frame (if not yet uploaded), queue the fused
        pass on the device's current stream and start the hostpack's copy
        back; returns without waiting for the device."""
        if self.geom is None or (self._pending is None and self._resident is None):
            raise RuntimeError("dispatch before load_frame")
        if grayscale is not None:
            self._grayscale = grayscale
        g = self.geom
        sparse = self._sparse_budget()
        inline = "device" if (self.scales_enabled and self.scales_device_ok) else "none"
        self._dispatch_flags = (
            self.scales_enabled, self.quiet_enabled, self._grayscale, inline, sparse,
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
        if self._results is None or self._grayscale != grayscale:
            self._grayscale = grayscale
            self.dispatch()
        with_ocr, with_quiet, _, inline, sparse = self._dispatch_flags
        host, event = self._fetch
        if event is not None:
            event.synchronize()  # this frame's copy only, not the stream
        pack = host.numpy()  # the one D2H per frame
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

    def snapshot_scales_job(self) -> Optional[dict]:
        """Self-contained handle for the async scales step: the checksum,
        the device read when it serves this frame (consumed inline), and a
        fetch closure over THIS frame's scalespack otherwise — safe to run
        on a worker while later frames dispatch (smh_tpu's
        TpuBackend.snapshot_scales_job for the port's two transports)."""
        if self._host is None or "scales_check" not in self._host:
            return None
        g = self.geom
        host = self._host
        stats = self.stats
        records = host.get("scales_records")
        ratio = ops_scales_device.ratio_from_records(records) if records is not None else None
        serves = records is not None and (records.complete or ratio is not None)
        # Pin the device scalespack only when the worker will need it.
        spack_dev = None if serves else self._results.get("scalespack")

        def fetch() -> tuple[np.ndarray, np.ndarray]:
            pack = spack_dev.cpu().numpy()
            stats["scalespack_fetches"] += 1
            layout = ops_pipeline.scalespack_layout(g.map_h, g.map_w)
            so, ss = layout["scales_bits"]
            oo, os_ = layout["ocr_img"]
            scales_img = ops_pipeline.unpack_bits_host(
                pack[so : so + ss].reshape(g.brq_h, (g.brq_w + 7) // 8), g.brq_w
            ) * np.uint8(255)
            return pack[oo : oo + os_].reshape(g.brq_h, g.brq_w), scales_img

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
