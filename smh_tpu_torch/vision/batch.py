"""Batched frame pipeline: throughput mode, on a CUDA device.

The port's counterpart of smh_tpu/vision/batch.py. It processes B frames per
device dispatch with ONE hostpack fetch for the whole batch: the per-frame
launch and copy overheads divide by B. It is the offline-analysis API (video
files, several game clients). Detection semantics are the per-frame
driver's: the host stages (LSD scan, minimap rect, scale bars) run per frame
on the fetched packs.

The batch hostpack carries the LSD mask as sparse words (or window crops
under SMH_SPARSE=0); frames whose mask outgrew the budget or window fall
back to one batched fetch of their full bit planes. The scalespack is
fetched only when a frame's device scales read overflowed with nothing
trusted. The per-frame host stages run on a thread pool; the OCR engine call
is serialized (the engine singleton is not re-entrant).

What the device does per batch (ops/pipeline.py): one H2D copy of the packed
[B, padded] rows (or of the delta chunks), one batched fused pass whose
kernels 1-3 each launch once for all B frames, and one async D2H copy of the
[B, bytes] hostpacks into pinned memory behind a CUDA event that collect()
waits on.

On a mesh (parallel/spmd.py::Mesh, `mesh=`) the batch splits over "dp":
each dp slice of the rows is staged in pinned memory and copied to its
row's sp-0 device, the batched pass runs once per dp device (kernels 1-3
once per dp shard), and each device's hostpacks are copied into their rows
of the one pinned [B, bytes] buffer behind that device's event; collect()
waits on all of them. As in smh_tpu, the cross-batch delta chain is off on
a mesh: every batch is a full upload.

Left out against smh_tpu: the host link's relay-specific parts (the 1-byte
chain-tail poke and its eager variant): the gate that bounds outstanding
delta programs waits on the last submit's CUDA event instead.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional

import numpy as np
import torch

from .. import consts as C
from .. import resolve_device
from ..geometry import Line, Rect
from ..ops import pipeline as ops_pipeline
from ..ops import scales_device as ops_scales_device
from ..utils.timeshares import WAIT, new_frame, span
from . import cuda_backend as cb
from . import lsd as vlsd
from . import mpx_ratio as mpx
from .reference import find_longest_line as oracle_march

# The fewest map rows a band of the delta path's roll takes: a thinner band
# pays more for its task's hand-off than its sweep saves.
_ROLL_BAND_ROWS = 64


@dataclasses.dataclass
class BatchResult:
    sleeping: bool
    markers: list[Line]
    minimap_bounds: Optional[Rect]
    meters_to_px_ratio: Optional[float]


class BatchPipeline:
    """Fixed-resolution batched analyzer on one device or over a mesh."""

    def __init__(
        self,
        frame_w: int,
        frame_h: int,
        batch: int = 8,
        ocr_engine=None,
        lsd_window: Optional[float] = 0.5,
        host_workers: int = 4,
        mesh=None,
        device="cuda",
    ) -> None:
        """lsd_window: LSD crop window as a fraction of the map when the
        sparse transport is off (None = full mask in the pack; batch jobs
        are offline and retry-free, so a fixed window + full-mask fallback
        replaces the per-frame driver's adaptive ladder).

        device: "cuda" / "cuda:N" runs the CUDA kernels, "cpu" their plain
        PyTorch versions; a CUDA device that is absent raises.

        mesh: a parallel/spmd.py Mesh, the multi-device mode (then `device`
        is not read): batch % dp == 0, frames b * B / dp .. (b + 1) * B / dp
        run on dp row b's sp-0 device, the delta chain is off. smh_tpu
        replicates a dp slice over "sp"; the port runs it once, on the sp-0
        device: the results are the same."""
        self.mesh = mesh
        if mesh is not None:
            dp = mesh.shape["dp"]
            if batch % dp:
                raise ValueError(f"batch={batch} is not divisible by dp={dp}")
            self.devices = mesh.row_devices()
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        self.geom = C.map_geometry(frame_w, frame_h)
        self.batch = batch
        self.ocr_engine = ocr_engine
        g = self.geom
        mask_bytes = g.map_h * ((g.map_w + 7) // 8)
        # Sparse mask transport: one fixed word budget for the whole job.
        # 2048 words = 16 KB of pack sections per frame; a real 4K marker
        # mask is ~600 words, so misses are rare and each costs one extra
        # (batched) fetch, not a detection error.
        self.sparse_budget: Optional[int] = None
        if cb._sparse_mode() and mask_bytes > cb._MIN_WINDOWED_MASK_BYTES:
            self.sparse_budget = min(2048, mask_bytes // 16)
        if (
            self.sparse_budget is not None
            or lsd_window is None
            or mask_bytes <= cb._MIN_WINDOWED_MASK_BYTES
        ):
            self.crop_h: Optional[int] = None
            self.crop_w: Optional[int] = None
        else:
            self.crop_h = max(1, int(g.map_h * lsd_window))
            self.crop_w = max(1, int(g.map_w * lsd_window))
        from .. import native

        self._native = native if native.available() else None
        self._diff_scratch = None  # int32 index scratch for the native diff
        self._pool = ThreadPoolExecutor(max_workers=max(1, host_workers), thread_name_prefix="batch-host")
        # The delta path's roll in row bands, one task a band on a pool of
        # its own (behind the host pool's stage tasks a band would hold up
        # the submit); each band's scratch and entries are made at the
        # first delta batch and kept.
        n_bands = max(1, min(host_workers, g.map_h // _ROLL_BAND_ROWS))
        self._roll_rows = [(j * g.map_h // n_bands, (j + 1) * g.map_h // n_bands) for j in range(n_bands)]
        self._roll_pool = ThreadPoolExecutor(max_workers=n_bands, thread_name_prefix="batch-roll")
        self._roll_bufs: Optional[list] = None
        self._ocr_lock = threading.Lock()
        self._scales_cache: dict = {}
        self._templates: dict = {}  # device -> the device scales read's templates, made at first use
        # Cross-batch delta chain (the per-frame backend's transport scaled
        # to video: frame i diffs against frame i-1, batch 0's head against
        # the previous batch's tail kept device-resident).
        self.delta_mode = os.environ.get("SMH_DELTA", "auto")
        self._resident: Optional[torch.Tensor] = None  # device flat ROI buffer = last analyzed frame
        self._mirror: Optional[np.ndarray] = None  # host copy of _resident
        # Reusable pack buffer (~80 MB at 4K B=8): a fresh np.empty per
        # batch pays the kernel's page zeroing on first touch. Recycled only
        # when the previous batch rode the delta path (its rows never left
        # the host).
        self._rois_buf: Optional[np.ndarray] = None
        # _fetched_seq = highest submit seq whose hostpack fetch completed;
        # `_seq - _fetched_seq` submitted batches may still run on the device.
        self._seq = 0
        self._fetched_seq = 0
        self._fetch_lock = threading.Lock()
        self._tail_event: Optional[torch.cuda.Event] = None  # recorded behind the last submit
        # t_* counters: cumulative ms per stage (pack/diff host halves, the
        # outstanding-batch gate's wait, the per-frame host stages), the
        # same timings as the spans batch.pack, batch.diff, batch.chain_wait
        # and batch.host; d2h_bytes: every device -> host copy; roll_bands:
        # the bands the delta path's roll ran (spans batch.roll_band).
        self.stats = {
            "delta_batches": 0, "full_batches": 0, "h2d_bytes": 0, "d2h_bytes": 0, "roll_bands": 0,
            "t_pack_ms": 0.0, "t_diff_ms": 0.0, "t_poke_ms": 0.0, "t_host_ms": 0.0,
        }

    def _padded(self) -> tuple[int, int]:
        """(ROI bytes, bytes padded to the delta chunk) of one frame's row."""
        g = self.geom
        roi_bytes = (g.map_h * g.map_w + g.btn_h * g.btn_w) * 3
        return roi_bytes, ((roi_bytes + cb._DELTA_CHUNK - 1) // cb._DELTA_CHUNK) * cb._DELTA_CHUNK

    def _pack_rois(self, frames: list[np.ndarray]) -> np.ndarray:
        """[B, padded_roi_bytes] u8: per-frame flat ROIs, the MAP as
        PLANE-MAJOR BGR (CudaBackend's layout: no layout copy on the
        device), the button interleaved BGR, padding zero. The per-frame
        repacks are independent row writes, fanned out on the host pool."""
        g = self.geom
        roi_bytes, padded = self._padded()
        out = self._rois_buf
        self._rois_buf = None
        if out is None or out.shape != (self.batch, padded):
            out = np.empty((self.batch, padded), dtype=np.uint8)
        out[len(frames) :] = 0
        out[:, roi_bytes:] = 0
        msz_p = g.map_h * g.map_w  # one plane
        msz = msz_p * 3

        def pack_one(i: int, f: np.ndarray) -> None:
            m = f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
            b = f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
            planes = [out[i, c * msz_p : (c + 1) * msz_p].reshape(g.map_h, g.map_w) for c in range(3)]
            cb._split_planes(m, planes)
            out[i, msz:roi_bytes].reshape(g.btn_h, g.btn_w, 3)[...] = b[..., :3]

        futs = [self._pool.submit(pack_one, i, f) for i, f in enumerate(frames)]
        for fu in futs:
            fu.result()
        return out

    def _pack_rois_native(self, frames: list[np.ndarray]) -> np.ndarray:
        """_pack_rois by the native module: one pack_diff sweep per frame
        writes its row of the batch buffer (the same bytes), the rows fanned
        out on the host pool."""
        native = self._native
        g = self.geom
        _, padded = self._padded()
        out = self._rois_buf
        self._rois_buf = None
        if out is None or out.shape != (self.batch, padded):
            out = np.empty((self.batch, padded), dtype=np.uint8)
        out[len(frames) :] = 0
        futs = [
            self._pool.submit(
                native.pack_diff,
                f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w],
                f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w],
                out[i], None, None, None,
            )
            for i, f in enumerate(frames)
        ]
        for fu in futs:
            fu.result()
        return out

    def _roll_delta(self, frames: list[np.ndarray], frame: Optional[int] = None):
        """Rolling fused pack+diff+gather for the batch delta path: the chain
        mirror rolls frame to frame IN PLACE, so unchanged windows are
        compared in registers and never stored. The map's rows are cut into
        bands (_roll_rows), each rolled through the whole batch by one task
        of the roll pool (native roll_band: its changed sub-chunks gathered
        before its next frame overwrites them), then joined frame by frame
        (native roll_merge). Returns (buf, bucket) with bytes equal to
        _delta_updates over _pack_rois rows, or None when a frame overflows
        the delta ladder: the caller must then reseed with the full batch
        upload (the mirror holds bytes the device never got). The caller
        drops the chain if anything raises before the mirror is retired.
        `frame`: the batch's id, given to the bands' spans."""
        native = self._native
        g = self.geom
        w = self._mirror
        n = len(frames)
        n_sub = w.size // cb._DELTA_SUB
        if self._roll_bufs is None:
            self._roll_bufs = []
            for y0, y1 in self._roll_rows:
                cap = native.roll_band_cap(g.map_h, g.map_w, y0, y1, w.size)
                self._roll_bufs.append((
                    np.empty(n_sub, np.uint8), np.empty((self.batch, cap), np.int32),
                    np.empty((self.batch, cap, cb._DELTA_SUB), np.uint8), np.empty((self.batch, 3), np.int32),
                ))
        rois = native.roll_frames(
            [f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w] for f in frames],
            [f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w] for f in frames],
        )

        def band(rows: tuple[int, int], bufs: tuple) -> None:
            with span("batch.roll_band", cpu=True, frame=frame):
                native.roll_band(rois, w, *rows, *bufs)

        futs = [self._roll_pool.submit(band, rows, bufs) for rows, bufs in zip(self._roll_rows, self._roll_bufs)]
        wait(futs)  # every band is off the mirror before anything raises
        for fu in futs:
            fu.result()
        self.stats["roll_bands"] += len(futs)
        _, idxs, datas, cnts = zip(*self._roll_bufs)
        counts = native.roll_merge(idxs, datas, cnts, n)
        bucket = cb._delta_bucket(max(int(counts.max()), 1), n_sub)  # no change: a keep-alive chunk
        if bucket is None:
            return None  # ladder overflow: full upload wins
        bsz = self.batch
        buf = np.empty(bsz * bucket * 4 + bsz * bucket * cb._DELTA_SUB, np.uint8)
        native.roll_merge(idxs, datas, cnts, n, bucket, buf)
        # Padding rows replay chunk 0 of the last frame: exactly
        # _delta_updates' ch=zeros(1) over rois[n-1].
        buf[: bsz * bucket * 4].view(np.int32).reshape(bsz, bucket)[n:] = 0
        buf[bsz * bucket * 4 :].reshape(bsz, bucket, cb._DELTA_SUB)[n:] = w[: cb._DELTA_SUB]
        return buf, bucket

    def _fused_ok(self, frames: list[np.ndarray]) -> bool:
        """The native module is there and every frame is BGRA with
        contiguous pixels (what its pack and roll read)."""
        return self._native is not None and all(
            f.ndim == 3 and f.shape[2] == 4 and f.dtype == np.uint8
            and f.strides[2] == 1 and f.strides[1] == 4
            for f in frames
        )

    def _find_lines(self, crop_mask: np.ndarray, offset: tuple[int, int]) -> list[Line]:
        if crop_mask.size == 0:
            return []
        g = self.geom
        full = (g.map_h, g.map_w)
        if self._native is not None:
            return self._native.find_lines(crop_mask, C.LSD_MAX_GAP, full_shape=full, offset=offset)
        # The oracle has no windowed view: paste into a full canvas so the
        # coordinates (and the f32 march arithmetic) stay in full-plane space.
        ox, oy = offset
        if crop_mask.shape == full and (ox, oy) == (0, 0):
            canvas = crop_mask
        else:
            canvas = np.zeros(full, dtype=np.uint8)
            canvas[oy : oy + crop_mask.shape[0], ox : ox + crop_mask.shape[1]] = crop_mask
        return vlsd.find_lines(canvas, C.LSD_MAX_GAP, oracle_march)

    def _host_ratio(self, ocr_img, scales_img, lazy_scales_img=None):
        """Host engine + bar walk over materialized planes (the non-device
        scales path, and the device read's overflow fallback)."""
        with self._ocr_lock:  # engine singletons are not re-entrant
            ocr_results = self.ocr_engine.read(ocr_img, None)
        from .pipeline import _parse_scales

        scales, start_y = _parse_scales(ocr_results)
        if not scales or start_y is None:
            return None
        if scales_img is None:
            scales_img = lazy_scales_img()
        return mpx.calc_meters_to_px_ratio(scales, scales_img)

    def _delta_updates(self, rois: np.ndarray, n: int):
        """Per-frame changed-chunk updates against the chain, or None when a
        frame changed too much (the full batch upload wins): the delta path
        of frames the native roll cannot read (_fused_ok)."""
        # Two-level diff, shared with the per-frame backend: compare at
        # 128 B, refine to 32 B sub-chunks. The native engine emits the same
        # index set; numpy is the fallback.
        n_chunks = rois.shape[1] // cb._DELTA_CHUNK
        n_sub = n_chunks * (cb._DELTA_CHUNK // cb._DELTA_SUB)
        if self._native is not None:
            changed = []
            scratch = self._diff_scratch
            if scratch is None or scratch.size < n_sub:
                scratch = self._diff_scratch = np.empty(n_sub, np.int32)
            prev = self._mirror
            for i in range(n):
                cnt = self._native.diff_subchunks(rois[i], prev, scratch)
                changed.append(np.zeros(1, dtype=np.int32) if cnt == 0 else scratch[:cnt].copy())
                prev = rois[i]
        else:
            changed = []
            prev64 = self._mirror.view(np.uint64).reshape(n_chunks, -1)
            for i in range(n):
                cur64 = rois[i].view(np.uint64).reshape(n_chunks, -1)
                ne = cur64 != prev64
                ch = np.flatnonzero(ne.any(axis=1)).astype(np.int32)
                changed.append(cb._refine_subchunks(ne, ch))
                prev64 = cur64
        bucket = cb._delta_bucket(max(c.size for c in changed), n_sub)
        if bucket is None:
            return None
        b = self.batch
        buf = np.empty(b * bucket * 4 + b * bucket * cb._DELTA_SUB, dtype=np.uint8)
        if self._native is not None:
            # The batch layout groups the index tables of ALL frames first,
            # then the payload blocks; the C gather emits [idx | data] per
            # frame, so gather into a small per-frame tmp and split.
            idxs_bytes = buf[: b * bucket * 4]
            datas = buf[b * bucket * 4 :]
            for i in range(b):
                ch = changed[i] if i < n else np.zeros(1, dtype=np.int32)
                src = rois[min(i, n - 1)]
                tmp = np.empty(bucket * 4 + bucket * cb._DELTA_SUB, dtype=np.uint8)
                self._native.gather_subchunks(src, ch, int(ch.size), bucket, tmp)
                idxs_bytes[i * bucket * 4 : (i + 1) * bucket * 4] = tmp[: bucket * 4]
                datas[i * bucket * cb._DELTA_SUB : (i + 1) * bucket * cb._DELTA_SUB] = tmp[bucket * 4 :]
        else:
            idxs = buf[: b * bucket * 4].view(np.int32).reshape(b, bucket)
            datas = buf[b * bucket * 4 :].reshape(b, bucket, cb._DELTA_SUB)
            for i in range(b):
                ch = changed[i] if i < n else np.zeros(1, dtype=np.int32)
                src = rois[min(i, n - 1)].reshape(n_sub, cb._DELTA_SUB)
                idxs[i, : ch.size] = ch
                idxs[i, ch.size :] = ch[-1]
                datas[i, : ch.size] = src[ch]
                datas[i, ch.size :] = src[ch[-1]]
        return buf, bucket

    def _to_device(self, host: np.ndarray, device: torch.device) -> torch.Tensor:
        """One H2D copy of a host buffer: staged through pinned memory and
        copied without blocking on a CUDA device (the caching host allocator
        hands a pinned block out again only after its copy finished); the
        CPU path wraps the buffer."""
        if device.type != "cuda":
            return torch.from_numpy(host)
        stage = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
        stage.numpy()[...] = host
        return stage.to(device, non_blocking=True)

    def process(self, frames: list[np.ndarray]) -> list[BatchResult]:
        """frames: BGRA u8 arrays of the pipeline resolution, len <= batch."""
        return self.collect(self.submit(frames))

    def stream(self, batches, depth: int = 2):
        """Yield collect() results for an iterable of frame batches,
        overlapping batch N+1's submit half (pack + diff + dispatch, on a
        worker thread) with batch N's collect half (hostpack fetch + host
        stages, on the caller thread). `depth` bounds in-flight batches
        (submit order = chain order is kept by the single worker; results
        yield in the same order). Abandoning the generator early (break /
        exception / close) is safe: the submitter stops at the next batch
        boundary and every job it already dispatched is collected (not
        yielded), so the fetch tracking stays exact."""
        import queue

        jobs: queue.Queue = queue.Queue(maxsize=max(1, depth))
        done = object()
        stop = threading.Event()

        def submitter() -> None:
            try:
                for fr in batches:
                    if stop.is_set():
                        break
                    job = self.submit(fr)
                    # Blocking put with a stop check: when the consumer
                    # abandoned the generator it drains the queue in its
                    # finally block, so this always makes progress.
                    with span("batch.queue_put", WAIT, frame=job["frame"]):
                        while True:
                            try:
                                jobs.put(job, timeout=0.2)
                                break
                            except queue.Full:
                                continue
            except BaseException as e:  # propagate into the consumer
                jobs.put(("__stream_err__", e))
            else:
                jobs.put(done)

        def drain_one(block: bool) -> bool:
            try:
                j = jobs.get(timeout=0.05) if block else jobs.get_nowait()
            except queue.Empty:
                return False
            if j is not done and not (isinstance(j, tuple) and j and j[0] == "__stream_err__"):
                self.collect(j)
            return True

        t = threading.Thread(target=submitter, daemon=True, name="batch-submit")
        t.start()
        try:
            while True:
                with span("batch.queue_get", WAIT):
                    j = jobs.get()
                if j is done:
                    break
                if isinstance(j, tuple) and j and j[0] == "__stream_err__":
                    raise j[1]
                yield self.collect(j)
        finally:
            stop.set()
            while t.is_alive():
                drain_one(block=True)
                t.join(timeout=0.05)
            while drain_one(block=False):
                pass

    def _scales_inline(self) -> str:
        """The batch's scales transport: the device read for engines it
        replaces (smhocr), else the images inline (bit-packed if binary_ok);
        "none" without an engine."""
        if self.ocr_engine is None:
            return "none"
        if getattr(self.ocr_engine, "device_ok", False) and os.environ.get("SMH_DEVICE_SCALES", "1") != "0":
            return "device"
        return "binary" if getattr(self.ocr_engine, "binary_ok", False) else "gray"

    def submit(self, frames: list[np.ndarray]) -> dict:
        """Pack + diff + dispatch a batch WITHOUT waiting for results.

        The returned job is consumed by collect(). Submitting batch N+1
        while batch N is still in flight overlaps N+1's host half and its
        H2D with N's device work and fetch. The delta chain stays correct
        under pipelining: the diff base is the last SUBMITTED batch's tail
        (host mirror), and the device resident buffer advances in submit
        order on one stream. If anything raises between the in-place roll
        of the mirror and its retirement, the chain is dropped and the next
        batch is a full upload (the mirror may hold bytes the device never
        got).
        """
        if not frames or len(frames) > self.batch:
            raise ValueError(f"a batch holds 1 to {self.batch} frames, got {len(frames)}")
        n = len(frames)
        _, padded = self._padded()
        delta_ok = (
            self.delta_mode not in ("0", "off")
            and (self.delta_mode in ("1", "on") or padded >= cb._DELTA_MIN_BYTES)
            and self._resident is not None
            and self._mirror is not None
            and self._mirror.size == padded
            and self.mesh is None
        )
        fid = new_frame()
        try:
            with span("batch.submit", frame=fid):
                job = self._submit(frames, n, delta_ok, fid)
        except BaseException:
            self._mirror = self._resident = None
            raise
        job["frame"] = fid
        return job

    def _submit(self, frames: list[np.ndarray], n: int, delta_ok: bool, fid: int) -> dict:
        g = self.geom
        rois = None
        upd = None
        rolled = False
        fused = self._fused_ok(frames)
        with span("batch.pack", cpu=True) as pack:
            if fused and delta_ok:
                # Rolling in-place pack+diff+gather: no batch buffer write for
                # unchanged windows, no mirror copy; t_pack_ms carries the sweep.
                upd = self._roll_delta(frames, fid)
                rolled = upd is not None
                if not rolled:
                    delta_ok = False  # ladder overflow mid-roll: reseed full
            if not rolled:
                rois = self._pack_rois_native(frames) if fused else self._pack_rois(frames)
        self.stats["t_pack_ms"] += pack.seconds * 1000.0

        with span("batch.diff", cpu=True) as diff:
            inline = self._scales_inline()
            with_ocr = self.ocr_engine is not None
            if inline == "device":
                for dev in self.devices:
                    if dev not in self._templates:
                        self._templates[dev] = ops_scales_device.templates_to_device(
                            ops_scales_device.device_templates(), dev
                        )
            kw = dict(
                map_h=g.map_h,
                map_w=g.map_w,
                btn_h=g.btn_h,
                btn_w=g.btn_w,
                grayscale=True,
                with_ocr=with_ocr,
                crop_h=self.crop_h,
                crop_w=self.crop_w,
                scales_inline=inline,
                sparse_budget=self.sparse_budget,
            )
            if not rolled:
                upd = self._delta_updates(rois, n) if delta_ok else None
        self.stats["t_diff_ms"] += diff.seconds * 1000.0
        if upd is not None:
            # Delta chains must not stack unboundedly many batches against
            # resident buffers the device has not produced yet: with two
            # submitted batches unfetched, wait for the last one's event.
            with span("batch.chain_wait", WAIT) as wait:
                if self._seq - self._fetched_seq >= 2 and self._tail_event is not None:
                    self._tail_event.synchronize()
            self.stats["t_poke_ms"] += wait.seconds * 1000.0
        with span("batch.dispatch"):
            if upd is not None:
                buf, bucket = upd
                shards = [ops_pipeline.analyze_batch_delta_flat(
                    self._resident, self._to_device(buf, self.device), bucket=bucket, chunk=cb._DELTA_SUB,
                    templates=self._templates.get(self.device), **kw
                )]
            else:
                # A full upload: one batched pass per dp device over its slice
                # of the rows (the one device's whole batch without a mesh).
                per = self.batch // len(self.devices)
                shards = [
                    ops_pipeline.analyze_batch_packed_flat(
                        self._to_device(rois[k * per : (k + 1) * per], dev),
                        resident_row=n - 1 if self.mesh is None else None,
                        templates=self._templates.get(dev), **kw,
                    )
                    for k, dev in enumerate(self.devices)
                ]
            if self.mesh is None:
                self._resident = shards[0].pop("resident")
            fetch = self._fetch(shards)
        if upd is not None:
            self.stats["delta_batches"] += 1
            self.stats["h2d_bytes"] += upd[0].size
            if rois is not None:
                self._rois_buf = rois  # never left the host: recycle next batch
        else:
            self.stats["full_batches"] += 1
            self.stats["h2d_bytes"] += rois.size
        # Copy: a row view would keep the whole packed batch alive in host
        # RAM until the next submit replaces it. The rolled path's mirror
        # IS the chain tail already (rolled in place).
        if not rolled and self.mesh is None:
            self._mirror = rois[n - 1].copy()
        self._seq += 1
        return {
            "shards": shards, "fetch": fetch, "n": n, "inline": inline, "with_ocr": with_ocr,
            "seq": self._seq,
        }

    def _fetch(self, shards: list) -> tuple:
        """Start the batch hostpacks' D2H now, each shard's rows into theirs
        of one pinned [B, bytes] buffer behind an event on its device: they
        land while the next batch packs and diffs, and collect() waits on
        this batch's events only. -> (host [B, bytes], events)."""
        packs = [o["hostpack"] for o in shards]
        self._count_d2h(sum(p.nbytes for p in packs))
        if self.device.type != "cuda":
            return (packs[0] if len(packs) == 1 else torch.cat(packs)), []
        host = torch.empty((self.batch, packs[0].shape[1]), dtype=torch.uint8, pin_memory=True)
        per = self.batch // len(shards)
        events = []
        for k, (dev, pack) in enumerate(zip(self.devices, packs)):
            host[k * per : (k + 1) * per].copy_(pack, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
        self._tail_event = events[-1]
        return host, events

    def _count_d2h(self, nbytes: int) -> None:
        with self._fetch_lock:  # the submit, collect and host-stage threads all copy
            self.stats["d2h_bytes"] += nbytes

    def _frame_out(self, job: dict, name: str, frames: list) -> np.ndarray:
        """Output `name` of the given frames, fetched from the devices that
        hold them (one fetch per device), in the order asked."""
        shards = job["shards"]
        per = self.batch // len(shards)
        got = {}
        for k, out in enumerate(shards):
            mine = [i for i in frames if i // per == k]
            if mine:
                rows = out[name][[i - k * per for i in mine]].cpu().numpy()
                self._count_d2h(rows.nbytes)
                got.update(zip(mine, rows))
        return np.stack([got[i] for i in frames])

    def collect(self, job: dict) -> list[BatchResult]:
        """Fetch + host stages for a submitted batch (blocks on its event)."""
        host, events = job["fetch"]
        with span("batch.collect", frame=job.get("frame")):
            with span("batch.fetch_wait", WAIT):
                for event in events:
                    event.synchronize()  # this batch's copies only, not the streams
                packs = host.numpy()  # ONE fetch for the whole batch
            with span("batch.host") as stage:
                with self._fetch_lock:
                    self._fetched_seq = max(self._fetched_seq, job.get("seq", 0))
                results = self._host_stages(job, packs)
        self.stats["t_host_ms"] += stage.seconds * 1000.0
        return results

    def _host_stages(self, job: dict, packs: np.ndarray) -> list[BatchResult]:
        """The fetched [B, bytes] hostpacks -> each frame's result: the
        sections parsed, misses fetched, the host stages on the pool."""
        g = self.geom
        n = job["n"]
        inline = job["inline"]
        with_ocr = job["with_ocr"]
        layout = ops_pipeline.hostpack_layout(
            g.map_h, g.map_w, with_ocr=with_ocr, with_quiet=True,
            crop_h=self.crop_h, crop_w=self.crop_w, scales_inline=inline,
            sparse_budget=self.sparse_budget,
        )
        eff_ch = g.map_h if self.crop_h is None else self.crop_h
        eff_cw = g.map_w if self.crop_w is None else self.crop_w
        mask_row = (g.map_w + 7) // 8
        crop_row = (eff_cw + 7) // 8
        margin = ops_pipeline.LSD_CROP_MARGIN

        def sect(i, name):
            off, size = layout[name]
            return packs[i, off : off + size]

        # Pass 1 (host, cheap): red gates, bboxes, window misses, checksums.
        active: list[int] = []
        meta = {}
        misses: list[int] = []
        for i in range(n):
            red = float(sect(i, "red_ratio").view(np.float32)[0])
            if red < C.CLOSE_DEPLOYMENT_BUTTON_RED_PIXEL_THRESHOLD:
                continue
            active.append(i)
            y0, y1, x0, x1, cy0, cx0 = (int(v) for v in sect(i, "lsd_meta").view(np.int32))
            empty = y0 >= y1 or x0 >= x1
            if self.sparse_budget is not None:
                nz = int(sect(i, "lsd_nz").view(np.int32)[0])
                fit = (not empty) and nz <= self.sparse_budget
            else:
                fit = (not empty) and (
                    cy0 + eff_ch >= min(y1 + margin, g.map_h)
                    and cx0 + eff_cw >= min(x1 + margin, g.map_w)
                )
            if not empty and not fit:
                misses.append(i)
            check = None
            if with_ocr:
                check = tuple(int(v) for v in sect(i, "scales_check").view(np.uint32))
            meta[i] = (empty, fit, (y0, y1, x0, x1), (cx0, cy0), check)

        # Window or sparse misses: ONE batched fetch of their full bit planes
        # from each device that holds one.
        full_bits = {}
        if misses:
            full_bits = dict(zip(misses, self._frame_out(job, "lsd_bits", misses)))

        def host_stage(i: int) -> BatchResult:
            empty, fit, bbox, (cx0, cy0), check = meta[i]
            # Unpack and scan only the mask bbox + margin (exact; see
            # ops_pipeline.bbox_crop_host).
            if empty:
                markers: list[Line] = []
            elif fit and self.sparse_budget is not None:
                bits = ops_pipeline.sparse_mask_host(
                    int(sect(i, "lsd_nz").view(np.int32)[0]),
                    sect(i, "lsd_sp_idx").view(np.int32),
                    sect(i, "lsd_sp_dat").view(np.uint32),
                    g.map_h,
                    g.map_w,
                )
                crop, off = ops_pipeline.bbox_crop_host(bits, bbox, (0, 0), (g.map_h, g.map_w))
                markers = self._find_lines(crop, off)
            elif fit:
                bits = sect(i, "lsd_crop").reshape(eff_ch, crop_row)
                crop, off = ops_pipeline.bbox_crop_host(bits, bbox, (cx0, cy0), (eff_ch, eff_cw))
                markers = self._find_lines(crop, off)
            else:
                crop, off = ops_pipeline.bbox_crop_host(
                    full_bits[i].reshape(g.map_h, mask_row), bbox, (0, 0), (g.map_h, g.map_w),
                )
                markers = self._find_lines(crop, off)

            l, t, r, b = (int(v) for v in sect(i, "minimap_rect").view(np.int32))
            minimap = Rect(left=l, top=t, right=r, bottom=b) if g.map_w >= 3 and g.map_h >= 3 else None

            ratio = None
            if with_ocr:
                if check in self._scales_cache:
                    ratio = self._scales_cache[check]
                else:
                    brq_row = (g.brq_w + 7) // 8
                    if inline == "device":
                        dev = ops_scales_device.decode_records(sect(i, "scales_rec").view(np.int16))
                        ratio = ops_scales_device.ratio_from_records(dev)
                        if ratio is None and not dev.complete:
                            # Capacity overflow with nothing trusted: the
                            # host engine over THIS frame's scalespack (one
                            # lazy per-frame fetch; rare).
                            spack = self._frame_out(job, "scalespack", [i])[0]
                            slay = ops_pipeline.scalespack_layout(g.map_h, g.map_w)
                            so, ss = slay["scales_bits"]
                            oo, os_ = slay["ocr_img"]
                            ocr_img = spack[oo : oo + os_].reshape(g.brq_h, g.brq_w)
                            scales_img = ops_pipeline.unpack_bits_host(
                                spack[so : so + ss].reshape(g.brq_h, brq_row), g.brq_w
                            ) * np.uint8(255)
                            ratio = self._host_ratio(ocr_img, scales_img)
                    else:
                        if inline == "binary":
                            ocr_img = ops_pipeline.binary_ocr_image_host(
                                sect(i, "ocr_bits").reshape(g.brq_h, brq_row), g.brq_w
                            )
                        else:
                            ocr_img = sect(i, "ocr_img").reshape(g.brq_h, g.brq_w)

                        def lazy_scales_img():
                            return ops_pipeline.unpack_bits_host(
                                sect(i, "scales_bits").reshape(g.brq_h, brq_row), g.brq_w,
                            ) * np.uint8(255)

                        ratio = self._host_ratio(ocr_img, None, lazy_scales_img)
                    if len(self._scales_cache) > 256:
                        self._scales_cache.clear()
                    self._scales_cache[check] = ratio

            return BatchResult(False, markers, minimap, ratio)

        futures = {i: self._pool.submit(host_stage, i) for i in active}
        results: list[BatchResult] = []
        for i in range(n):
            if i in futures:
                results.append(futures[i].result())
            else:
                results.append(BatchResult(True, [], None, None))
        return results

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self._roll_pool.shutdown(wait=False)
