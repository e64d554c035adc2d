"""The per-frame pipeline driver + backend hot-swap + the 15 FPS loop.

The port's copy of smh_tpu/vision/pipeline.py. The delegate selects the CUDA
backend on an explicit device or the numpy reference backend; a CUDA
backend that fails raises (at init and per frame): nothing falls back to
numpy behind the caller's back.

Counterparts:
  * VisionState::process DAG:  /root/reference/src/vision/mod.rs:36-240
  * hardware switch/fallback:  /root/reference/src/vision/hardware.rs:7-91
  * 15 FPS budget loop:        /root/reference/src/vision/mod.rs:243-315

Stage structure mirrors the reference: load -> crop (red gate) -> minimap ||
(markers-branch || scales-branch) -> debug view, with per-stage timeshares.
The markers/scales branches run concurrently (the TPU dispatch and the host
Tesseract call overlap, like the reference's rayon join of the CUDA branch
and the OCR branch).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import threading
import time
from typing import Optional

import numpy as np

from .. import consts as C
from .. import resolve_device
from ..geometry import Line, Rect
from ..ocr.engine import OcrEngine, OcrResult
from ..settings import Settings
from ..squadex import heightmaps
from ..squadex.capture import CaptureThread, Frame
from ..utils.timeshares import WAIT, Timeshares, add, new_frame, span, timeshare
from . import find_minimap as fm
from . import mpx_ratio as mpx
from .cuda_backend import CudaBackend
from .reference import DebugView, ReferenceBackend

log = logging.getLogger(__name__)


def _frame_id(frame: Frame) -> int:
    """The frame's trace id, given here if the loop did not give it one."""
    if frame.seq is None:
        frame.seq = new_frame()
    return frame.seq


@dataclasses.dataclass
class DebugBox:
    """Per-frame debug payload (timings, OCR boxes, scale overlays)."""

    timeshares: Timeshares = dataclasses.field(default_factory=Timeshares)
    ocr: list[OcrResult] = dataclasses.field(default_factory=list)
    scales: list[tuple[int, Line]] = dataclasses.field(default_factory=list)
    debug_view: Optional[np.ndarray] = None


class VisionResults:
    """Per-frame outputs. `map` (the RGBA ui image) is lazy: backends may
    hand over a fetcher so the display image is only pulled off the device
    when a consumer (UI/web) actually wants pixels — it is not part of the
    frame->markers+scales critical path."""

    def __init__(self, map_fn=None) -> None:
        self.markers: list[Line] = []
        self.meters_to_px_ratio: Optional[float] = None
        self.minimap_bounds: Optional[Rect] = None
        self.debug_view: Optional[np.ndarray] = None
        self._map_fn = map_fn
        self._map: Optional[np.ndarray] = None

    @property
    def map(self) -> Optional[np.ndarray]:
        if self._map is None and self._map_fn is not None:
            self._map = self._map_fn()
        return self._map


def make_backend(name: str, device="cuda", lsd_engine: str = "native"):
    if name == "cuda":
        return CudaBackend(device, lsd_engine=lsd_engine)
    if name == "numpy":
        return ReferenceBackend()
    raise ValueError(f"unknown backend {name!r}")


class BackendDelegate:
    """Runtime backend switch (hardware.rs:14-45): hardware_acceleration
    toggles cuda<->numpy per frame, and the CUDA backend's line search
    follows the `lsd_engine` setting, re-checked each frame as well.
    CudaBackend runs on `device`; its failures propagate."""

    def __init__(self, settings: Settings, device="cuda") -> None:
        self._settings = settings
        self._device = resolve_device(device)
        self._backend = None

    @property
    def backend(self):
        return self._backend

    def current(self):
        want = "cuda" if self._settings.hardware_acceleration() else "numpy"
        engine = self._settings.lsd_engine()
        if self._backend is None or self._backend.name != want:
            self._backend = make_backend(want, self._device, lsd_engine=engine)
        elif want == "cuda" and self._backend.lsd_engine != engine:
            # Frames already submitted keep the engine their view was taken with.
            self._backend.lsd_engine = engine
        return self._backend


def _parse_scales(
    ocr_results: list[OcrResult],
) -> tuple[list[tuple[int, tuple[int, int]]], Optional[int]]:
    """Extract "<N>m" scale texts (src/vision/mod.rs:160-193)."""
    scales: list[tuple[int, tuple[int, int]]] = []
    scales_start_y: Optional[int] = None
    for ocr in ocr_results:
        if not ocr.text.isascii():
            continue
        m = ocr.text.rfind("m")
        if m < 0:
            continue
        # The reference parses u32 (src/vision/mod.rs:170): digits only —
        # Python's int() would also accept "-100"/" 100"/"1_00".
        prefix = ocr.text[:m]
        if not prefix.isdigit():
            continue
        scale = int(prefix)
        if scale == 0:
            continue
        scales_start_y = ocr.bottom if scales_start_y is None else min(scales_start_y, ocr.bottom)
        if any(s == scale for s, _ in scales):
            continue
        scales.append((scale, ((ocr.left + ocr.right) // 2, ocr.bottom)))
        if len(scales) == 3:
            break
    return scales, scales_start_y


class VisionState:
    """Owns the branch executor and runs the per-frame DAG."""

    def __init__(
        self,
        settings: Optional[Settings] = None,
        ocr_engine: Optional[OcrEngine] = None,
        debug_view: DebugView = DebugView.NONE,
        collect_debug_overlays: bool = False,
        minimap_every: int = 1,
        scales_async: bool = False,
        device="cuda",
    ) -> None:
        """device: "cuda" (default) / "cuda:N" runs the CUDA kernels; "cpu"
        runs their plain PyTorch versions. A CUDA device that is absent
        raises here.

        minimap_every=N runs minimap-bounds detection every Nth frame and
        reuses cached bounds in between (they only move on zoom changes) —
        a perf knob that also drops the quiet mask from the device fetch.
        N=1 (default) matches the reference's every-frame behaviour.

        scales_async=True takes the scales branch off the per-frame critical
        path: markers publish immediately with the latest known ratio while
        the OCR image fetch + engine + bar scan run on a worker at their own
        cadence (the ratio only changes on zoom, so <=1 frame of staleness is
        invisible). False (default) joins both branches like the reference
        (src/vision/mod.rs:219-223)."""
        self.settings = settings or Settings(path=None)
        self.delegate = BackendDelegate(self.settings, device)
        self.ocr_engine = ocr_engine
        self.debug_view = debug_view
        self.collect_debug_overlays = collect_debug_overlays
        self.minimap_every = max(1, minimap_every)
        self.scales_async = scales_async
        self._frame_counter = 0
        self._minimap_cache: Optional[tuple[tuple[int, int], Optional[Rect]]] = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="vision-branch"
        )
        # OCR is deterministic in its input image + DPI: identical frames
        # (map not panning) reuse the previous ratio instead of re-running
        # Tesseract — a >10ms/frame win the reference leaves on the table.
        # Keyed on the device-side scales checksum when the backend has one
        # (no pixel fetch at all on a hit), else on host content crc32.
        self._scales_cache: Optional[tuple[object, Optional[float]]] = None
        self._scales_future: Optional[concurrent.futures.Future] = None
        self._last_ratio: Optional[float] = None

    # ------------------------------------------------------------------

    def _prepare(self, backend, frame: Frame) -> tuple[bool, tuple[int, int]]:
        """Set per-frame backend flags; decide the minimap cadence."""
        if hasattr(backend, "set_debug"):
            backend.set_debug(self.debug_view != DebugView.NONE)
        if hasattr(backend, "scales_enabled"):
            backend.scales_enabled = self.ocr_engine is not None and not heightmaps.is_set()
        if hasattr(backend, "scales_binary_ok"):
            backend.scales_binary_ok = bool(getattr(self.ocr_engine, "binary_ok", False))
        if hasattr(backend, "scales_image_derived"):
            backend.scales_image_derived = bool(
                getattr(self.ocr_engine, "image_derived", False)
            )
        if hasattr(backend, "scales_device_ok"):
            import os as _os

            backend.scales_device_ok = bool(
                getattr(self.ocr_engine, "device_ok", False)
            ) and _os.environ.get("SMH_DEVICE_SCALES", "1") != "0"

        frame_size = (frame.image.shape[1], frame.image.shape[0])
        self._frame_counter += 1
        minimap_due = (
            self.minimap_every == 1
            or self._frame_counter % self.minimap_every == 1
            or self._minimap_cache is None
            or self._minimap_cache[0] != frame_size
        )
        if hasattr(backend, "quiet_enabled"):
            backend.quiet_enabled = minimap_due
        return minimap_due, frame_size

    def submit(self, frame: Frame) -> Optional[dict]:
        """Pipelined mode: upload + dispatch a frame WITHOUT waiting for its
        results, so the fetch of the previous frame overlaps this one's
        device work. Returns None when the backend cannot pipeline."""
        fid = _frame_id(frame)
        with span("vision.submit", frame=fid):
            backend = self.delegate.current()
            if not hasattr(backend, "snapshot_job"):
                return None
            try:
                with span("vision.prepare"):
                    minimap_due, frame_size = self._prepare(backend, frame)
                with span("vision.load_frame", cpu=True):
                    backend.load_frame(frame.image)
                with span("vision.dispatch", cpu=True):
                    backend.dispatch(grayscale=self.settings.grayscale_map())
                with span("vision.snapshot"):
                    job = backend.snapshot_job()
                return {"job": job, "minimap_due": minimap_due, "frame_size": frame_size, "frame": fid}
            except Exception:
                log.exception("submit failed; frame will be processed unpipelined")
                return None

    def process(
        self, frame: Frame, debug: Optional[DebugBox] = None, submitted: Optional[dict] = None
    ) -> Optional[VisionResults]:
        fid = submitted["frame"] if submitted is not None else _frame_id(frame)
        with span("vision.consume", frame=fid):
            return self._process(self.delegate.current(), frame, debug, submitted)

    def _process(
        self,
        backend,
        frame: Frame,
        debug: Optional[DebugBox],
        submitted: Optional[dict] = None,
    ) -> Optional[VisionResults]:
        debug = debug if debug is not None else DebugBox()
        shares = debug.timeshares
        start = time.perf_counter()

        if submitted is not None:
            # Consume the submitted frame through its snapshot VIEW: per-frame
            # state frozen at dispatch time, adaptation state shared with the
            # live backend — a concurrent submit(N+1) cannot disturb it (and
            # vice versa), which is what lets the loop run submit and consume
            # on different threads.
            backend = submitted["job"]
            minimap_due = submitted["minimap_due"]
            frame_size = submitted["frame_size"]
        else:
            minimap_due, frame_size = self._prepare(backend, frame)
            with timeshare(shares, "load_frame"):
                backend.load_frame(frame.image)

        with timeshare(shares, "crop_to_map"):
            cropped = backend.crop_to_map(self.settings.grayscale_map())
        if cropped is None:
            shares.entire_frame = time.perf_counter() - start
            return None  # "sleeping": deployment map closed

        ui_map, (x, y, w, h) = cropped
        brq_w, brq_h = w // 2, h // 2
        results = VisionResults(map_fn=ui_map if callable(ui_map) else (lambda: ui_map))

        with timeshare(shares, "find_minimap"):
            if not minimap_due and self._minimap_cache is not None:
                results.minimap_bounds = self._minimap_cache[1]
            else:
                rect_fn = getattr(backend, "minimap_rect", None)
                rect = rect_fn() if callable(rect_fn) else None
                if rect is not None:
                    results.minimap_bounds = rect
                else:
                    cpu_frame = backend.get_cpu_frame()
                    results.minimap_bounds = fm.find_minimap(cpu_frame[y : y + h, x : x + w])
                self._minimap_cache = (frame_size, results.minimap_bounds)

        def markers_branch() -> list[Line]:
            if not self.settings.detect_markers():
                return []
            backend.thread_ctx()
            with timeshare(shares, "isolate_map_markers"):
                backend.isolate_map_markers()
            with timeshare(shares, "mask_marker_lines"):
                backend.mask_marker_lines()
            with timeshare(shares, "find_marker_lines"):
                return backend.find_marker_lines(C.LSD_MAX_GAP)

        def scales_branch() -> Optional[float]:
            import zlib

            backend.thread_ctx()
            dpi = frame.dpi

            # Checksum-first: backends with device-side change detection
            # (scales_check) let a cache hit skip the OCR-image fetch
            # entirely — zero D2H bytes for the whole branch.
            check_fn = getattr(backend, "scales_check", None)
            check = check_fn() if callable(check_fn) else None
            cache_key: Optional[object] = None
            if check is not None:
                cache_key = (check, dpi)
                if (
                    not self.collect_debug_overlays
                    and self._scales_cache is not None
                    and self._scales_cache[0] == cache_key
                ):
                    return self._scales_cache[1]

            # Device-read scales: the dispatch already classified the glyphs
            # and scanned the bars on the TPU — no image fetch, no host OCR.
            # (None return = capacity overflow with nothing trusted: take the
            # image path below for this frame.)
            dev_fn = getattr(backend, "device_scales", None)
            dev = (
                dev_fn()
                if callable(dev_fn) and not self.collect_debug_overlays
                else None
            )
            if dev is not None:
                _words, ratio = dev
                if cache_key is not None:
                    self._scales_cache = (cache_key, ratio)
                return ratio

            with timeshare(shares, "ocr_preprocess"):
                ocr_image = backend.ocr_preprocess()

            if cache_key is None:
                # Host-content fallback key (numpy backend): the cached ratio
                # depends on the OCR image, the DPI AND the binarized scales
                # plane (bar widths live there) — only cache when the backend
                # can fingerprint the latter.
                fp_fn = getattr(backend, "scales_fingerprint", None)
                fp = fp_fn() if callable(fp_fn) else None
                if fp is not None:
                    cache_key = zlib.crc32(ocr_image.tobytes()) ^ (hash(dpi) & 0xFFFFFFFF) ^ fp
                    if (
                        not self.collect_debug_overlays
                        and self._scales_cache is not None
                        and self._scales_cache[0] == cache_key
                    ):
                        return self._scales_cache[1]

            with timeshare(shares, "ocr"):
                ocr_results = self.ocr_engine.read(ocr_image, dpi)

            if self.collect_debug_overlays:
                debug.ocr.extend(
                    dataclasses.replace(
                        o,
                        left=o.left + brq_w,
                        top=o.top + brq_h,
                        right=o.right + brq_w,
                        bottom=o.bottom + brq_h,
                    )
                    for o in ocr_results
                )

            scales, scales_start_y = _parse_scales(ocr_results)
            if not scales or scales_start_y is None:
                if cache_key is not None:
                    self._scales_cache = (cache_key, None)
                return None

            with timeshare(shares, "find_scales_preprocess"):
                scales_image = backend.find_scales_preprocess(scales_start_y)

            debug_scales = [] if self.collect_debug_overlays else None
            with timeshare(shares, "calc_meters_to_px_ratio"):
                ratio = mpx.calc_meters_to_px_ratio(scales, scales_image, debug_scales)
            if debug_scales:
                debug.scales.extend(
                    (
                        m,
                        Line.from_tuple(
                            (
                                (l.p0.x + brq_w, l.p0.y + brq_h),
                                (l.p1.x + brq_w, l.p1.y + brq_h),
                            )
                        ),
                    )
                    for m, l in debug_scales
                )
            if cache_key is not None:
                self._scales_cache = (cache_key, ratio)
            return ratio

        # Scales branch is skipped entirely when a heightmap supplies
        # distances (src/vision/mod.rs:121-123) or no OCR engine exists.
        # Must mirror the decision that shaped the DISPATCHED hostpack, not a
        # fresh heightmaps.is_set() read (a heightmap toggled mid-flight would
        # make scales_branch read a section that was never packed).
        run_scales = self.ocr_engine is not None and getattr(
            backend, "scales_enabled", not heightmaps.is_set()
        )
        if (
            run_scales
            and self.scales_async
            and not self.collect_debug_overlays
            and callable(getattr(backend, "snapshot_scales_job", None))
        ):
            results.markers = markers_branch()
            results.meters_to_px_ratio = self._scales_async_step(backend, frame.dpi)
        elif run_scales:
            fid = frame.seq

            def traced(branch, name):
                def run():
                    with span(name, frame=fid):
                        return branch()

                return run

            f_markers = self._pool.submit(traced(markers_branch, "vision.markers"))
            f_scales = self._pool.submit(traced(scales_branch, "vision.scales"))
            results.markers = f_markers.result()
            results.meters_to_px_ratio = f_scales.result()
        else:
            results.markers = markers_branch()
            results.meters_to_px_ratio = None

        shares.entire_frame = time.perf_counter() - start

        if self.debug_view != DebugView.NONE:
            results.debug_view = backend.get_debug_view(self.debug_view)
            debug.debug_view = results.debug_view

        return results

    def _scales_async_step(self, backend, dpi) -> Optional[float]:
        """Off-critical-path scales: harvest any finished worker, start a new
        one when this frame's checksum misses the cache, and return the
        latest known ratio. The worker closes over THIS frame's immutable
        device arrays (snapshot_scales_job), so later dispatches cannot race
        it. At most one worker is in flight: a burst of changing frames
        coalesces to the newest once the worker frees up."""
        fut = self._scales_future
        if fut is not None and fut.done():
            self._scales_future = None
            try:
                key, ratio = fut.result()
            except Exception:
                log.exception("async scales branch failed")
            else:
                self._scales_cache = (key, ratio)
                self._last_ratio = ratio

        job = backend.snapshot_scales_job()
        if job is None:
            return self._last_ratio
        key = (job["check"], dpi)
        if self._scales_cache is not None and self._scales_cache[0] == key:
            self._last_ratio = self._scales_cache[1]
        elif "device" in job:
            # Device-read scales: already decoded from this frame's hostpack —
            # consume inline (cheaper than a worker handoff, no fetch at all).
            if "count" in job:
                job["count"]("device_scales_frames")
            _words, ratio = job["device"]
            self._scales_cache = (key, ratio)
            self._last_ratio = ratio
        elif self._scales_future is None:
            if job.get("had_records"):
                # Records existed but were not serveable: the engine path
                # this worker runs is the device-scales fallback.
                job["count"]("device_scales_fallbacks")
            engine = self.ocr_engine

            def work():
                ocr_image, scales_img = job["fetch"]()
                ocr_results = engine.read(ocr_image, dpi)
                scales, start_y = _parse_scales(ocr_results)
                if not scales or start_y is None:
                    return key, None
                return key, mpx.calc_meters_to_px_ratio(scales, scales_img)

            self._scales_future = self._pool.submit(work)
        return self._last_ratio

    def close(self) -> None:
        self._pool.shutdown(wait=False)


class VisionLoop:
    """The 15 FPS budget loop on its own thread (src/vision/mod.rs:243-315).

    `on_update(results_or_none, debug)` is invoked per processed frame
    (None = sleeping), mirroring ui::update."""

    def __init__(
        self,
        state: VisionState,
        capture: CaptureThread,
        on_update,
        fps: float = float(C.VISION_FPS),
        pipelined: bool = False,
        depth: int = 3,
        threaded_submit: Optional[bool] = None,
    ) -> None:
        """pipelined=True keeps up to `depth` frames in flight: frame N's
        upload + device dispatch + background hostpack D2H overlap the host
        stages of frames N-1..N-depth+1 (the BASELINE "double-buffered
        streaming capture" configuration, deepened).

        depth sizes the window against the relay's fetch completion latency:
        the hostpack lands ~35-45 ms after dispatch (background transfer,
        docs/DESIGN.md §3) while the per-frame host half is ~17 ms at 4K, so
        depth 3 hides the fetch entirely (throughput ≈ host CPU) where
        depth 2 pays ~half of it. At the production 15 FPS cap the 66 ms
        frame interval exceeds the fetch latency, so every pending frame
        drains immediately and depth adds NO result latency; it only matters
        when the loop runs uncapped (benching, offline).

        threaded_submit runs the submit half (capture poll + pack + diff +
        dispatch) on its own thread, overlapping it with the consume half's
        host stages — BatchPipeline.stream()'s two-thread discipline on the
        per-frame driver. Safe because consume operates on snapshot VIEWS
        (TpuBackend.snapshot_job): submit mutates only the live backend's
        per-frame fields and the submit-owned delta chain. Default: on when
        the host has more than one core (on a single core the two halves
        just time-slice), overridable via SMH_THREADED_SUBMIT=0/1."""
        self.state = state
        self.capture = capture
        self.on_update = on_update
        self._interval = 1.0 / fps
        self.pipelined = pipelined
        import os as _os

        self.depth = max(2, int(_os.environ.get("SMH_PIPE_DEPTH", depth)))
        if threaded_submit is None:
            env = _os.environ.get("SMH_THREADED_SUBMIT")
            if env is not None:
                threaded_submit = env != "0"
            else:
                threaded_submit = (_os.cpu_count() or 1) > 1
        self.threaded_submit = bool(threaded_submit) and pipelined
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fake_input: Optional[np.ndarray] = None  # Fake Input harness

    def _next_frame(self) -> Optional[Frame]:
        if self.fake_input is not None:
            return Frame(self.fake_input, None, new_frame())
        return self.capture.fresh_frame()

    def wake(self) -> None:
        """Re-deliver the current frame even if unchanged: a runtime
        settings flip (grayscale/backend/pause) must take effect on a
        static scene without waiting for new pixels."""
        resend = getattr(self.capture, "resend", None)
        if resend is not None:
            resend()

    def _step(self, frame: Frame, submitted: Optional[dict] = None) -> None:
        debug = DebugBox()
        try:
            results = self.state.process(frame, debug, submitted=submitted)
        except Exception:
            # Per-frame error tolerance: log and drop the frame
            # (src/vision/mod.rs:271-277).
            log.exception("error processing frame")
            return
        with span("loop.on_update", frame=frame.seq):
            self.on_update(results, debug)

    def _run_threaded(self) -> Optional[Frame]:
        """Two-thread pipelined loop: THIS thread consumes (fetch + host
        stages + on_update, in submit order); the submitter thread polls
        capture and runs submit. The queue bounds in-flight frames at
        `depth` (depth-1 queued + 1 being consumed).

        Returns None on shutdown. If submit() ever yields no job (numpy
        backend, or a TPU submit failure that already mutated live state),
        threading is no longer sound — consume would have to touch the live
        backend concurrently with submit — so the submitter hands the
        un-submitted frame back and the caller continues single-threaded."""
        import queue

        jobs: queue.Queue = queue.Queue(maxsize=max(1, self.depth - 1))
        done = object()
        fallback: list[Frame] = []

        def submitter() -> None:
            idle = None  # when the mailbox was first found empty
            try:
                while not self._shutdown.is_set():
                    if self.state.settings.paused():
                        self._shutdown.wait(0.05)
                        continue
                    frame = self._next_frame()
                    if frame is None:
                        if idle is None:
                            idle = time.perf_counter()
                        self._shutdown.wait(self._interval)
                        continue
                    t0 = time.perf_counter()
                    if idle is not None:  # one record for the whole wait, however many polls
                        add("loop.no_frame", WAIT, idle, t0, frame.seq)
                        idle = None
                    sub = self.state.submit(frame)
                    if sub is None:
                        fallback.append(frame)
                        return
                    # Blocking put with a shutdown check (the consumer always
                    # drains, so this makes progress).
                    with span("loop.queue_put", WAIT, frame=frame.seq):
                        while not self._shutdown.is_set():
                            try:
                                jobs.put((frame, sub), timeout=0.2)
                                break
                            except queue.Full:
                                continue
                    elapsed = time.perf_counter() - t0
                    if elapsed < self._interval:
                        with span("loop.pace", WAIT, frame=frame.seq):
                            self._shutdown.wait(self._interval - elapsed)
            finally:
                while True:  # always deliver the sentinel
                    try:
                        jobs.put(done, timeout=0.2)
                        break
                    except queue.Full:
                        try:  # consumer gone at shutdown: make room
                            jobs.get_nowait()
                        except queue.Empty:
                            pass

        t = threading.Thread(target=submitter, name="vision-submit", daemon=True)
        t.start()
        while True:
            with span("loop.queue_get", WAIT):
                j = jobs.get()
            if j is done:
                break
            frame, sub = j
            self._step(frame, sub)
        t.join(timeout=5.0)
        if fallback and not self._shutdown.is_set():
            log.info("backend cannot pipeline; dropping to the single-threaded loop")
            return fallback[0]
        return None

    def _run(self) -> None:
        from collections import deque

        if self.pipelined and self.threaded_submit:
            leftover = self._run_threaded()
            if leftover is None:
                return
            self._step(leftover)
            self.threaded_submit = False  # continue single-threaded below

        # Pending submitted frames, oldest first; at most depth-1 wait here
        # (the depth-th is the one being submitted).
        pending: deque[tuple[Frame, dict]] = deque()

        def drain_one() -> None:
            f, sub = pending.popleft()
            self._step(f, sub)

        idle = None  # when the mailbox was first found empty
        while not self._shutdown.is_set():
            if self.state.settings.paused():
                while pending:  # drain before parking
                    drain_one()
                self._shutdown.wait(0.05)
                continue

            frame = self._next_frame()

            if frame is None:
                if pending:
                    drain_one()
                    continue
                if idle is None:
                    idle = time.perf_counter()
                self._shutdown.wait(self._interval)
                continue

            t0 = time.perf_counter()
            if idle is not None:
                add("loop.no_frame", WAIT, idle, t0, frame.seq)
                idle = None

            if self.pipelined:
                sub = self.state.submit(frame)
                if sub is not None:
                    pending.append((frame, sub))
                    if len(pending) >= self.depth:
                        drain_one()
                    elapsed = time.perf_counter() - t0
                    if elapsed < self._interval:
                        with span("loop.pace", WAIT, frame=frame.seq):
                            self._shutdown.wait(self._interval - elapsed)
                    continue
                # Backend can't pipeline: keep delivery order — drain the
                # older pending frames before processing this one.
                while pending:
                    drain_one()

            self._step(frame)
            elapsed = time.perf_counter() - t0
            if elapsed < self._interval:
                with span("loop.pace", WAIT, frame=frame.seq):
                    self._shutdown.wait(self._interval - elapsed)

        while pending:
            drain_one()
        log.info("vision loop shutting down")

    def start(self) -> "VisionLoop":
        self._thread = threading.Thread(target=self._run, name="vision", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._shutdown.set()
        joined = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            joined = not self._thread.is_alive()
        if joined:
            self.state.close()
        else:
            # The vision thread is stuck in a long device call (first-frame
            # compiles can take minutes): closing the branch pool under it
            # would cascade "cannot schedule new futures" errors. Leave the
            # daemon thread to finish/die with the process.
            log.warning("vision thread still busy at stop(); leaving state open")
