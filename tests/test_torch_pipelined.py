"""The port's pipelined loop on the CPU: VisionLoop(pipelined=True) over the
port's CudaBackend (delta chain, consume views, the async fetch) publishes
only results that equal the synchronous result of some input frame,
threaded and single-threaded; a consume view keeps its frame's bytes while
the live backend moves on; snapshot_scales_job hands the async scales step
the same job smh_tpu's TpuBackend does. All comparisons are exact."""

import logging
import time

import numpy as np
import pytest
import torch

from smh_tpu import consts as C
from smh_tpu import native
from smh_tpu.ocr.smhocr import SmhOcrEngine
from smh_tpu.settings import Settings
from smh_tpu.squadex.capture import CaptureThread, Frame
from smh_tpu.vision import tpu_backend as tb
from smh_tpu_torch import testing
from smh_tpu_torch.vision import cuda_backend as cb
from smh_tpu_torch.vision.pipeline import VisionLoop, VisionState

torch.set_num_threads(1)

W, H = 1280, 720

pytestmark = pytest.mark.skipif(not native.available(), reason="the native host module did not build")


def frame_with(off: int) -> np.ndarray:
    return testing.make_frame(
        W, H,
        marker_lines=[((120 + off, 150), (380 + off, 320))],
        scale_texts=[("300m", (60, 170))],
        scale_bars=[(60, 200, 120, 1)],
    )


FRAMES = [frame_with(10 * i) for i in range(3)]


def make_state(**kw) -> VisionState:
    s = Settings(path=None)
    s.set("hardware_acceleration", True, save=False)
    return VisionState(settings=s, ocr_engine=SmhOcrEngine(), device="cpu", **kw)


def summarize(r):
    return (
        len(r.markers),
        None if not r.markers else (r.markers[0].p0.x, r.markers[0].p0.y, r.markers[0].p1.x),
        r.meters_to_px_ratio,
        r.minimap_bounds,
    )


class Cycle:
    def __init__(self, frames):
        self.frames = frames
        self.i = 0

    def grab(self):
        self.i += 1
        return Frame(self.frames[self.i % len(self.frames)], 96)


class ErrorCount(logging.Handler):
    """Counts the frames VisionLoop._step logs and drops."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.n = 0

    def emit(self, record):
        self.n += 1


@pytest.fixture(scope="module")
def truths():
    state = make_state()
    try:
        return {summarize(state.process(Frame(f, 96))) for f in FRAMES}
    finally:
        state.close()


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("scales_async", [False, True])
def test_pipelined_loop_matches_sync(truths, threaded, scales_async):
    assert len(truths) == 3
    state = make_state(scales_async=scales_async)
    submits = []
    submit = state.submit
    state.submit = lambda frame: submits.append(1) or submit(frame)
    errors = ErrorCount()
    log = logging.getLogger("smh_tpu.vision.pipeline")
    log.addHandler(errors)
    updates = []
    cap = CaptureThread(Cycle(FRAMES), hz=120).start()
    loop = VisionLoop(
        state, cap, lambda r, d: updates.append(r), fps=120, pipelined=True,
        threaded_submit=threaded,
    ).start()
    try:
        deadline = time.time() + 120
        while len(updates) < 6 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        loop.stop()
        cap.stop()
        log.removeHandler(errors)
    assert errors.n == 0
    assert len(updates) >= 6
    seen = {summarize(u) for u in updates}
    assert seen <= truths, "a torn or mis-applied frame"
    assert len(seen) >= 2
    be = state.delegate.backend
    assert len(submits) >= len(updates)  # every frame went through submit
    assert be.stats["full_uploads"] == 1 and be.stats["delta_frames"] >= 5
    assert be.stats["device_scales_fallbacks"] == 0


def test_consume_view_keeps_its_frame_after_the_next_dispatch():
    """A view of frame N re-dispatched (grayscale flip) after the live
    backend dispatched N+1 through the delta chain still analyses frame N:
    the scatter writes a fresh buffer, never the one a view holds."""
    be = cb.CudaBackend(device="cpu")
    be.delta_mode = "on"
    be.scales_device_ok = True
    be.load_frame(FRAMES[0])
    be.dispatch(grayscale=True)
    be.load_frame(FRAMES[1])
    be.dispatch(grayscale=True)
    view = be.snapshot_job()
    assert view.stats is be.stats and view._adapt is be._adapt
    assert view._pending is None and view._fetch is be._fetch
    frame1_bytes = be._pending_host.copy()
    be.load_frame(FRAMES[2])
    be.dispatch(grayscale=True)
    assert be.stats["delta_frames"] == 2 and be._resident is not view._resident
    assert view.crop_to_map(False) is not None  # re-dispatch on the view
    np.testing.assert_array_equal(view._resident.numpy(), frame1_bytes)
    view.mask_marker_lines()
    lines = view.find_marker_lines(C.LSD_MAX_GAP)

    ref = cb.CudaBackend(device="cpu")
    ref.scales_device_ok = True
    ref.load_frame(FRAMES[1])
    assert ref.crop_to_map(False) is not None
    np.testing.assert_array_equal(view._fetch[0].numpy(), ref._fetch[0].numpy())
    ref.mask_marker_lines()
    assert [(l.p0, l.p1) for l in lines] == [(l.p0, l.p1) for l in ref.find_marker_lines(C.LSD_MAX_GAP)]
    assert be.crop_to_map(True) is not None  # the live backend is frame 2's
    np.testing.assert_array_equal(be._resident.numpy(), be._mirror)


def _jax_job(port: cb.CudaBackend) -> dict:
    """TpuBackend.snapshot_scales_job over the port's parsed sections."""
    ref = tb.TpuBackend()
    ref.geom = port.geom
    ref._host = port._host
    ref._results = {"scalespack": port._results["scalespack"].numpy()}
    return ref.snapshot_scales_job()


def _junk(frame: np.ndarray) -> np.ndarray:
    """Text-like bars that overflow every record slot (the device read is
    then untrusted and the host engine reads the scalespack)."""
    g = C.map_geometry(W, H)
    view = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
    for b in range(8):
        for k in range(20):
            view[4 + 14 * b : 12 + 14 * b, 8 + 6 * k, :3] = 245
    return frame


def test_snapshot_scales_job_serves_the_device_read_inline():
    state = make_state(scales_async=True)
    try:
        r1 = state.process(Frame(FRAMES[0], 96))
        be = state.delegate.backend
        job = be.snapshot_scales_job()
        want = _jax_job(be)
        assert set(job) == set(want) == {"check", "fetch", "count", "had_records", "device"}
        assert job["check"] == want["check"] and job["device"] == want["device"]
        r2 = state.process(Frame(FRAMES[1], 96))
    finally:
        state.close()
    assert r1.meters_to_px_ratio == r2.meters_to_px_ratio == pytest.approx(300 / 118)
    # Counted on the checksum-cache miss only; no image fetched.
    assert be.stats["device_scales_frames"] == 1
    assert be.stats["scalespack_fetches"] == 0 and be.stats["device_scales_fallbacks"] == 0


def test_snapshot_scales_job_falls_back_to_the_scalespack():
    frame = _junk(frame_with(0))
    state = make_state(scales_async=True)
    try:
        state.process(Frame(frame, 96))
        be = state.delegate.backend
        job = be.snapshot_scales_job()
        want = _jax_job(be)
        assert set(job) == set(want) == {"check", "fetch", "count", "had_records"}
        state._scales_future.result(timeout=60)  # the worker's fetch + engine read
        r = state.process(Frame(frame, 96))
        stats = dict(be.stats)
        ocr, scales = job["fetch"]()
        ocr_ref, scales_ref = want["fetch"]()
    finally:
        state.close()
    np.testing.assert_array_equal(ocr, ocr_ref)
    np.testing.assert_array_equal(scales, scales_ref)
    assert r.meters_to_px_ratio == pytest.approx(300 / 118)
    assert stats["device_scales_fallbacks"] == 1 and stats["scalespack_fetches"] == 1
    assert stats["device_scales_frames"] == 0


def test_snapshot_scales_job_without_device_read(monkeypatch):
    """An engine without the device read: no records, so no counter; smhocr
    takes the binary band inline, so the worker's fetch reads the band (the
    same images as TpuBackend's job) and fetches no scalespack."""
    monkeypatch.setenv("SMH_DEVICE_SCALES", "0")
    state = make_state(scales_async=True)
    try:
        state.process(Frame(FRAMES[0], 96))
        be = state.delegate.backend
        assert be._dispatch_flags.inline == "binary" and be._dispatch_flags.band is not None
        job = be.snapshot_scales_job()
        want = _jax_job(be)
        assert set(job) == set(want) == {"check", "fetch"}
        for got, ref in zip(job["fetch"](), want["fetch"](), strict=True):
            np.testing.assert_array_equal(got, ref)
        state._scales_future.result(timeout=60)
        r = state.process(Frame(FRAMES[0], 96))
    finally:
        state.close()
    assert r.meters_to_px_ratio == pytest.approx(300 / 118)
    assert be.stats["scalespack_fetches"] == 0 and be.stats["device_scales_frames"] == 0
