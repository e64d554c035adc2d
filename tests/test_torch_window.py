"""CudaBackend (on the CPU) against smh_tpu's TpuBackend over frame
sequences: the window-crop LSD transport under SMH_SPARSE=0 (fit, miss ->
fallback -> escalation, shrink after a streak, empty mask), the sparse ->
probation -> window hand-over, the inline -> checksum-only scales
adaptation, the row band (exact, miss, textless), and the three engine
configurations (Tesseract, smhocr without the device read, the fake
engine). After every frame the lines, the hostpack bytes, the stats, the
ladders and the parsed `_host` sections must be equal.

Tests of tests/test_hostpack_v2.py, on 960x540 frames: the map's bit mask
(25 KB) is above the 16 KiB windowing floor and the quadrant's bit plane
(6.4 KB) above the 4 KiB band floor, and JAX's CPU compiles stay cheap.

Each side runs its own package's driver, OCR engines, settings and frames;
results are compared by value."""

import dataclasses

import numpy as np
import pytest
import torch

import smh_tpu.ocr as jocr
from smh_tpu.ocr import smhocr as jsmhocr
from smh_tpu.settings import Settings as JSettings
from smh_tpu.squadex.capture import Frame as JFrame
from smh_tpu.vision import pipeline as jpipeline
from smh_tpu.vision import tpu_backend as tb
from smh_tpu_torch import consts as C, testing
from smh_tpu_torch import ocr as tocr
from smh_tpu_torch.ocr import smhocr as tsmhocr
from smh_tpu_torch.settings import Settings
from smh_tpu_torch.squadex.capture import Frame
from smh_tpu_torch.vision import cuda_backend as cb
from smh_tpu_torch.vision import pipeline as tpipeline
from test_torch_backend import PORT_COUNTERS
from test_torch_reference import _reference_native  # noqa: F401  (module-scoped autouse fixture)

torch.set_num_threads(1)


W, H = 960, 540
G = C.map_geometry(W, H)
TEXT = ("300m", (30, 70))  # BRQ coordinates; the bar sits below it
BAR = (30, 96, 60, 1)
RATIO = 300.0 / 58.0  # a 60 px bar with end bars measures 58


@pytest.fixture(autouse=True)
def _window_transport(monkeypatch):
    monkeypatch.setenv("SMH_SPARSE", "0")


def small_lines_frame(off=0, texts=()):
    return testing.make_frame(
        W, H, marker_lines=[((60 + off, 75), (190 + off, 160))],
        scale_texts=list(texts), scale_bars=[BAR],
    )


def spanning_lines_frame():
    return testing.make_frame(
        W, H,
        marker_lines=[
            ((10, 10), (G.map_w - 15, G.map_h - 20)),
            ((G.map_w - 25, 20), (15, G.map_h - 30)),
        ],
        scale_bars=[BAR],
    )


def _lines(lines):
    return [((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in lines]


ADAPT_FIELDS = [f for f in cb._AdaptState.__slots__ if f not in ("ui_check", "ui_map_cache")]


def assert_same_state(port: cb.CudaBackend, ref: tb.TpuBackend) -> None:
    """Hostpack bytes, stats, every ladder field and the parsed sections."""
    np.testing.assert_array_equal(port._results["hostpack"].numpy(), np.asarray(ref._results["hostpack"]))
    assert {k: v for k, v in port.stats.items() if k not in PORT_COUNTERS} == ref.stats
    for name in ADAPT_FIELDS:
        assert getattr(port._adapt, name) == getattr(ref._adapt, name), name
    f, rf = port._dispatch_flags, ref._dispatch_flags
    assert (f.with_ocr, f.with_quiet, f.grayscale, f.crop_h, f.crop_w) == rf[:5]
    assert (f.inline, f.band, f.sparse) == (rf[6], rf[7], rf[9])
    if port._host is None or ref._host is None:
        assert port._host is ref._host is None
        return
    assert set(port._host) == set(ref._host)
    for key, want in ref._host.items():
        got = port._host[key]
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=key)
        elif key == "scales_records":
            assert [dataclasses.astuple(w) for w in got.words] == [dataclasses.astuple(w) for w in want.words]
            assert got.complete == want.complete
        else:
            assert got == want, key


def detect_both(port, ref, frame) -> list:
    """One frame through both backends' stages; the same lines and state."""
    out = []
    for be in (port, ref):
        be.load_frame(frame)
        assert be.crop_to_map(True) is not None
        be.mask_marker_lines()
        out.append(_lines(be.find_marker_lines(C.LSD_MAX_GAP)))
    assert out[0] == out[1]
    assert_same_state(port, ref)
    return out[0]


def backends(rung=None):
    port, ref = cb.CudaBackend(device="cpu"), tb.TpuBackend(lsd_engine="native")
    if rung is not None:
        port._adapt.rung_h = port._adapt.rung_w = rung
        ref._rung_h = ref._rung_w = rung
    return port, ref


def full_window_lines(frame):
    """Detection through the full-plane window (the round-1 transport)."""
    be = cb.CudaBackend(device="cpu")
    be.load_frame(frame)
    be._adapt.ladder_h = cb._dim_ladder(G.map_h)
    be._adapt.ladder_w = cb._dim_ladder(G.map_w)
    be._adapt.rung_h = be._adapt.rung_w = len(be._adapt.ladder_h) - 1
    assert be.crop_to_map(True) is not None
    assert be._dispatch_flags.crop_h is None
    return _lines(be.find_marker_lines(C.LSD_MAX_GAP))


def test_window_fits():
    frame = small_lines_frame()
    port, ref = backends(rung=cb._RUNG_HALF)
    lines = detect_both(port, ref, frame)
    assert port.stats["lsd_window_misses"] == 0 and len(lines) == 1
    assert port._host["lsd_crop_shape"] == (G.map_h // 2, G.map_w // 2)
    assert port._host["lsd_offset"] != (0, 0)
    assert lines == full_window_lines(frame)


def test_window_miss_falls_back_and_escalates():
    frame = spanning_lines_frame()
    port, ref = backends(rung=0)  # the smallest window: the lines cannot fit
    lines = detect_both(port, ref, frame)
    assert port.stats["lsd_window_misses"] == 1 and len(lines) == 2
    assert port._adapt.rung_h > 0 and port._adapt.rung_w > 0
    assert lines == full_window_lines(frame)
    detect_both(port, ref, frame)  # the escalated window fits
    assert port.stats["lsd_window_misses"] == 1


def test_rung_shrinks_after_streak():
    start = cb._RUNG_HALF + 1
    port, ref = backends(rung=start)
    detect_both(port, ref, small_lines_frame())
    assert (port._adapt.rung_h, port._adapt.rung_w) == (start, start)
    for _ in range(cb._SHRINK_AFTER):
        for be in (port, ref):
            be.dispatch()
            be.crop_to_map(True)
        assert_same_state(port, ref)
    assert port._adapt.rung_h == start - 1 and port._adapt.rung_w <= start


def test_empty_mask():
    frame = testing.make_frame(W, H, marker_lines=[], scale_bars=[BAR])
    port, ref = backends()
    assert detect_both(port, ref, frame) == []
    y0, y1, _, _ = port._host["lsd_bbox"]
    assert y0 >= y1 and port._host["lsd_crop_bits"] is None


def test_sparse_steps_aside_for_the_window_then_reprobes(monkeypatch):
    """Dense content overflows every sparse rung: after _SP_OFF_AFTER misses
    the sparse transport steps aside, the window ladder carries the mask
    through the probation, and the re-probe brings sparse back."""
    monkeypatch.setenv("SMH_SPARSE", "1")
    dense = small_lines_frame()
    dense[G.map_y : G.map_y + G.map_h : 4, G.map_x : G.map_x + G.map_w] = (0, 255, 64, 255)
    port, ref = backends()
    routes = []
    for _ in range(cb._SP_OFF_AFTER + cb._SHRINK_AFTER + 1):
        detect_both(port, ref, dense)
        f = port._dispatch_flags
        routes.append("sparse" if f.sparse is not None else ("window" if f.crop_h else "full"))
    off = cb._SP_OFF_AFTER
    assert routes[:off] == ["sparse"] * off
    aside = routes[off:].index("sparse")  # the re-probe
    assert aside == cb._SHRINK_AFTER - 1 and "sparse" not in routes[off : off + aside]
    assert port._adapt.ladder_h is not None  # the window ladder ran
    assert port.stats["lsd_sparse_misses"] == off + len(routes) - (off + aside)  # dense: every probe misses


# -- scales transports through VisionState ----------------------------------------


def _settings(cls):
    s = cls(path=None)
    s.set("hardware_acceleration", True, save=False)
    return s


def _states(engine_factory):
    """engine_factory(ocr package) -> an engine of that package."""
    port = tpipeline.VisionState(settings=_settings(Settings), ocr_engine=engine_factory(tocr), device="cpu")
    ref = jpipeline.VisionState(settings=_settings(JSettings), ocr_engine=engine_factory(jocr))
    return port, ref


def process_both(port, ref, frame):
    rp, rr = port.process(Frame(frame, 96)), ref.process(JFrame(frame, 96))
    assert (rp is None) == (rr is None)
    if rp is not None:
        assert [l.as_tuple() for l in rp.markers] == [l.as_tuple() for l in rr.markers]
        assert rp.meters_to_px_ratio == rr.meters_to_px_ratio
        assert dataclasses.astuple(rp.minimap_bounds) == dataclasses.astuple(rr.minimap_bounds)
    assert_same_state(port.delegate.backend, ref.delegate.backend)
    return rp


def _fake(ocr):
    return ocr.FakeOcrEngine([ocr.OcrResult("300m", 91.0, 34, 76, 88, 91)])  # TEXT's box


def _smhocr(ocr):
    return {tocr: tsmhocr, jocr: jsmhocr}[ocr].SmhOcrEngine()


def _smhocr_image_path(ocr):
    engine = _smhocr(ocr)
    engine.device_ok = False  # the band transports, not the device read
    return engine


def test_inline_scales_adapt_to_checksum_only():
    """Images ride inline while the scales change; after
    _INLINE_STABLE_AFTER unchanged checksums they drop out (checksum
    only); a change costs one scalespack fetch and brings them back."""
    port, ref = _states(_fake)
    try:
        r1 = process_both(port, ref, small_lines_frame(0))
        be = port.delegate.backend
        assert be._dispatch_flags.inline == "binary" and be._dispatch_flags.band is None
        for off in range(1, cb._INLINE_STABLE_AFTER + 2):
            r = process_both(port, ref, small_lines_frame(off))
            assert r.meters_to_px_ratio == r1.meters_to_px_ratio
        assert be._dispatch_flags.inline == "none" and be.stats["scalespack_fetches"] == 0
        changed = small_lines_frame(1)
        changed[G.brq_y + 150 : G.brq_y + 160, G.brq_x + 150 : G.brq_x + 190, :3] = 255
        process_both(port, ref, changed)
        assert be.stats["scalespack_fetches"] == 1
        process_both(port, ref, small_lines_frame(2))
        assert be._dispatch_flags.inline == "binary"
    finally:
        port.close()
        ref.close()


def test_band_exact_then_shrinks():
    port, ref = _states(_smhocr_image_path)
    try:
        for i in range(cb._BAND_SHRINK_AFTER + 1):
            frame = small_lines_frame(texts=[TEXT])
            # A black pixel the OCR preprocess drops: the scales checksum
            # changes every frame, so the images stay inline.
            frame[G.brq_y + 200, G.brq_x + 100 + i, :3] = 0
            r = process_both(port, ref, frame)
            assert r.meters_to_px_ratio == pytest.approx(RATIO)
        be = port.delegate.backend
        assert be._dispatch_flags.inline == "binary" and isinstance(be._host["scales_band"], tuple)
        assert be.stats["scales_band_misses"] == 0 and be.stats["scalespack_fetches"] == 0
        assert be._adapt.band_rung == cb._RUNG_HALF - 1  # a sustained small band shrank it
    finally:
        port.close()
        ref.close()


def test_band_miss_falls_back_and_escalates():
    port, ref = _states(_smhocr_image_path)
    try:
        frame = small_lines_frame(texts=[TEXT, ("900m", (150, G.brq_h - 25))])
        r = process_both(port, ref, frame)
        be = port.delegate.backend
        assert be.stats["scales_band_misses"] == 1 and be.stats["scalespack_fetches"] == 1
        assert be._host["scales_band"] == "miss" and be._adapt.band_rung > cb._RUNG_HALF
        assert r.meters_to_px_ratio == pytest.approx(RATIO)
    finally:
        port.close()
        ref.close()


def test_band_textless_without_a_fetch():
    port, ref = _states(_smhocr_image_path)
    try:
        r = process_both(port, ref, testing.make_frame(W, H, marker_lines=[((60, 75), (190, 160))]))
        be = port.delegate.backend
        assert r.meters_to_px_ratio is None
        assert be._host["scales_band"][2] is True and be.stats["scalespack_fetches"] == 0
    finally:
        port.close()
        ref.close()


# -- the three engine configurations -------------------------------------------


def _tesseract(monkeypatch, tmp_path):
    """Each package's Tesseract binding over the port's C shim of the API
    and the port's traineddata."""
    from smh_tpu.ocr import tesseract as jtess
    from smh_tpu_torch.native import tessmock
    from smh_tpu_torch.ocr import tesseract as ttess
    from smh_tpu_torch.ocr.tessdata_gen import ensure_default

    so = tessmock.lib_path()
    if so is None:
        pytest.skip("no C++ toolchain for smhtess")
    monkeypatch.setenv("SMH_TESS_LIB", str(so))
    ensure_default(tmp_path)
    return lambda ocr: {tocr: ttess, jocr: jtess}[ocr].TesseractEngine(tessdata=str(tmp_path))


@pytest.mark.parametrize("engine", ["tesseract", "smhocr_no_device_read", "fake"])
def test_engine_configurations_match(engine, monkeypatch, tmp_path):
    """Tesseract (binary_ok False: the gray band), smhocr with
    SMH_DEVICE_SCALES=0 (the binary band) and the fake engine (canned boxes
    may point anywhere, so it turns banding off): the same transports,
    sections and ratio as TpuBackend."""
    if engine == "tesseract":
        factory = _tesseract(monkeypatch, tmp_path)
        want = ("gray", True)
    elif engine == "smhocr_no_device_read":
        monkeypatch.setenv("SMH_DEVICE_SCALES", "0")
        factory = _smhocr
        want = ("binary", True)
    else:
        factory = _fake
        want = ("binary", False)
    port, ref = _states(factory)
    try:
        r = process_both(port, ref, small_lines_frame(texts=[TEXT]))
        f = port.delegate.backend._dispatch_flags
        assert (f.inline, f.band is not None) == want
        assert r.meters_to_px_ratio == pytest.approx(RATIO)
    finally:
        port.close()
        ref.close()
