"""The port's VisionState + CudaBackend on the CPU (plain kernel twins) against
smh_tpu's VisionState with TpuBackend on JAX CPU: same markers, ratio,
minimap and hostpack bytes, and the same transport adaptation. Each side
runs its own package's driver, OCR engine, settings and frames; results
are compared by value."""

import dataclasses

import numpy as np
import pytest
import torch

from smh_tpu.ocr.smhocr import SmhOcrEngine as JSmhOcrEngine
from smh_tpu.settings import Settings as JSettings
from smh_tpu.squadex.capture import Frame as JFrame
from smh_tpu.vision import pipeline as jpipeline
from smh_tpu.vision import tpu_backend as tb
from smh_tpu_torch import consts as C, testing
from smh_tpu_torch.ocr.smhocr import SmhOcrEngine
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.settings import Settings
from smh_tpu_torch.squadex.capture import Frame
from smh_tpu_torch.vision import cuda_backend as cb
from smh_tpu_torch.vision import pipeline as tpipeline
from test_torch_reference import _reference_native  # noqa: F401  (module-scoped autouse fixture)

torch.set_num_threads(1)

# CudaBackend's counters that smh_tpu's TpuBackend has no counterpart of:
# every D2H copy's bytes, and the cuda line-search engine's marches.
PORT_COUNTERS = {"d2h_bytes", "lsd_marches", "lsd_seeds_marched"}


W, H = 1280, 720


def _frame(**kw):
    kw.setdefault("marker_lines", [((120, 150), (500, 420)), ((300, 60), (560, 90))])
    kw.setdefault("scale_texts", [("300m", (60, 170))])
    kw.setdefault("scale_bars", [(60, 200, 120, 1)])
    return testing.make_frame(W, H, **kw)


def _settings(hw=True, cls=Settings):
    s = cls(path=None)
    s.set("hardware_acceleration", hw, save=False)
    return s


def _rect(r):
    return None if r is None else dataclasses.astuple(r)


@pytest.fixture
def states(monkeypatch):
    # Full uploads on both sides (the JAX delta path would compile a new
    # bucket per changed-chunk count; tests/test_torch_delta.py holds the
    # port's delta chain).
    monkeypatch.setenv("SMH_DELTA", "0")
    port = tpipeline.VisionState(settings=_settings(), ocr_engine=SmhOcrEngine(), device="cpu")
    ref = jpipeline.VisionState(settings=_settings(cls=JSettings), ocr_engine=JSmhOcrEngine())
    yield port, ref
    port.close()
    ref.close()


def _lines(res):
    return [(l.p0.x, l.p0.y, l.p1.x, l.p1.y) for l in res.markers]


def _assert_same(port, ref, frame):
    rp = port.process(Frame(frame, 96))
    rr = ref.process(JFrame(frame, 96))
    bp, br = port.delegate.backend, ref.delegate.backend
    assert bp.name == "cuda" and br.name == "tpu"
    if rr is None:
        assert rp is None
        return None
    assert _lines(rp) == _lines(rr)
    assert rp.meters_to_px_ratio == rr.meters_to_px_ratio
    assert _rect(rp.minimap_bounds) == _rect(rr.minimap_bounds)
    np.testing.assert_array_equal(bp._results["hostpack"].numpy(), np.asarray(br._results["hostpack"]))
    return rp


def test_port_matches_tpu_backend_and_oracle(states):
    port, ref = states
    frame = _frame()
    res = _assert_same(port, ref, frame)
    assert len(res.markers) == 2 and res.meters_to_px_ratio == pytest.approx(300 / 118)
    be = port.delegate.backend
    assert be._dispatch_flags[3] == "device" and be._dispatch_flags[4] is not None  # sparse
    assert be.stats["device_scales_frames"] == 1 and be.stats["device_scales_fallbacks"] == 0
    assert be.stats["scalespack_fetches"] == 0
    assert set(be.stats) - PORT_COUNTERS == set(ref.delegate.backend.stats)
    np.testing.assert_array_equal(res.map, ref.process(JFrame(frame, 96)).map)

    oracle = tpipeline.VisionState(settings=_settings(hw=False), ocr_engine=SmhOcrEngine(), device="cpu")
    try:
        ro = oracle.process(Frame(frame, 96))
        assert oracle.delegate.backend.name == "numpy"
    finally:
        oracle.close()
    assert ro.meters_to_px_ratio == res.meters_to_px_ratio
    assert ro.minimap_bounds == res.minimap_bounds
    # tests/test_tpu_parity.py:139-140: ray ends agree within 1.5 px.
    for a, b in zip(sorted(_lines(res)), sorted(_lines(ro)), strict=True):
        assert all(abs(x - y) <= 1.5 for x, y in zip(a, b)), (a, b)


def test_port_matches_over_a_frame_sequence(states):
    """Changing markers and scales, a closed map, and an empty mask."""
    port, ref = states
    frames = [
        _frame(),
        _frame(marker_lines=[((200, 100), (520, 400))], scale_texts=[("900m", (60, 170))]),
        _frame(with_button=False),
        _frame(marker_lines=[], scale_texts=[], scale_bars=[]),
        _frame(),
    ]
    for frame in frames:
        _assert_same(port, ref, frame)
    assert port.delegate.backend.stats["frames"] == ref.delegate.backend.stats["frames"] == 4


def test_port_falls_back_to_the_host_engine_on_overflow(states):
    """Junk that overflows every record slot: the device read is untrusted,
    the ratio comes from the host engine over the fetched scalespack."""
    port, ref = states
    frame = _frame()
    g = C.map_geometry(W, H)
    view = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
    for b in range(8):
        for k in range(20):
            view[4 + 14 * b : 12 + 14 * b, 8 + 6 * k, :3] = 245
    res = _assert_same(port, ref, frame)
    assert res.meters_to_px_ratio == pytest.approx(300 / 118)
    be = port.delegate.backend
    assert be.stats["device_scales_fallbacks"] == 1 and be.stats["scalespack_fetches"] == 1


def test_engine_without_device_read_uses_the_scalespack(monkeypatch):
    """With the device read off, smhocr (binary_ok, image-derived) takes the
    binary band inline, as on the JAX backend; once the scales checksum is
    stable the pack drops to checksum-only, and a changed scale then reads
    the lazily fetched scalespack. Markers, ratio, minimap, flags and
    fetch counts agree at every frame."""
    monkeypatch.setenv("SMH_DEVICE_SCALES", "0")
    monkeypatch.setenv("SMH_DELTA", "0")
    port = tpipeline.VisionState(settings=_settings(), ocr_engine=SmhOcrEngine(), device="cpu")
    ref = jpipeline.VisionState(settings=_settings(cls=JSettings), ocr_engine=JSmhOcrEngine())
    try:
        frames = [_frame()] * (cb._INLINE_STABLE_AFTER + 1) + [
            _frame(scale_texts=[("900m", (60, 170))])
        ]
        inlines, bands = [], []
        for frame in frames:
            rp, rr = port.process(Frame(frame, 96)), ref.process(JFrame(frame, 96))
            assert _lines(rp) == _lines(rr)
            assert rp.meters_to_px_ratio == rr.meters_to_px_ratio
            assert _rect(rp.minimap_bounds) == _rect(rr.minimap_bounds)
            bp, br = port.delegate.backend, ref.delegate.backend
            assert bp._dispatch_flags[3] == br._dispatch_flags[6]
            assert bp._dispatch_flags.band == br._dispatch_flags[7]
            assert {k: v for k, v in bp.stats.items() if k not in PORT_COUNTERS} == br.stats
            inlines.append(bp._dispatch_flags[3])
            bands.append(bp._dispatch_flags.band)
        assert inlines == ["binary"] * (cb._INLINE_STABLE_AFTER + 1) + ["none"]
        assert None not in bands[:-1] and bp.stats["scalespack_fetches"] == 1
    finally:
        port.close()
        ref.close()


def test_sparse_rung_ladder_matches_tpu_backend():
    """The copied _sparse_budget/_adapt_sp_rung step through the same rungs,
    misses, probation and shrinks as TpuBackend's on one nz sequence."""
    port = cb.CudaBackend(device="cpu")
    ref = tb.TpuBackend()
    frame = _frame()
    port.load_frame(frame)
    ref.load_frame(frame)
    seq = [10, 900, 1200, 5000, 70000, 70000, 70000] + [0] * 40 + [300] * 70 + [9000, 20]
    for nz in seq:
        bp, br = port._sparse_budget(), ref._sparse_budget()
        assert bp == br
        if bp is not None:
            port._adapt_sp_rung(nz, bp)
            ref._adapt_sp_rung(nz, br)
        a = port._adapt
        assert (a.sp_rung, a.sp_streak, a.sp_miss_streak, a.sp_probation) == (
            ref._sp_rung, ref._sp_streak, ref._sp_miss_streak, ref._sp_probation,
        ), nz


def test_pack_rois_fallback_matches_native_pack():
    """A frame whose pixels are not BGRA-contiguous takes the numpy packer;
    the bytes equal the native pack and smh_tpu's _pack_rois_bgr."""
    be = cb.CudaBackend(device="cpu")
    frame = _frame()
    be.load_frame(frame)
    native_pack = be._pending_host
    assert be._pending[0] == "full" and be._pending[1] is native_pack
    strided = np.zeros((H, W, 8), np.uint8)[..., ::2]
    strided[...] = frame
    be.load_frame(strided)
    np.testing.assert_array_equal(be._pending_host, native_pack)
    g = be.geom
    mr = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
    br = frame[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
    np.testing.assert_array_equal(native_pack, tb._pack_rois_bgr(mr, br, pad_to=128))


def test_hostpack_layout_used_by_the_backend():
    be = cb.CudaBackend(device="cpu")
    be.scales_device_ok = True
    be.load_frame(_frame())
    assert be.crop_to_map(True) is not None
    f = be._dispatch_flags
    layout = tpp.hostpack_layout(
        be.geom.map_h, be.geom.map_w, crop_h=f.crop_h, crop_w=f.crop_w,
        scales_inline=f.inline, scales_band=f.band, sparse_budget=f.sparse,
    )
    assert be._results["hostpack"].numel() == layout["__total__"]
    assert be.minimap_rect() is not None and be.scales_check() is not None


def test_backends_satisfy_the_vision_backend_protocol():
    """The port's copy of smh_tpu's runtime-checkable VisionBackend: the CUDA
    backend (on the CPU here) and the numpy oracle implement it, as
    smh_tpu's TpuBackend and oracle implement the original."""
    from smh_tpu.vision.backend import VisionBackend as JVisionBackend
    from smh_tpu.vision.reference import ReferenceBackend as JReferenceBackend
    from smh_tpu_torch.vision.backend import VisionBackend
    from smh_tpu_torch.vision.reference import ReferenceBackend

    for be in (cb.CudaBackend(device="cpu"), ReferenceBackend()):
        assert isinstance(be, VisionBackend), type(be).__name__
    for be in (tb.TpuBackend(), JReferenceBackend()):
        assert isinstance(be, JVisionBackend), type(be).__name__
    assert not isinstance(object(), VisionBackend)
