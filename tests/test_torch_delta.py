"""The port's delta upload on the CPU: the device-resident buffer plus the
changed 32 B chunks must rebuild every frame exactly, so the delta chain's
hostpack bytes equal full uploads' frame by frame. The chain's state
machine (dropped frames, the in-place roll reseed, the big-change
fallback, a resize) follows tests/test_delta_upload.py; the host half is
pinned to smh_tpu's TpuBackend.load_frame, and analyze_delta_flat to JAX's
_analyze_delta_flat. All comparisons are exact."""

import jax
import numpy as np
import pytest
import torch

from smh_tpu import consts as C
from smh_tpu import native
from smh_tpu.ops import pipeline as opp
from smh_tpu.vision import tpu_backend as tb
from smh_tpu_torch import testing
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.vision import cuda_backend as cb

torch.set_num_threads(1)

W, H = 1280, 720

pytestmark = pytest.mark.skipif(not native.available(), reason="the native host module did not build")


def frame_with(off=0, brq_patch=False):
    f = testing.make_frame(
        W, H,
        marker_lines=[((120 + off, 150), (380 + off, 320))],
        scale_texts=[("300m", (60, 170))],
        scale_bars=[(60, 200, 120, 1)],
    )
    if brq_patch:
        g = C.map_geometry(W, H)
        f[g.brq_y + 200 : g.brq_y + 212, g.brq_x + 180 : g.brq_x + 230, :3] = 255
    return f


def make_backend(delta: str) -> cb.CudaBackend:
    be = cb.CudaBackend(device="cpu")
    be.delta_mode = delta
    be.scales_device_ok = True
    return be


def detect(be, frame) -> list:
    be.load_frame(frame)
    assert be.crop_to_map(True) is not None
    be.mask_marker_lines()
    return be.find_marker_lines(C.LSD_MAX_GAP)


def hostpack(be) -> np.ndarray:
    return be._fetch[0].numpy()


def lines_tuples(lines):
    return [((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in lines]


def test_delta_chain_matches_full_uploads():
    frames = [frame_with(0), frame_with(7), frame_with(14, brq_patch=True), frame_with(7)]
    be_d = make_backend("on")
    be_f = make_backend("off")
    for i, f in enumerate(frames):
        ld = detect(be_d, f)
        lf = detect(be_f, f)
        np.testing.assert_array_equal(hostpack(be_d), hostpack(be_f), err_msg=f"frame {i}")
        assert lines_tuples(ld) == lines_tuples(lf) and len(ld) == 1, f"frame {i}"
        np.testing.assert_array_equal(be_d.ocr_preprocess(), be_f.ocr_preprocess())
        assert be_d._host["minimap_rect"] == be_f._host["minimap_rect"]
        np.testing.assert_array_equal(be_d._resident.numpy(), be_f._resident.numpy())
    assert be_d.stats["full_uploads"] == 1
    assert be_d.stats["delta_frames"] == len(frames) - 1
    assert be_f.stats["delta_frames"] == 0
    full_bytes = be_f.stats["h2d_bytes"] / len(frames)
    delta_bytes = (be_d.stats["h2d_bytes"] - full_bytes) / (len(frames) - 1)
    assert delta_bytes < full_bytes / 2


def test_identical_frame_still_dispatches_via_minimal_delta():
    f = frame_with(0)
    be = make_backend("on")
    l1 = detect(be, f)
    l2 = detect(be, f.copy())
    assert lines_tuples(l1) == lines_tuples(l2)
    assert be.stats["delta_frames"] == 1
    # One no-op chunk on the smallest bucket: 16 indices + 16 chunks.
    assert be.stats["h2d_bytes"] == be._mirror.size + 16 * (4 + cb._DELTA_SUB)


def test_dropped_frame_does_not_poison_the_diff_base():
    """load_frame without a dispatch must not become the diff base."""
    be = make_backend("on")
    detect(be, frame_with(0))
    be.load_frame(frame_with(3))  # loaded, never dispatched
    lines = detect(be, frame_with(9, brq_patch=True))
    ref = make_backend("off")
    assert lines_tuples(lines) == lines_tuples(detect(ref, frame_with(9, brq_patch=True)))
    np.testing.assert_array_equal(hostpack(be), hostpack(ref))


def test_inplace_roll_reseed_after_dropped_frame():
    """An undispatched in-place rolling load desyncs the mirror from the
    device; the next load detects the poisoned base and reseeds with a full
    upload (tpu_backend.py:568-573)."""
    be = make_backend("on")
    detect(be, frame_with(0))  # full upload seeds the chain
    detect(be, frame_with(3))  # delta: the mirror becomes a private buffer
    assert be._mirror_recyclable
    be.load_frame(frame_with(6))  # in-place roll, never dispatched
    assert be._pending[0] == "delta" and be._pending_host is be._mirror
    lines = detect(be, frame_with(9, brq_patch=True))
    assert be.stats["full_uploads"] == 2
    ref = make_backend("off")
    assert lines_tuples(lines) == lines_tuples(detect(ref, frame_with(9, brq_patch=True)))
    np.testing.assert_array_equal(hostpack(be), hostpack(ref))


def test_big_change_falls_back_to_full_upload():
    be = make_backend("on")
    detect(be, frame_with(0))
    f2 = frame_with(0)
    g = C.map_geometry(W, H)
    noise = np.random.default_rng(7).integers(0, 255, (g.map_h, g.map_w, 4), dtype=np.uint8)
    f2[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w] = noise
    be.load_frame(f2)
    assert be._pending[0] == "full"
    assert be.stats["full_uploads"] == 1  # counted at dispatch time
    assert be.crop_to_map(True) is not None
    assert be.stats["full_uploads"] == 2


def test_resize_resets_the_chain():
    be = make_backend("on")
    detect(be, frame_with(0))
    small = testing.make_frame(1280, 1024, marker_lines=[((100, 100), (300, 260))])
    be.load_frame(small)
    assert be._pending[0] == "full" and be._resident is None
    assert be.crop_to_map(True) is not None
    be.mask_marker_lines()
    assert len(be.find_marker_lines(C.LSD_MAX_GAP)) == 1


def test_redispatch_after_delta_reuses_resident():
    """crop_to_map with a flipped grayscale flag re-dispatches with no
    pending upload: the frame's own buffer serves it."""
    be = make_backend("on")
    detect(be, frame_with(0))
    be.load_frame(frame_with(5))
    assert be.crop_to_map(True) is not None
    assert be.crop_to_map(False) is not None
    be.mask_marker_lines()
    lines = be.find_marker_lines(C.LSD_MAX_GAP)
    assert lines_tuples(lines) == lines_tuples(detect(make_backend("off"), frame_with(5)))
    assert be.stats["delta_frames"] == 1 and be.stats["full_uploads"] == 1


# -- the host half, pinned to smh_tpu's TpuBackend --------------------------------


def test_delta_constants_and_buckets_match_tpu_backend():
    for name in ("_DELTA_CHUNK", "_DELTA_SUB", "_DELTA_MIN_BYTES", "_DELTA_MAX_FRACTION", "_DELTA_BUCKETS"):
        assert getattr(cb, name) == getattr(tb, name), name
    for n_chunks in (64, 1000, 76969, 307873):
        for n in (0, 1, 15, 16, 17, 700, 768, 769, 5000, 38484, 38485, 10**6):
            assert cb._delta_bucket(n, n_chunks) == tb._delta_bucket(n, n_chunks), (n, n_chunks)


def _jax_dispatch(be: tb.TpuBackend) -> None:
    """TpuBackend.dispatch's chain bookkeeping without the device pass."""
    kind = be._pending[0]
    be._pending = None
    be._resident = object()
    be._retire_mirror(recyclable_next=kind == "delta")


def test_load_frame_chain_matches_tpu_backend():
    """The same load / dispatch sequence through both backends' host halves:
    the same upload kind, bucket and bytes, the same mirror and pack pool.
    Covers the fused pack (in place and not), a strided frame (two-pass
    pack + diff), a dropped frame, the in-place reseed and a big change."""
    port = make_backend("on")
    ref = tb.TpuBackend()
    ref.delta_mode = "on"
    strided = np.zeros((H, W, 8), np.uint8)[..., ::2]
    strided[...] = frame_with(21)
    noisy = frame_with(0)
    noisy[100:600, 300:1200] = np.random.default_rng(3).integers(0, 255, (500, 900, 4), dtype=np.uint8)
    steps = [  # (frame, dispatched?)
        (frame_with(0), True), (frame_with(7), True), (frame_with(14), True),
        (frame_with(14), True), (strided, True), (frame_with(3), False),
        (frame_with(9, brq_patch=True), True), (frame_with(2), True),
        (frame_with(5), False), (frame_with(12), True), (noisy, True), (frame_with(1), True),
    ]
    kinds = []
    for i, (frame, dispatched) in enumerate(steps):
        port.load_frame(frame)
        ref.load_frame(frame)
        pp, rp = port._pending, ref._pending
        kinds.append(pp[0])
        assert pp[0] == rp[0], i
        if pp[0] == "delta":
            assert pp[2] == rp[2] and pp[3] == rp[3], i
            np.testing.assert_array_equal(pp[1].numpy(), rp[1], err_msg=str(i))
        else:
            np.testing.assert_array_equal(pp[1], rp[1], err_msg=str(i))
        np.testing.assert_array_equal(port._pending_host, ref._pending_host, err_msg=str(i))
        assert (port._pending_host is port._mirror) == (ref._pending_host is ref._mirror), i
        if dispatched:
            port.dispatch(grayscale=True)
            _jax_dispatch(ref)
            assert port._mirror_recyclable == ref._mirror_recyclable, i
            assert len(port._pack_pool) == len(ref._pack_pool), i
    # The seed, two in-place reseeds, the big change and the change back.
    assert [i for i, k in enumerate(kinds) if k == "full"] == [0, 6, 9, 10, 11]
    assert port.stats["full_uploads"] == 5 and port.stats["delta_frames"] == 5


# -- analyze_delta_flat against JAX -----------------------------------------------


def test_analyze_delta_flat_matches_jax_with_padded_indices():
    """One bucket, with the index table padded by repeating the last index:
    the rebuilt buffer, hostpack, scalespack and bit plane equal JAX's."""
    fw, fh = 641, 361  # map 275 x 329

    def packed(off):
        f = testing.make_frame(
            fw, fh, marker_lines=[((20 + off, 30), (150 + off, 90))], scale_bars=[(10, 50, 60, 1)]
        )
        g = C.map_geometry(fw, fh)
        mr = f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
        br = f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
        return cb._pack_rois_bgr(mr, br, cb._DELTA_CHUNK), g

    base, g = packed(0)
    new, _ = packed(5)
    scratch = np.empty(base.size // cb._DELTA_SUB, np.int32)
    n = native.diff_subchunks(new, base, scratch)
    bucket = next(b for b in cb._DELTA_BUCKETS if b > n)  # at least one padded slot
    buf = np.empty(4 * bucket + bucket * cb._DELTA_SUB, np.uint8)
    native.gather_subchunks(new, scratch, n, bucket, buf)
    idx = buf[: 4 * bucket].view(np.int32)
    assert 0 < n < bucket and (idx[n:] == idx[n - 1]).all()

    kw = dict(
        map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w, grayscale=True,
        scales_inline="none", sparse_budget=256,
    )
    want = jax.device_get(
        opp._analyze_delta_flat(base, buf, bucket=bucket, chunk=cb._DELTA_SUB, channels=3, **kw)
    )
    got = tpp.analyze_delta_flat(
        torch.from_numpy(base.copy()), torch.from_numpy(buf), bucket=bucket, chunk=cb._DELTA_SUB, **kw
    )
    np.testing.assert_array_equal(got["resident"].numpy(), new)
    np.testing.assert_array_equal(np.asarray(want["resident"]), new)
    for key in ("hostpack", "scalespack", "lsd_bits"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    with pytest.raises(ValueError):
        tpp.analyze_delta_flat(
            torch.from_numpy(base), torch.from_numpy(buf[:-1]), bucket=bucket, chunk=cb._DELTA_SUB, **kw
        )
