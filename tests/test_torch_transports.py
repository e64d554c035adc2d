"""The port's window-crop and binary / gray / row-band scales transports
against the JAX package: the hostpack bytes of analyze_packed_flat against
smh_tpu.ops.pipeline._analyze_packed_flat(..., channels=3) for every new
flag combination, the scalespack presence rule, the debug re-pass planes,
and the jax-free host helpers that rebuild the inline images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import pipeline as opp
from smh_tpu.vision import tpu_backend as tb
from smh_tpu_torch import consts as C, testing
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.ops import scales_device as tsd
from smh_tpu_torch.vision import cuda_backend as cb
from smh_tpu_torch.vision import pixmath
from test_torch_reference import _reference_native  # noqa: F401  (module-scoped autouse fixture)

torch.set_num_threads(1)


# 960x540: the map's bit mask (25 KB) is above the 16 KiB windowing floor
# and the quadrant's bit plane (6.4 KB) above the 4 KiB band floor.
FW, FH = 960, 540
G = C.map_geometry(FW, FH)
_TEMPLATES = tsd.templates_to_device(tsd.device_templates(), "cpu")


def _rois(marker_lines=(((60, 75), (190, 160)),), scale_texts=(("300m", (30, 80)),)):
    frame = testing.make_frame(
        FW, FH, marker_lines=list(marker_lines), scale_texts=list(scale_texts),
        scale_bars=[(30, 110, 60, 1)],
    )
    mr = frame[G.map_y : G.map_y + G.map_h, G.map_x : G.map_x + G.map_w]
    br = frame[G.btn_y : G.btn_y + G.btn_h, G.btn_x : G.btn_x + G.btn_w]
    return tb._pack_rois_bgr(mr, br, pad_to=128)


# (crop_h, crop_w, scales_inline, scales_band): window crops at the ladder's
# rungs with every scales transport, whole and banded.
CASES = [
    (205, 246, "binary", None),
    (205, 246, "binary", 102),
    (102, 493, "gray", None),
    (None, None, "gray", 51),
    (308, 123, "gray", 102),
    (25, 30, "none", None),
    (205, 246, "device", None),
    (None, None, "binary", 25),
]


@pytest.mark.parametrize("crop_h,crop_w,inline,band", CASES)
def test_hostpack_bytes_match_jax(crop_h, crop_w, inline, band):
    _assert_hostpack_matches(_rois(), crop_h, crop_w, inline, band)


def _assert_hostpack_matches(packed, crop_h, crop_w, inline, band):
    """The port's hostpack bytes (but the score lanes, +-1) and scalespack
    equal JAX's; returns the lsd_meta lanes."""
    kw = dict(
        map_h=G.map_h, map_w=G.map_w, btn_h=G.btn_h, btn_w=G.btn_w, grayscale=True,
        crop_h=crop_h, crop_w=crop_w, scales_inline=inline, scales_band=band,
    )
    want = jax.device_get(opp._analyze_packed_flat(packed, channels=3, **kw))
    got = tpp.analyze_packed_flat(torch.from_numpy(packed), templates=_TEMPLATES, **kw)
    layout = tpp.hostpack_layout(
        G.map_h, G.map_w, crop_h=crop_h, crop_w=crop_w, scales_inline=inline, scales_band=band,
    )
    assert got["hostpack"].numel() == layout["__total__"]
    off, size = layout.get("scales_rec", (0, 0))
    g_pack, w_pack = got["hostpack"].numpy(), np.asarray(want["hostpack"])
    outside = np.ones(g_pack.size, bool)
    outside[off : off + size] = False  # score lanes: +-1 (test_torch_pipeline.py)
    np.testing.assert_array_equal(g_pack[outside], w_pack[outside])
    # The scalespack exists for "none", "device" or a band (JAX's rule).
    assert ("scalespack" in got) == ("scalespack" in want) == (inline in ("none", "device") or band is not None)
    if "scalespack" in got:
        np.testing.assert_array_equal(got["scalespack"].numpy(), np.asarray(want["scalespack"]))
    # A window crop carries its origin: the bbox less the margin, clamped.
    y0, y1, x0, x1, cy0, cx0 = g_pack[layout["lsd_meta"][0] :][:24].view(np.int32)
    if crop_h is not None:
        m = int(tpp.LSD_CROP_MARGIN)
        assert (cy0, cx0) == (min(max(y0 - m, 0), G.map_h - crop_h), min(max(x0 - m, 0), G.map_w - crop_w))
    return y0, y1, x0, x1, cy0, cx0


# Windows at the edges of the window crop (kernel 10): (marker lines, crop_h,
# crop_w, scales transport, band) -- an empty mask (the origin clamped from
# y0 = H, x0 = W), an origin column that is no multiple of 8, one full
# dimension each way (crop_w == W with crop_h < H, crop_h == H with crop_w <
# W).
WINDOW_CASES = {
    "empty_mask": ((), 205, 246, "gray", 51),
    "cx0_mod8": ((((67, 75), (190, 160)),), 205, 246, "binary", None),
    "full_width": ((((60, 75), (190, 160)),), 102, G.map_w, "gray", None),
    "full_height": ((((60, 75), (190, 160)),), G.map_h, 123, "binary", 25),
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_window_edges_match_jax(name):
    lines, crop_h, crop_w, inline, band = WINDOW_CASES[name]
    y0, y1, x0, x1, cy0, cx0 = _assert_hostpack_matches(_rois(marker_lines=lines), crop_h, crop_w, inline, band)
    if name == "empty_mask":
        assert (y0, y1, x0, x1) == (G.map_h, 0, G.map_w, 0)
    if name == "cx0_mod8":
        assert cx0 % 8 != 0
    if name.startswith("full_"):
        assert (crop_h == G.map_h) != (crop_w == G.map_w)


def test_batch_window_and_binary_keep_bits_match_jax():
    """The batched pass with a window crop and the unbanded binary scales:
    each frame its own origin (one frame with no marker), every hostpack
    byte equal to smh_tpu's _analyze_batch_packed."""
    frames = [
        _rois(marker_lines=lines) for lines in ((((60, 75), (190, 160)),), (), (((140, 20), (330, 210)),))
    ]
    rows = np.stack(frames)
    kw = dict(map_h=G.map_h, map_w=G.map_w, btn_h=G.btn_h, btn_w=G.btn_w, grayscale=True, crop_h=205, crop_w=246,
              scales_inline="binary")
    want = np.asarray(jax.device_get(opp._analyze_batch_packed(jnp.asarray(rows), channels=3, **kw))["hostpack"])
    got = tpp.analyze_batch_packed_flat(torch.from_numpy(rows), **kw)["hostpack"].numpy()
    np.testing.assert_array_equal(got, want)
    off, _ = tpp.hostpack_layout(G.map_h, G.map_w, crop_h=205, crop_w=246, scales_inline="binary")["lsd_meta"]
    origins = {tuple(got[i, off : off + 24].view(np.int32)[4:]) for i in range(len(frames))}
    assert len(origins) == len(frames)


def test_band_meta_on_textless_and_bottom_text():
    """The band's (oy0, oy1, b0): empty for a textless quadrant, clamped to
    the quadrant's bottom for text near it; equal to JAX's either way."""
    for texts in ((), (("300m", (30, G.brq_h - 14)),)):
        packed = _rois(scale_texts=texts)
        kw = dict(
            map_h=G.map_h, map_w=G.map_w, btn_h=G.btn_h, btn_w=G.btn_w, grayscale=True,
            scales_inline="gray", scales_band=51, sparse_budget=256,
        )
        want = np.asarray(opp._analyze_packed_flat(packed, channels=3, **kw)["hostpack"])
        got = tpp.analyze_packed_flat(torch.from_numpy(packed), **kw)["hostpack"].numpy()
        np.testing.assert_array_equal(got, want)
        off, _ = tpp.hostpack_layout(G.map_h, G.map_w, scales_inline="gray", scales_band=51, sparse_budget=256)["scales_meta"]
        oy0, oy1, b0 = got[off : off + 12].view(np.int32)
        if texts:
            assert oy0 < oy1 and b0 == G.brq_h - 51
        else:
            assert oy0 >= oy1


def test_debug_pass_planes():
    """analyze_map_planar(with_isolated=True): the cropped quadrant and the
    mask bits equal JAX's; the isolated marker pixels equal the pixmath
    classify (the jitted XLA classify contracts the HSV math to FMA)."""
    packed = _rois()
    planes = packed[: G.map_h * G.map_w * 3].reshape(3, G.map_h, G.map_w)
    got = tpp.analyze_map_planar(torch.from_numpy(planes.copy()), grayscale=True, with_isolated=True)
    want = jax.device_get(opp.analyze_map_planar(jnp.asarray(planes), grayscale=True, with_isolated=True))
    for key in ("cropped_brq", "lsd_bits", "ui", "ocr_img", "scales_bits"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    rgb = np.stack([planes[2], planes[1], planes[0]], axis=-1)
    marker = pixmath.is_any_map_marker_color(rgb)
    np.testing.assert_array_equal(got["isolated_map"].numpy(), np.where(marker[..., None], rgb, 0))
    assert marker.any()


def test_unpack_bits_device_matches_jax():
    rng = np.random.default_rng(3)
    for w in (1, 13, 493):
        bits = rng.integers(0, 256, (7, (w + 7) // 8), dtype=np.uint8)
        np.testing.assert_array_equal(
            tpp.unpack_bits_device(torch.from_numpy(bits), w).numpy(),
            np.asarray(opp.unpack_bits_device(jnp.asarray(bits), w)),
        )


def test_inline_image_helpers_match_jax():
    """binary_ocr_image_host, _paste_band and the inline-section readers
    are jax-free copies of smh_tpu's; same images for every band state."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 256, (G.brq_h, (G.brq_w + 7) // 8), dtype=np.uint8)
    np.testing.assert_array_equal(
        tpp.binary_ocr_image_host(bits, G.brq_w), opp.binary_ocr_image_host(bits, G.brq_w)
    )
    band_rows = 51
    sbits = bits[:band_rows]
    gray = rng.integers(0, 256, (band_rows, G.brq_w), dtype=np.uint8)
    hosts = [
        {"scales_band": None, "scales_bits_inline": bits, "ocr_bits_inline": bits},
        {"scales_band": None, "scales_bits_inline": bits, "ocr_img_inline": rng.integers(0, 256, (G.brq_h, G.brq_w), dtype=np.uint8)},
        {"scales_band": (band_rows, 40, False), "scales_bits_inline": sbits, "ocr_img_inline": gray},
        {"scales_band": (band_rows, 12, False), "scales_bits_inline": sbits, "ocr_bits_inline": sbits},
        {"scales_band": (band_rows, 0, True)},
        {"scales_band": "miss"},
        {},
    ]
    for host in hosts:
        for port_fn, jax_fn in (
            (cb._ocr_image_from_host, tb._ocr_image_from_host),
            (cb._scales_image_from_host, tb._scales_image_from_host),
        ):
            got, want = port_fn(host, G), jax_fn(host, G)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cb._paste_band(gray, G.brq_h, 7, 255), tb._paste_band(gray, G.brq_h, 7, 255))


def test_ladder_constants_match_jax():
    for name in ("_RUNG_SLACK", "_SHRINK_AFTER", "_BAND_SHRINK_AFTER", "_INLINE_STABLE_AFTER",
                 "_RUNG_HALF", "_MIN_WINDOWED_MASK_BYTES"):
        assert getattr(cb, name) == getattr(tb, name), name
    for dim in (1, 7, 205, 411, 822, 1644):
        ladder = cb._dim_ladder(dim)
        assert ladder == tb._dim_ladder(dim)
        for need in (0, 1, dim // 3, dim, dim + 5):
            assert cb._rung_for(ladder, need) == tb.TpuBackend._rung_for(ladder, need)
