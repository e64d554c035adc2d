"""The port's fused pass (smh_tpu_torch/ops/pipeline.py) against the JAX
package: the building blocks, the jax-free host-helper copies, and the
hostpack + scalespack bytes of analyze_packed_flat vs
smh_tpu.ops.pipeline._analyze_packed_flat(..., channels=3)."""

import itertools

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

torch.set_num_threads(1)

RNG_SHAPES = [(1, 1), (7, 9), (33, 65), (101, 37)]

# JAX references, jitted so each shape compiles once (eager JAX compiles
# every op).
_j_dilate = jax.jit(opp._dilate_l1_radius1_bool)
_j_box = jax.jit(opp._box_dilate_bool, static_argnums=1)
_j_pack = jax.jit(opp.pack_bits)
_j_words = jax.jit(opp._pack_words32)
_j_compact = jax.jit(lambda w, b: opp._compact_words(w, b, engine="search"), static_argnums=1)
_j_bbox = jax.jit(opp._mask_bbox)
_j_sparse = jax.jit(opp._sparse_words, static_argnums=1)
_j_ocr = jax.jit(opp._ocr_preprocess_planes)


def _masks(shape, seed, density=0.05):
    rng = np.random.default_rng(seed)
    return rng.random(shape) < density


@pytest.mark.parametrize("shape", RNG_SHAPES)
def test_dilate_and_box_dilate_match_jax(shape):
    m = _masks(shape, 1)
    np.testing.assert_array_equal(
        tpp._dilate_l1_radius1_bool(torch.from_numpy(m)).numpy(),
        np.asarray(_j_dilate(m)),
    )
    for r in (1, 3):
        np.testing.assert_array_equal(
            tpp._box_dilate_bool(torch.from_numpy(m), r).numpy(),
            np.asarray(_j_box(m, r)),
        )


@pytest.mark.parametrize("shape", RNG_SHAPES)
def test_pack_bits_and_words_match_jax(shape):
    m = _masks(shape, 2, density=0.3)
    np.testing.assert_array_equal(
        tpp.pack_bits(torch.from_numpy(m)).numpy(), np.asarray(_j_pack(m))
    )
    words = tpp._pack_words32(torch.from_numpy(m)).numpy()
    assert words.max(initial=0) < 2**32
    np.testing.assert_array_equal(words.astype(np.uint32), np.asarray(_j_words(m)))


@pytest.mark.parametrize("budget,density", [(16, 0.0), (16, 0.002), (64, 0.02), (8, 0.2)])
def test_compact_words_matches_jax(budget, density):
    """Empty, under-budget and over-budget planes (nz > budget keeps the
    first `budget` words and reports the true count)."""
    m = _masks((57, 301), 3, density)
    words_t = tpp._pack_words32(torch.from_numpy(m))
    nz, idx, dat = tpp._compact_words(words_t, budget)
    jnz, jidx, jdat = _j_compact(_j_words(m), budget)
    assert int(nz) == int(jnz)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(dat.numpy().astype(np.uint32), np.asarray(jdat))


@pytest.mark.parametrize("shape", RNG_SHAPES)
def test_mask_bbox_matches_jax(shape):
    for m in (_masks(shape, 4, 0.01), np.zeros(shape, bool)):
        got = [int(v) for v in tpp._mask_bbox(torch.from_numpy(m))]
        want = [int(v) for v in _j_bbox(m)]
        assert got == want


def test_weighted_check_wraps_like_uint32():
    rng = np.random.default_rng(5)
    for plane in (
        rng.integers(0, 256, (411, 493), dtype=np.uint8),
        rng.integers(0, 766, (822, 986)).astype(np.uint32),  # colour-mode r+g+b
    ):
        got = tpp._weighted_check(torch.from_numpy(plane.astype(np.int64))).numpy()
        want = np.asarray(opp._weighted_check(jnp.asarray(plane)))
        np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_ocr_preprocess_and_red_gate_match_jax():
    rng = np.random.default_rng(6)
    rgb = rng.integers(150, 256, (61, 83, 3), dtype=np.uint8)
    rgb[::3] = rng.integers(0, 256, (21, 83, 3), dtype=np.uint8)
    planes_t = [torch.from_numpy(np.ascontiguousarray(rgb[..., c])) for c in range(3)]
    planes_j = [jnp.asarray(rgb[..., c]) for c in range(3)]
    np.testing.assert_array_equal(
        tpp._ocr_preprocess_planes(*planes_t).numpy(),
        np.asarray(_j_ocr(*planes_j)),
    )
    btn = rng.integers(0, 256, (41, 255, 3), dtype=np.uint8)
    for k in (0, 1, 997, 6810, 41 * 255):  # button-red pixel counts
        btn.reshape(-1, 3)[:k] = (49, 67, 217)  # BGR of the button red
        got = tpp._red_gate_roi(torch.from_numpy(btn))
        want = opp._red_gate_roi(jnp.asarray(btn))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), k


# -- jax-free host helper copies ----------------------------------------------


def test_host_constants_match():
    assert tpp.LSD_CROP_MARGIN == opp.LSD_CROP_MARGIN
    for w in (1, 8, 31, 328, 493, 986):
        assert tpp.scales_scan_budget(w) == opp.scales_scan_budget(w)
        assert tpp.sparse_word_pad(w) == opp.sparse_word_pad(w)


@pytest.mark.parametrize("map_h,map_w", [(9, 13), (275, 329), (548, 657), (822, 986), (1644, 1972)])
def test_layouts_match(map_h, map_w):
    assert tpp.scalespack_layout(map_h, map_w) == opp.scalespack_layout(map_h, map_w)
    for with_ocr, with_quiet, inline, band, sparse, crop in itertools.product(
        (True, False), (True, False), ("none", "binary", "gray", "device"),
        (None, 17), (None, 256, 1024), ((None, None), (5, 7)),
    ):
        kw = dict(
            with_ocr=with_ocr, with_quiet=with_quiet, scales_inline=inline,
            scales_band=band, sparse_budget=sparse, crop_h=crop[0], crop_w=crop[1],
        )
        assert tpp.hostpack_layout(map_h, map_w, **kw) == opp.hostpack_layout(map_h, map_w, **kw)


@pytest.mark.parametrize("map_h,map_w,budget", [(13, 31, 8), (275, 329, 256), (548, 657, 64)])
def test_sparse_mask_and_crop_host_match(map_h, map_w, budget):
    m = _masks((map_h, map_w), 7, 0.003)
    nz, idx, dat = _j_sparse(m, budget)
    idx, dat = np.asarray(idx), np.asarray(dat)
    got = tpp.sparse_mask_host(int(nz), idx, dat, map_h, map_w)
    want = opp.sparse_mask_host(int(nz), idx, dat, map_h, map_w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpp.unpack_bits_host(got, map_w), opp.unpack_bits_host(want, map_w))
    bbox = tuple(int(v) for v in _j_bbox(m))
    if bbox[0] < bbox[1]:
        for origin, shape in (((0, 0), (map_h, map_w)), ((3, 2), (map_h - 2, map_w - 3))):
            bits = want[origin[1] :, :]
            c_got, o_got = tpp.bbox_crop_host(bits, bbox, origin, shape)
            c_want, o_want = opp.bbox_crop_host(bits, bbox, origin, shape)
            assert o_got == o_want
            np.testing.assert_array_equal(c_got, c_want)


# -- the fused pass: hostpack + scalespack bytes -------------------------------


def _frame_rois(frame_w, frame_h):
    frame = testing.make_frame(
        frame_w, frame_h,
        marker_lines=[((20, 30), (150, 90)), ((40, 200), (260, 140))],
        scale_texts=[("300m", (10, 20))],
        scale_bars=[(10, 50, 60, 1)],
    )
    g = C.map_geometry(frame_w, frame_h)
    mr = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
    br = frame[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
    return tb._pack_rois_bgr(mr, br, pad_to=128), g


def assert_hostpacks_match(got: np.ndarray, want: np.ndarray, layout: dict) -> None:
    """Byte-equal, except the scales_rec score lanes, which may differ by 1
    (the f32 template dot sums in another order)."""
    assert got.shape == want.shape
    off, size = layout.get("scales_rec", (0, 0))
    outside = np.ones(got.size, bool)
    outside[off : off + size] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    if size:
        ra = got[off : off + size].view(np.int16).astype(np.int32)
        rb = want[off : off + size].view(np.int16).astype(np.int32)
        score = tsd.score_lanes()
        np.testing.assert_array_equal(ra[~score], rb[~score])
        assert np.abs(ra[score] - rb[score]).max(initial=0) <= 1


_TEMPLATES = tsd.templates_to_device(tsd.device_templates(), "cpu")


@pytest.mark.parametrize(
    "inline,sparse,gray",
    list(itertools.product(("device", "none"), (None, 256), (True, False))),
)
def test_analyze_packed_flat_bytes_match_jax(inline, sparse, gray):
    packed, g = _frame_rois(641, 361)  # odd map 275 x 329
    kw = dict(
        map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w, grayscale=gray,
        scales_inline=inline, sparse_budget=sparse,
    )
    want = jax.device_get(opp._analyze_packed_flat(packed, channels=3, **kw))
    got = tpp.analyze_packed_flat(torch.from_numpy(packed), templates=_TEMPLATES, **kw)
    layout = tpp.hostpack_layout(g.map_h, g.map_w, scales_inline=inline, sparse_budget=sparse)
    assert got["hostpack"].numel() == layout["__total__"]
    assert_hostpacks_match(got["hostpack"].numpy(), np.asarray(want["hostpack"]), layout)
    np.testing.assert_array_equal(got["scalespack"].numpy(), np.asarray(want["scalespack"]))
    np.testing.assert_array_equal(got["lsd_bits"].numpy(), np.asarray(want["lsd_bits"]))
    np.testing.assert_array_equal(got["ui"].numpy(), np.asarray(want["ui"]))


@pytest.mark.parametrize("with_ocr,with_quiet", [(False, True), (True, False)])
def test_analyze_packed_flat_optional_sections_match_jax(with_ocr, with_quiet):
    packed, g = _frame_rois(963, 541)  # odd map 412 x 494
    kw = dict(
        map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w, grayscale=True,
        with_ocr=with_ocr, with_quiet=with_quiet, scales_inline="device", sparse_budget=512,
    )
    want = opp._analyze_packed_flat(packed, channels=3, **kw)
    got = tpp.analyze_packed_flat(torch.from_numpy(packed), templates=_TEMPLATES, **kw)
    layout = tpp.hostpack_layout(
        g.map_h, g.map_w, with_ocr=with_ocr, with_quiet=with_quiet,
        scales_inline="device", sparse_budget=512,
    )
    assert_hostpacks_match(got["hostpack"].numpy(), np.asarray(want["hostpack"]), layout)
    assert ("scalespack" in got) == with_ocr


def test_plane_view_is_not_a_copy():
    packed, g = _frame_rois(641, 361)
    rois = torch.from_numpy(packed)
    planes = rois[: g.map_h * g.map_w * 3].view(3, g.map_h, g.map_w)
    assert planes.data_ptr() == rois.data_ptr() and planes[2].is_contiguous()


def test_device_inline_needs_templates():
    packed, g = _frame_rois(641, 361)
    with pytest.raises(ValueError):
        tpp.analyze_packed_flat(
            torch.from_numpy(packed), map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h,
            btn_w=g.btn_w, grayscale=True, scales_inline="device",
        )
