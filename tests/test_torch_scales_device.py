"""The port's on-device scales read (smh_tpu_torch/ops/scales_device.py)
against the JAX package: the i16 records, the template matrix, and the
jax-free host decode copies."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu import consts as C, testing
from smh_tpu.ops import scales_device as jsd
from smh_tpu.vision import pixmath
from smh_tpu_torch import testing as ttesting
from smh_tpu_torch.ops import scales_device as tsd

torch.set_num_threads(1)

_jrec = jax.jit(jsd.scales_records)
_TPL = tsd.device_templates()


def _brq_images(frame):
    """(OCR image, scales binarize) of a frame's BRQ, from the numpy oracle."""
    g = C.map_geometry(frame.shape[1], frame.shape[0])
    brq = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w][..., [2, 1, 0]]
    return pixmath.ocr_preprocess(brq), pixmath.find_scales_binarize(brq)


def _records(ocr_img, sbin):
    text = ocr_img < tsd.OCR_BINARY_THRESHOLD
    sbool = sbin != 0
    got = tsd.scales_records(
        torch.from_numpy(text), torch.from_numpy(sbool), tsd.templates_to_device(_TPL, "cpu")
    ).numpy()
    want = np.asarray(_jrec(jnp.asarray(text), jnp.asarray(sbool), jnp.asarray(_TPL)))
    return got, want


def _assert_records_match(got, want):
    """Every lane exact except the scores, which may differ by 1 (the f32
    template dot sums in another order)."""
    assert got.dtype == np.int16 and got.shape == (tsd.REC_I16,)
    score = tsd.score_lanes()
    assert score.sum() == tsd.N_WORDS * tsd.MAX_WG
    np.testing.assert_array_equal(got[~score], want[~score])
    assert np.abs(got[score].astype(int) - want[score].astype(int)).max() <= 1


def _text_frame(w, h, texts, bars):
    return testing.make_frame(w, h, scale_texts=texts, scale_bars=bars)


def _overflow_bands():
    img = np.full((400, 300), 255, np.uint8)
    for b in range(tsd.MAX_BANDS + 2):  # more text-row bands than slots
        img[b * 40 : b * 40 + 10, 50:220] = 0
    return img, np.full((400, 300), 255, np.uint8)


def _junk_band():
    frame = _text_frame(1280, 720, [("300m", (60, 170))], [(60, 200, 120, 1)])
    g = C.map_geometry(1280, 720)
    view = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
    for k in range(tsd.MAX_GPB + 4):  # more glyph runs than slots in one band
        view[40:52, 10 + 6 * k, :3] = 245
    return _brq_images(frame)


def _patches():
    frame = _text_frame(1281, 721, [("1200m", (30, 50))], [(30, 80, 100, 1)])
    for k in range(6):
        testing.make_ocr_text_patch(frame, 10 + 40 * k, 150, w=30, h=12)
    testing.make_ocr_text_patch(frame, 200, 200, w=60, h=50)  # taller than a glyph
    return _brq_images(frame)


CASES = {
    "two_scales_1080p": lambda: _brq_images(_text_frame(
        1920, 1080, [("300m", (60, 170)), ("900m", (260, 170))],
        [(60, 200, 118, 1), (260, 200, 118, 1)])),
    "odd_size": lambda: _brq_images(_text_frame(963, 541, [("150m", (20, 30))], [(20, 60, 80, 1)])),
    "text_patches": _patches,
    "band_overflow": _overflow_bands,
    "junk_band": _junk_band,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_match_jax(case):
    got, want = _records(*CASES[case]())
    _assert_records_match(got, want)
    dec = tsd.decode_records(got)
    assert dec.complete == jsd.decode_records(want).complete
    if case == "band_overflow":
        assert dec.flags & tsd.FLAG_BAND_OVERFLOW and not dec.complete
    if case == "junk_band":
        assert not dec.complete and tsd.ratio_from_records(dec) == pytest.approx(300 / 118)
    if case == "two_scales_1080p":
        assert [w.text for w in dec.words] == ["300m", "900m"]


def test_records_of_an_empty_plane_match_jax():
    got, want = _records(np.full((60, 80), 255, np.uint8), np.zeros((60, 80), np.uint8))
    np.testing.assert_array_equal(got, want)


def test_device_templates_copy_equals_original():
    np.testing.assert_array_equal(tsd.device_templates(), jsd.device_templates())
    assert tsd.device_templates().shape == (2 * len(tsd.CHARS), tsd.GLYPH_H * tsd.GLYPH_W)
    t = tsd.templates_to_device(jsd.device_templates(), "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), jsd.device_templates())
    with pytest.raises(ValueError):
        tsd.templates_to_device(np.zeros((3, 5), np.float32), "cpu")


def test_layout_constants_and_resample_match():
    for name in (
        "GLYPH_W", "GLYPH_H", "CHARS", "MAX_BANDS", "MAX_GPB", "MAX_WPB", "MAX_WG",
        "WIN_H", "WIN_W", "MIN_GLYPH_PX", "MIN_GLYPH_H", "MAX_GLYPH_H",
        "MIN_CONFIDENCE", "MIN_SCALE_WIDTH", "BAR_H", "HDR_I16", "FLAG_BAND_OVERFLOW",
        "WORD_I16", "N_WORDS", "REC_I16", "REC_BYTES",
    ):
        assert getattr(tsd, name) == getattr(jsd, name), name
    rng = np.random.default_rng(0)
    for shape in ((5, 3), (16, 12), (37, 21)):
        win = rng.random(shape).astype(np.float32)
        np.testing.assert_array_equal(tsd._resample_np(win), jsd._resample_np(win))
    for w in (16, 328, 493, 986):
        assert tsd.scan_budget(w) == jsd.scan_budget(w)


@pytest.mark.parametrize("case", ["two_scales_1080p", "junk_band", "band_overflow"])
def test_decode_copies_match_original(case):
    _, rec = _records(*CASES[case]())
    a, b = tsd.decode_records(rec), jsd.decode_records(rec)
    for field in ("complete", "bars", "trusted", "n_bands", "flags", "band_bits"):
        assert getattr(a, field) == getattr(b, field), field
    # OcrResult of each package: compared by value.
    assert [dataclasses.astuple(w) for w in a.words] == [dataclasses.astuple(w) for w in b.words]
    assert all(type(w).__module__ == "smh_tpu_torch.ocr.engine" for w in a.words)
    assert tsd.ratio_from_records(a) == jsd.ratio_from_records(b)


def test_runs_match_jax():
    rng = np.random.default_rng(1)
    for n, k in ((1, 2), (40, 3), (300, 6)):
        m = rng.random(n) < 0.4
        got = [t.numpy() for t in tsd._runs(torch.from_numpy(m), k)]
        want = [np.asarray(t) for t in jax.jit(jsd._runs, static_argnums=1)(m, k)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_port_frames_equal_the_originals():
    """The port's frame maker stamps text from its bundled font copy; with
    the system fonts present the frames are identical."""
    kw = dict(
        marker_lines=[((120, 150), (700, 520))], scale_texts=[("300m", (60, 170))],
        scale_bars=[(60, 200, 120, 1)],
    )
    assert all(ttesting.fonts_present().values())
    np.testing.assert_array_equal(ttesting.make_frame(1280, 720, **kw), testing.make_frame(1280, 720, **kw))
    np.testing.assert_array_equal(ttesting.make_frame(641, 361), testing.make_frame(641, 361))
