"""Kernel 5, the scales read (csrc/scales_read.cu; wrapper
ops/scales_device.py::scales_records, plain twin scales_records_plain) on
the CPU: the wrapper's plain path against the plain version and the JAX
package's scales_records, on the edge cases of
testing.scales_read_cases and on [B, H, W] batches whose frames lie a
stride apart (against jax.vmap of the original); the batched pass's one
call per batch; the wrapper's checks and launch counter; the kernel
source's constants. The CUDA kernel is held against the plain version on
the card by chip_smoke.py's scales_read phase."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import scales_device as jsd
from smh_tpu_torch import testing
from smh_tpu_torch.ops import kernels
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.ops import scales_device as tsd

from test_torch_scales_device import CASES, _assert_records_match

torch.set_num_threads(1)

CSRC = pathlib.Path(tsd.__file__).resolve().parent.parent / "csrc" / "scales_read.cu"
EDGES = testing.scales_read_cases()
_TPL = tsd.device_templates()
_jrec = jax.jit(jsd.scales_records)


def _tpl() -> torch.Tensor:
    return tsd.templates_to_device(_TPL, "cpu")


def _jax(text: np.ndarray, sbool: np.ndarray) -> np.ndarray:
    return np.asarray(_jrec(jnp.asarray(text), jnp.asarray(sbool), jnp.asarray(_TPL)))


def _planes(case: str) -> tuple:
    """(text, sbool) bool planes of an edge case or of a CASES frame."""
    if case in EDGES:
        return EDGES[case]
    ocr_img, sbin = CASES[case]()
    return ocr_img < tsd.OCR_BINARY_THRESHOLD, sbin != 0


@pytest.mark.parametrize("case", sorted(EDGES) + sorted(CASES))
def test_wrapper_on_the_cpu_equals_plain(case):
    text, sbool = (torch.from_numpy(p) for p in _planes(case))
    before = dict(kernels.LAUNCHES)
    got = tsd.scales_records(text, sbool, _tpl())
    assert kernels.LAUNCHES == before  # CPU tensors never launch
    assert got.dtype == torch.int16 and got.shape == (tsd.REC_I16,)
    assert torch.equal(got, tsd.scales_records_plain(text, sbool, _tpl()))
    # u8 planes (nonzero = True) read as the bool ones
    assert torch.equal(tsd.scales_records(text.to(torch.uint8) * 255, sbool.to(torch.uint8), _tpl()), got)


def _word(rec: np.ndarray, o: int) -> np.ndarray:
    return rec[tsd.HDR_I16 + o * tsd.WORD_I16 : tsd.HDR_I16 + (o + 1) * tsd.WORD_I16]


@pytest.mark.parametrize("case", sorted(EDGES))
def test_edge_case_matches_jax(case):
    text, sbool = EDGES[case]
    got = tsd.scales_records(torch.from_numpy(text), torch.from_numpy(sbool), _tpl()).numpy()
    if case == "narrow_plane":
        # smh_tpu's bar scan indexes its empty row range and raises at
        # scan_budget 0; the port reads "no bar" there (the plain version's
        # budget == 0 branch). Every lane but the bar's matches the
        # original on the same plane one column wider.
        with pytest.raises(IndexError):
            _jax(text, sbool)
        wide_t, wide_s = (np.pad(p, ((0, 0), (0, 1)), constant_values=v) for p, v in ((text, False), (sbool, True)))
        assert tsd.scan_budget(wide_t.shape[1]) == 1
        want = _jax(wide_t, wide_s)
        bar = np.zeros(tsd.REC_I16, bool)
        bar[tsd.HDR_I16 + 5 : tsd.HDR_I16 + 9] = True  # word 0's found, y, left, right
        _assert_records_match(np.where(bar, 0, got), np.where(bar, 0, want))
    else:
        _assert_records_match(got, _jax(text, sbool))
    n_bands, flags, _, band_bits = got[:4]
    words = [_word(got, o) for o in range(tsd.N_WORDS) if _word(got, o)[0] > 0]
    bars = [tuple(w[6:9]) if w[5] else None for w in words]
    if case == "word_over_max_wg":  # 9 glyphs: the first MAX_WG kept, the word flagged
        assert len(words) == 1 and words[0][0] == tsd.MAX_WG and words[0][9] == 1 and bars[0] is not None
    if case == "words_over_max_wpb":  # six words: four slots, the band flagged
        assert len(words) == tsd.MAX_WPB and band_bits == 1 and all(b is not None for b in bars)
    if case == "band_taller_than_win_h":
        assert n_bands == 1 and band_bits == 1 and len(words) == 1
    if case == "narrow_plane":
        assert tsd.scan_budget(text.shape[1]) == 0 and len(words) == 1 and bars == [None]
    if case == "bar_at_column_0":  # the left walk's column-0 sentinel
        assert len(words) == 1 and bars == [None] and not sbool[:, 0].all()
    if case == "bar_in_last_rows":
        h = text.shape[0]
        assert len(words) == 2 and bars[0][0] == h - tsd.BAR_H and bars[1] is None
    if case == "empty_plane":
        assert n_bands == 0 and flags == 0 and not words
    if case == "bands_across_strip_seams":  # each band straddles a 32-row seam
        assert n_bands == 2 and band_bits == 0 and len(words) == 2 and None not in bars
    if case == "word_below_win_h":  # the window holds the stroke alone, which fails the gate
        assert n_bands == 1 and band_bits == 1 and not words
    if case == "bands_over_max_bands":
        assert n_bands == tsd.MAX_BANDS and flags == tsd.FLAG_BAND_OVERFLOW and len(words) == tsd.MAX_BANDS
    if case == "bar_rows_past_the_plane":
        h = text.shape[0]
        assert words[0][4] + tsd.scan_budget(text.shape[1]) > h - tsd.BAR_H
        assert bars[0] is not None and bars[0][0] == h - tsd.BAR_H and bars[1] is None
    if case == "bars_to_the_last_column":  # the right walk stops at the last column; a bar from column 0 misses
        assert bars[0] == (bars[0][0], bars[0][1], text.shape[1] - 2) and bars[1] is None
    if case == "width_77":
        assert text.shape[1] % 16 and len(words) == 3 and None not in bars
    if case == "plane_shorter_than_a_strip":
        assert text.shape[0] < 32 and len(words) == 1 and bars[0] is not None


def _batch_planes(cases, extra: int):
    """The cases' planes padded to one shape (no text, no black), as
    [B, H, W] bool views of the rows of one [B, H * W + extra] buffer."""
    planes = [_planes(c) for c in cases]
    h = max(t.shape[0] for t, _ in planes)
    w = max(t.shape[1] for t, _ in planes)
    out = []
    for k, fill in ((0, False), (1, True)):
        rows = torch.full((len(planes), h * w + extra), not fill, dtype=torch.bool)
        view = rows[:, : h * w].view(len(planes), h, w)
        for i, p in enumerate(planes):
            view[i] = fill
            ph, pw = p[k].shape
            view[i, :ph, :pw] = torch.from_numpy(p[k])
        out.append(view)
    return out


@pytest.mark.parametrize("extra", [0, 37])
def test_batch_equals_frames_and_vmapped_jax(extra):
    """One call over the CASES frames (and an edge case), their frames a
    row of H * W + extra apart, == the per-frame records == jax.vmap of
    smh_tpu's scales_records."""
    cases = sorted(CASES) + ["word_over_max_wg"]
    text, sbool = _batch_planes(cases, extra)
    assert text.stride(0) == text.shape[1] * text.shape[2] + extra
    got = tsd.scales_records(text, sbool, _tpl())
    assert got.shape == (len(cases), tsd.REC_I16) and got.dtype == torch.int16
    for i in range(len(cases)):
        assert torch.equal(got[i], tsd.scales_records(text[i], sbool[i], _tpl()))
    want = np.asarray(
        jax.jit(jax.vmap(jsd.scales_records, in_axes=(0, 0, None)))(
            jnp.asarray(text.numpy()), jnp.asarray(sbool.numpy()), jnp.asarray(_TPL)
        )
    )
    for i, case in enumerate(cases):
        _assert_records_match(got[i].numpy(), want[i])
    assert any(tsd.decode_records(r.numpy()).words for r in got)


_jvrec = jax.jit(jax.vmap(jsd.scales_records, in_axes=(0, 0, None)))


@pytest.mark.parametrize("extra", [1, 15])
def test_edge_cases_batched_at_odd_strides_match_vmapped_jax(extra):
    """Every edge case but the narrow plane (which smh_tpu's scan cannot
    read), padded to one shape, in one call whose frames lie an odd number
    of bytes apart: == the per-frame records == jax.vmap of smh_tpu's
    scales_records."""
    cases = [c for c in sorted(EDGES) if c != "narrow_plane"]
    text, sbool = _batch_planes(cases, extra)
    assert text.stride(0) % 2 == 1
    got = tsd.scales_records(text, sbool, _tpl())
    for i in range(len(cases)):
        assert torch.equal(got[i], tsd.scales_records(text[i], sbool[i], _tpl()))
    want = np.asarray(_jvrec(jnp.asarray(text.numpy()), jnp.asarray(sbool.numpy()), jnp.asarray(_TPL)))
    for i in range(len(cases)):
        _assert_records_match(got[i].numpy(), want[i])


def test_batched_pass_reads_the_scales_in_one_call(monkeypatch):
    """analyze_batch_packed_flat with the device read: one scales_records
    call for the batch, on [B, h, w] planes."""
    calls = []
    read = tsd.scales_records

    def counting(text, sbool, templates):
        calls.append(tuple(text.shape))
        return read(text, sbool, templates)

    monkeypatch.setattr(tpp.sd, "scales_records", counting)
    rng = np.random.default_rng(3)
    bsz, map_h, map_w, btn = 3, 40, 52, 4
    rows = torch.from_numpy(rng.integers(0, 256, (bsz, 3 * (map_h * map_w + btn * btn) + 5), dtype=np.uint8))
    out = tpp.analyze_batch_packed_flat(
        rows, map_h, map_w, btn, btn, True, scales_inline="device", templates=_tpl(),
    )
    assert calls == [(bsz, map_h // 2, map_w // 2)]
    assert out["hostpack"].shape[0] == bsz


def test_wrapper_rejects_bad_inputs():
    b = torch.zeros((6, 20), dtype=torch.bool)
    tpl = _tpl()
    with pytest.raises(ValueError):
        tsd.scales_records(b.to("meta"), b.to("meta"), tpl.to("meta"))
    with pytest.raises(ValueError):
        tsd.scales_records(b.to(torch.int32), b, tpl)  # dtype
    with pytest.raises(ValueError):
        tsd.scales_records(b[0], b[0], tpl)  # rank 1
    with pytest.raises(ValueError):
        tsd.scales_records(b[None, None], b[None, None], tpl)  # rank 4
    with pytest.raises(ValueError):
        tsd.scales_records(b, b[:5], tpl)  # shapes differ
    with pytest.raises(ValueError):
        tsd.scales_records(b, b, torch.zeros((tsd.MAX_TEMPLATES + 1, tsd.GLYPH_H * tsd.GLYPH_W)))
    with pytest.raises(ValueError):
        tsd.scales_records(b, b, tpl[:, :100])  # not [T, 192]
    with pytest.raises(ValueError):
        tsd.scales_records(b, b, tpl.double())
    with pytest.raises(ValueError):
        tsd.scales_records(b[:0], b[:0], tpl)  # empty
    assert tsd.scales_records(b, b, torch.zeros((tsd.MAX_TEMPLATES, tsd.GLYPH_H * tsd.GLYPH_W))).shape == (
        tsd.REC_I16,
    )


def test_launch_counter_and_fused_pass_name_the_kernel():
    assert "scales_read" in kernels.LAUNCHES and "scales_read" in kernels.FUSED_PASS


def _cu_const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", CSRC.read_text())
    return int(eval(m.group(1), {}, {k: _cu_const(k) for k in re.findall(r"[A-Z_][A-Z0-9_]*", m.group(1))}))


@pytest.mark.parametrize("name", [
    "GLYPH_W", "GLYPH_H", "MAX_BANDS", "MAX_GPB", "MAX_WPB", "MAX_WG", "WIN_H", "WIN_W", "MIN_GLYPH_PX",
    "MIN_GLYPH_H", "MAX_GLYPH_H", "MIN_SCALE_WIDTH", "BAR_H", "HDR_I16", "FLAG_BAND_OVERFLOW", "WORD_I16",
    "N_WORDS", "REC_I16", "MAX_TEMPLATES", "MAX_DIM", "CLUSTER", "THREADS", "MAX_BUDGET",
])
def test_kernel_constants_equal_the_modules(name):
    assert _cu_const(name) == getattr(tsd, name)


def test_source_notes_what_it_replaces_and_is_built():
    from smh_tpu_torch import _build

    src = CSRC.read_text()
    assert "smh_tpu/ops/scales_device.py::scales_records" in src and ":237" in src
    assert "__global__" in src and "scales_read_kernel" in src and 'extern "C" int smh_scales_read(' in src
    assert CSRC in _build.sources() and "smh_scales_read" in _build._SIGNATURES
    # the kernel rounds like the plain version: no FMA, correctly rounded sqrt
    assert "fmaf" not in src and "__fsqrt_rn" in src
