"""Kernel 6 (csrc/brq_preprocess.cu) on the CPU: its wrapper's plain twin
against the JAX package's XLA functions -- _ocr_preprocess_planes,
pack_bits(luma != 0), the two _weighted_checks of _pack_outputs and the
text mask -- on seeded planes: ragged widths, strict pixels by the last
rows and columns, dense planes, the kernel's tile seams, windows of a
larger plane, a batch of frames cut from the rows of one buffer, and the
mesh's row bands. All comparisons are exact. The JAX functions run op by
op, as tests/test_torch_fused_mask.py runs the classify: under jit, XLA
contracts the luma's multiply-adds into FMAs (and differently in each
fusion), which flips a truncated luma at some grey pixels -- the very
pixels the text test looks at. Op by op, JAX's luma is the port's. Also: the
wrapper refuses what the kernel does not take, launches nothing on the
CPU, and the fused pass calls it once per pass. (The CUDA kernel itself is
held against the twin on the card by chip_smoke.py.)"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import hsv as jhsv
from smh_tpu.ops import pipeline as opp
from smh_tpu_torch import _probe, probe_brq_preprocess
from smh_tpu_torch import consts as C
from smh_tpu_torch import testing
from smh_tpu_torch.ocr.engine import OCR_BINARY_THRESHOLD
from smh_tpu_torch.ops import kernels
from smh_tpu_torch.ops import pipeline as tpp

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
CASES = testing.brq_preprocess_cases(np.random.default_rng(12))


def _jax_brq(r8, g8, b8):
    """The JAX package's region kernel 6 replaces, as its fused pass
    computes it from the quadrant's planes, and the luma it computes."""
    ocr = opp._ocr_preprocess_planes(r8, g8, b8)
    luma = jhsv.luma8_planes(r8, g8, b8)
    scales_bool = luma != 0
    bits = opp.pack_bits(scales_bool)
    scheck = jnp.concatenate([opp._weighted_check(bits), opp._weighted_check(ocr)])
    return ocr, bits, scales_bool, ocr < jnp.uint8(OCR_BINARY_THRESHOLD), scheck, luma


def _jax(rgb: np.ndarray) -> tuple:
    return tuple(np.asarray(x) for x in _jax_brq(*(jnp.asarray(rgb[..., c]) for c in range(3))))


def _want(rgb: np.ndarray) -> dict:
    ocr, bits, sbool, text, scheck, _ = _jax(rgb)
    return {
        "scalespack": np.concatenate([bits.reshape(-1), ocr.reshape(-1)]),
        "scales_bits": bits, "ocr_img": ocr, "text": text.astype(np.uint8), "sbool": sbool.astype(np.uint8),
        "scheck": scheck.view(np.int32),
    }


def _planes(rgb: np.ndarray):
    """The R, G, B planes and the JAX program's luma of them."""
    r8, g8, b8 = (torch.from_numpy(np.ascontiguousarray(rgb[..., c])) for c in range(3))
    return r8, g8, b8, torch.from_numpy(_jax(rgb)[-1].copy())


def _assert_equal(got: dict, want: dict, label: str = "") -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, (label, k)
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{label} {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_twin_matches_jax(name):
    rgb = CASES[name]
    _assert_equal(kernels.brq_preprocess(*_planes(rgb)), _want(rgb), name)


@pytest.mark.parametrize("h,w", [(411, 493), (96, 257)])
def test_windows_of_the_map_match_jax(h, w):
    """The quadrant as the fused pass hands it over: windows (rows 2w
    bytes apart) of the map's planes and of the map's luma."""
    rgb = testing.text_rgb(np.random.default_rng(h), 2 * h, 2 * w, share=0.3)
    r8, g8, b8, luma = _planes(rgb)
    got = kernels.brq_preprocess(*(p[h:, w:] for p in (r8, g8, b8, luma)))
    _assert_equal(got, _want(rgb[h:, w:]))
    assert got["ocr_img"].data_ptr() == got["scalespack"].data_ptr() + h * ((w + 7) // 8)


@pytest.mark.parametrize("bsz", [1, 3])
def test_a_batch_cut_from_strided_rows_matches_each_frame(bsz):
    """B frames, plane-major in the rows of one [B, padded] buffer an odd
    number of bytes apart, as the batched pass cuts them: each frame's
    outputs equal JAX's on that frame."""
    rng = np.random.default_rng(bsz)
    h, w = 37, 53
    rows = torch.zeros((bsz, 3 * h * w + 13), dtype=torch.uint8)
    frames = [testing.text_rgb(rng, h, w) for _ in range(bsz)]
    for i, rgb in enumerate(frames):
        rows[i, : 3 * h * w] = torch.from_numpy(np.moveaxis(rgb, -1, 0).reshape(-1))
    planes = rows[:, : 3 * h * w].view(bsz, 3, h, w)
    r8, g8, b8 = planes[:, 0], planes[:, 1], planes[:, 2]
    luma = torch.stack([_planes(rgb)[3] for rgb in frames])
    got = kernels.brq_preprocess(r8, g8, b8, luma)
    assert got["scalespack"].shape == (bsz, h * ((w + 7) // 8) + h * w)
    for i, rgb in enumerate(frames):
        _assert_equal({k: v[i] for k, v in got.items()}, _want(rgb), f"frame {i}")


@pytest.mark.parametrize("row0,rows", [(0, 10), (7, 12), (20, 10), (27, 3)])
def test_a_mesh_band_gives_the_quadrants_rows(row0, rows):
    """A band of quadrant rows with R rows of context each side (the mesh
    block's call): its rows of ocr_img, text, sbool and the scales bits
    equal those rows of JAX's whole quadrant; the last-rows clip is taken
    in the quadrant's rows."""
    rgb = testing.text_rgb(np.random.default_rng(row0), 30, 45, share=0.6)
    R = int(C.OCR_PREPROCESS_DILATE_RADIUS)
    lo, hi = max(0, row0 - R), min(30, row0 + rows + R)
    got = kernels.brq_preprocess(*(p[lo:hi] for p in _planes(rgb)), row0=lo, total_h=30)
    want = _want(rgb)
    for k in ("ocr_img", "text", "sbool", "scales_bits"):
        np.testing.assert_array_equal(got[k][row0 - lo : row0 - lo + rows].numpy(), want[k][row0 : row0 + rows],
                                      err_msg=k)


def test_strict_pixels_by_the_last_rows_and_columns_stay_text_but_do_not_dilate():
    rgb = CASES["strict_by_the_last_rows_and_columns"]
    got = kernels.brq_preprocess(*_planes(rgb))
    text = got["text"].numpy()
    h, w = text.shape
    R = int(C.OCR_PREPROCESS_DILATE_RADIUS)
    assert text[h - 1, 5] and text[h - 1 - R, 5 + 9 * R]
    assert text[3, w - 1] and not text[3, w - 2]  # clipped: its edge neighbours stay background
    assert text[h - 1 - R, 5 + 9 * R - 1]  # row h - 1 - R is inside the clip: it dilates


def test_wrapper_refuses_what_the_kernel_does_not_take_and_launches_nothing_on_the_cpu():
    kernels.reset_launches()
    p = torch.zeros((6, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.brq_preprocess(p, p, p, p.to(torch.int16))
    with pytest.raises(ValueError):
        kernels.brq_preprocess(p, p, p[:5], p)
    with pytest.raises(ValueError):
        kernels.brq_preprocess(p[None, None], p[None, None], p[None, None], p[None, None])
    with pytest.raises(ValueError):
        kernels.brq_preprocess(p, p, p, p, row0=2, total_h=7)  # rows 2 .. 8 of 7
    with pytest.raises(ValueError):
        kernels.brq_preprocess(p[:0], p[:0], p[:0], p[:0])
    meta = torch.zeros((6, 9), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        kernels.brq_preprocess(meta, meta, meta, meta)
    kernels.brq_preprocess(p, p, p, p)
    assert kernels.LAUNCHES["brq_preprocess"] == 0


@pytest.mark.parametrize("variant", sorted(probe_brq_preprocess.VARIANTS))
def test_probe_patches_apply(variant):
    """Each variant and ablation of probe_brq_preprocess applies to the
    source as it is, and changes it (except the unpatched build)."""
    src = _probe.patched(
        CSRC, ("brq_preprocess.cu",), {"brq_preprocess.cu": list(probe_brq_preprocess.VARIANTS[variant][0])}
    )["brq_preprocess.cu"]
    assert (src == (CSRC / "brq_preprocess.cu").read_text()) == (not probe_brq_preprocess.VARIANTS[variant][0])
    assert "smh_brq_preprocess" in src and "__global__" in src


def test_kernel_radius_is_the_preprocess_radius():
    """The kernel's halo and dilate are built for one radius: the
    constant's; its tile (a warp of quads, lane 0 the 4 pixels before the
    tile) and its scratch a frame are the wrapper's."""
    src = (CSRC / "brq_preprocess.cu").read_text()
    assert int(re.search(r"constexpr int R = (\d+);", src).group(1)) == int(C.OCR_PREPROCESS_DILATE_RADIUS)
    assert "_ocr_preprocess_planes" in src and "_weighted_check" in src
    assert 4 * (int(re.search(r"constexpr int QUADS = (\d+);", src).group(1)) - 1) == kernels.BRQ_TILE_W
    assert int(re.search(r"constexpr int TH = (\d+);", src).group(1)) == kernels.BRQ_TILE_H
    assert int(re.search(r"constexpr int TH_SMALL = (\d+);", src).group(1)) == kernels.BRQ_TILE_H_SMALL
    assert int(re.search(r"constexpr int SCRATCH = (\d+);", src).group(1)) == kernels.BRQ_SCRATCH
    assert "cudaMemsetAsync" not in src  # the checks come from the scratch, not a memset


def _rois(rng, g) -> np.ndarray:
    """A flat plane-major BGR map ROI with a marker line and text-like
    quadrant pixels, then the button ROI: analyze_packed_flat's input."""
    planes = np.zeros((3, g.map_h, g.map_w), np.uint8)
    rgb = testing.text_rgb(rng, g.map_h, g.map_w, share=0.1)
    for c in range(3):
        planes[c] = rgb[..., 2 - c]
    planes[:, 30:33, 20:120] = np.array(testing.ALPHA_MARKER_RGB[::-1], np.uint8)[:, None, None]
    btn = rng.integers(0, 256, (g.btn_h, g.btn_w, 3), dtype=np.uint8)
    return np.concatenate([planes.reshape(-1), btn.reshape(-1)])


def test_the_fused_pass_calls_each_new_wrapper_once_per_pass(monkeypatch):
    """smhocr + sparse: analyze_packed_flat and the batched pass call
    kernel 6's and kernel 7's wrappers once each (a batch: once for all
    its frames). The bytes are held against JAX by test_torch_pipeline.py,
    test_torch_batch*.py and test_torch_transports.py."""
    from smh_tpu_torch.ops import scales_device as tsd

    calls = {"brq_preprocess": 0, "mask_bbox_sparse": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(kernels, name, counted)
    g = C.map_geometry(320, 240)
    rng = np.random.default_rng(5)
    packed = _rois(rng, g)
    kw = dict(map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w, grayscale=True,
              scales_inline="device", sparse_budget=256)
    tpl = tsd.templates_to_device(tsd.device_templates(), "cpu")
    got = tpp.analyze_packed_flat(torch.from_numpy(packed), templates=tpl, **kw)
    assert calls == {"brq_preprocess": 1, "mask_bbox_sparse": 1}
    layout = tpp.hostpack_layout(g.map_h, g.map_w, scales_inline="device", sparse_budget=256)
    assert got["hostpack"].shape == (layout["__total__"],)
    assert got["scalespack"].shape == (tpp.scalespack_layout(g.map_h, g.map_w)["__total__"],)
    rows = np.stack([packed, _rois(rng, g), packed])
    tpp.analyze_batch_packed_flat(torch.from_numpy(rows), templates=tpl, **kw)
    assert calls == {"brq_preprocess": 2, "mask_bbox_sparse": 2}
