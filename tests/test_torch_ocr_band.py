"""Kernel 11 (csrc/ocr_band.cu) on the CPU: its wrapper's plain twin against
the JAX package's OCR transports (smh_tpu/ops/pipeline.py::_pack_outputs:
the keep mask ocr_img < OCR_BINARY_THRESHOLD, its row bbox by two
_first_true_counts, the band's start clip(oy0, 0, brq_h - band), the smeta,
the dynamic_slices of the scales bits and of pack_bits(keep) or ocr_img;
the unbanded binary transport's pack_bits(keep)) at the edges the kernel
must get right -- a textless quadrant, text on the first or last row or
near the bottom, band == h, a single text pixel, text around the seams of
the cluster's row strips, ragged widths -- on kernel 6's own outputs (the
scales bits and ocr_img as views of its scalespack), and on batches cut
from the rows of one buffer. All comparisons are exact. Also: the wrapper
takes the twin on a CPU tensor, refuses what the kernel does not take (with
a plan cached too), builds its plan once per key and launches nothing on
the CPU; the probe's patches apply to the source. (The CUDA kernel itself is held against the
twin on the card by chip_smoke.py.)"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import pipeline as opp
from smh_tpu_torch import _build, testing
from smh_tpu_torch import probe_ocr_band as probe
from smh_tpu_torch.ocr.engine import OCR_BINARY_THRESHOLD
from smh_tpu_torch.ops import kernels

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
CASES = testing.ocr_band_cases()


def _inputs(ocr: np.ndarray, seed: int = 0) -> tuple:
    """(text, scales_bits, ocr_img) as kernel 6 hands them over: the keep
    plane u8 0/1, random scales bits, the OCR image."""
    h, w = ocr.shape
    sbits = np.random.default_rng(seed).integers(0, 256, (h, (w + 7) // 8), dtype=np.uint8)
    return (ocr < OCR_BINARY_THRESHOLD).astype(np.uint8), sbits, ocr


def _want(ocr: np.ndarray, sbits: np.ndarray, inline: str, band) -> list:
    """JAX's sections, in the hostpack's order."""
    keep = jnp.asarray(ocr) < jnp.uint8(OCR_BINARY_THRESHOLD)
    packed = np.asarray(opp.pack_bits(keep))
    if band is None:
        return [sbits.reshape(-1), packed.reshape(-1)]
    brq_h, brq_w = ocr.shape
    krows = keep.any(axis=1)
    oy0 = opp._first_true_count(krows)
    oy1 = jnp.int32(brq_h) - opp._first_true_count(krows[::-1])
    b0 = jnp.clip(oy0, 0, brq_h - band)
    smeta = np.array([int(oy0), int(oy1), int(b0)], np.int32).view(np.uint8)
    bpr = (brq_w + 7) // 8
    sb = jax.lax.dynamic_slice(jnp.asarray(sbits), (b0, 0), (band, bpr))
    other = packed if inline == "binary" else ocr
    ob = jax.lax.dynamic_slice(jnp.asarray(other), (b0, 0), (band, other.shape[1]))
    return [smeta, np.asarray(sb).reshape(-1), np.asarray(ob).reshape(-1)]


def _check(text, sbits, ocr, inline, band, want) -> list:
    got = kernels.ocr_band(torch.from_numpy(text), torch.from_numpy(sbits), torch.from_numpy(ocr), inline, band)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.uint8 and g.dim() == 1
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"section {i}")
    return [g.numpy() for g in got]


@pytest.mark.parametrize("inline", ["binary", "gray"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_twin_matches_jax(name, inline):
    ocr, band = CASES[name]
    text, sbits, _ = _inputs(ocr)
    got = _check(text, sbits, ocr, inline, band, _want(ocr, sbits, inline, band))
    oy0, oy1, b0 = got[0].view(np.int32)
    h = ocr.shape[0]
    if name == "textless":
        assert (oy0, oy1, b0) == (h, 0, h - band)
    if name == "near_bottom":
        assert b0 == h - band and oy1 == h
    if name == "first_row":
        assert (oy0, b0) == (0, 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_unbanded_binary_twin_matches_jax(name):
    ocr, _ = CASES[name]
    text, sbits, _ = _inputs(ocr, seed=1)
    _check(text, sbits, ocr, "binary", None, _want(ocr, sbits, "binary", None))


@pytest.mark.parametrize("inline,band", [("binary", None), ("binary", 24), ("gray", 24)])
def test_kernel6_outputs_at_the_1080p_quadrant(inline, band):
    """Kernel 6's plain twin over a text-like 411x493 quadrant (the 1080p
    map's): its text plane, and its scales bits and ocr_img as views of the
    scalespack, give JAX's sections of its ocr_img."""
    rng = np.random.default_rng(5)
    rgb = testing.text_rgb(rng, 411, 493, share=0.02)
    planes = [torch.from_numpy(np.ascontiguousarray(rgb[..., c])) for c in range(3)]
    luma = torch.from_numpy(rng.integers(0, 256, (411, 493), dtype=np.uint8))
    out = kernels.brq_preprocess(*planes, luma)
    ocr, sbits = out["ocr_img"].numpy(), out["scales_bits"].numpy()
    assert (ocr < OCR_BINARY_THRESHOLD).any()
    got = kernels.ocr_band(out["text"], out["scales_bits"], out["ocr_img"], inline, band)
    for g, w in zip(got, _want(ocr, sbits, inline, band)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("bsz", [1, 3, 8])
@pytest.mark.parametrize("inline,band", [("binary", None), ("binary", 12), ("gray", 12)])
def test_a_batch_cut_from_strided_rows_matches_each_frame(bsz, inline, band):
    """Quadrants one buffer apart (strides that are no multiple of 4), each
    with its own text rows: each frame's sections equal JAX's of it."""
    h, w = 29, 61
    bpr = (w + 7) // 8
    rng = np.random.default_rng(bsz)
    text_rows = torch.zeros((bsz, h * w + 3), dtype=torch.uint8)
    spack = torch.zeros((bsz, h * bpr + h * w + 5), dtype=torch.uint8)
    text = text_rows[:, : h * w].view(bsz, h, w)
    sbits = spack[:, : h * bpr].view(bsz, h, bpr)
    ocr = spack[:, h * bpr : h * bpr + h * w].view(bsz, h, w)
    for i in range(bsz):
        img = np.full((h, w), 255, np.uint8)
        if i != 1:  # frame 1 textless
            img[2 * i : 2 * i + 3, 5 * i : 5 * i + 9] = rng.integers(0, OCR_BINARY_THRESHOLD, (3, 9), dtype=np.uint8)
        ocr[i] = torch.from_numpy(img)
        sbits[i] = torch.from_numpy(rng.integers(0, 256, (h, bpr), dtype=np.uint8))
        text[i] = torch.from_numpy((img < OCR_BINARY_THRESHOLD).astype(np.uint8))
    got = kernels.ocr_band(text, sbits, ocr, inline, band)
    for i in range(bsz):
        want = _want(ocr[i].numpy(), sbits[i].numpy(), inline, band)
        assert len(got) == len(want)
        for k, (g, wnt) in enumerate(zip(got, want)):
            assert g.shape[0] == bsz
            np.testing.assert_array_equal(g[i].numpy(), wnt, err_msg=f"frame {i} section {k}")


def test_wrapper_takes_the_twin_on_the_cpu(monkeypatch):
    ocr, band = CASES["dense"]
    text, sbits, _ = _inputs(ocr)
    calls = []
    twin = kernels.ocr_band_plain
    monkeypatch.setattr(kernels, "ocr_band_plain", lambda *a: calls.append(a) or twin(*a))
    kernels.reset_launches()
    _check(text, sbits, ocr, "gray", band, _want(ocr, sbits, "gray", band))
    _check(text, sbits, ocr, "binary", None, _want(ocr, sbits, "binary", None))
    assert len(calls) == 2 and kernels.LAUNCHES["ocr_band"] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    text = torch.zeros((20, 30), dtype=torch.uint8)
    sbits = torch.zeros((20, 4), dtype=torch.uint8)
    ocr = torch.zeros((20, 30), dtype=torch.uint8)
    bad = [
        (text, sbits, ocr, "gray", None),  # gray is a band or no kernel
        (text, sbits, ocr, "device", 5),  # not an image transport
        (text, sbits, ocr, "binary", 0),  # an empty band
        (text, sbits, ocr, "binary", 21),  # a band taller than the quadrant
        (text.to(torch.int32), sbits, ocr, "binary", 5),  # not u8
        (text[None, None], sbits, ocr, "binary", 5),  # rank 4
        (text[:0], sbits[:0], ocr[:0], "binary", None),  # empty
        (text, sbits[:, :3], ocr, "binary", 5),  # 30 columns take 4 bytes a row
        (text, sbits, ocr[:19], "gray", 5),  # ocr_img of another shape
        (text[None].expand(2, 20, 30), sbits, ocr, "binary", None),  # another batch shape
        (text.to("meta"), sbits.to("meta"), ocr.to("meta"), "binary", 5),  # neither the CPU nor a card
        (text, sbits.to("meta"), ocr, "binary", 5),  # two devices
    ]
    for args in bad:
        with pytest.raises(ValueError):
            kernels.ocr_band(*args)


def test_the_entry_point_and_layout_match_the_cuda_source():
    src = (CSRC / "ocr_band.cu").read_text()
    assert 4 * int(re.search(r"constexpr int SMETA = (\d+);", src).group(1)) == kernels.BAND_META
    assert "ocr_band_kernel" in src  # the profiler counts kernels by "<LAUNCHES key>_kernel"
    assert (CSRC / "ocr_band.cu") in _build.sources() and "smh_ocr_band" in _build._SIGNATURES
    assert re.search(r'extern "C" int smh_ocr_band\(', src)
    assert kernels.BAND_PASS == ("ocr_band",) and "ocr_band" in kernels.LAUNCHES


def test_the_band_starts_reach_every_value_mod_16():
    """The b0_mod16 cases start the band at rows whose first byte of ocr_img
    (b0 w) and of the scales bits (b0 ceil(w / 8)) take every value mod 16."""
    starts = set()
    for name, (ocr, band) in CASES.items():
        if name.startswith("b0_mod16_"):
            text, sbits, _ = _inputs(ocr)
            b0 = int(_check(text, sbits, ocr, "gray", band, _want(ocr, sbits, "gray", band))[0].view(np.int32)[2])
            assert b0 == int(name.rsplit("_", 1)[1])
            w = ocr.shape[1]
            starts.add((b0 * w % 16, b0 * ((w + 7) // 8) % 16))
    assert {a for a, _ in starts} == set(range(16)) and {b for _, b in starts} == set(range(16))


def _band_inputs():
    ocr, band = CASES["dense"]
    text, sbits, _ = _inputs(ocr)
    return torch.from_numpy(text), torch.from_numpy(sbits), torch.from_numpy(ocr), band


def test_a_second_call_with_the_same_key_reuses_the_plan():
    text, sbits, ocr, band = _band_inputs()
    plan = kernels.ocr_band_plan_for(text, sbits, ocr, "gray", band)
    n = len(kernels._BAND_PLANS)
    assert kernels.ocr_band_plan_for(text.clone(), sbits.clone(), ocr.clone(), "gray", band) is plan
    kernels.ocr_band(text, sbits, ocr, "gray", band)
    assert len(kernels._BAND_PLANS) == n
    h, w = text.shape
    assert (plan.nb, plan.nx, plan.band, plan.binary) == (band * ((w + 7) // 8), band * w, band, 0)
    assert plan.row % 4 == 0 and plan.row >= kernels.BAND_META + plan.nb + plan.nx


@pytest.mark.parametrize("change", ["shape", "stride", "band", "inline", "unbanded", "batch"])
def test_a_new_shape_stride_band_or_inline_builds_a_new_plan(change):
    text, sbits, ocr, band = _band_inputs()
    plan = kernels.ocr_band_plan_for(text, sbits, ocr, "gray", band)
    args = [text, sbits, ocr, "gray", band]
    if change == "shape":
        args[:3] = text[:-1], sbits[:-1], ocr[:-1]
    elif change == "stride":  # the same frames, a frame stride of 4 more bytes
        batch = [t.expand(2, -1, -1).contiguous() for t in (text, sbits, ocr)]
        plan = kernels.ocr_band_plan_for(*batch, "gray", band)
        for i, t in enumerate(batch):
            rows = torch.zeros((2, t[0].numel() + 4), dtype=torch.uint8)
            rows[:, : t[0].numel()] = t.reshape(2, -1)
            args[i] = rows[:, : t[0].numel()].view(t.shape)
    elif change == "band":
        args[4] = band - 1
    elif change == "inline":
        args[3] = "binary"
    elif change == "unbanded":
        args[3:] = "binary", None
    else:
        args[:3] = text[None], sbits[None], ocr[None]
    new = kernels.ocr_band_plan_for(*args)
    assert new is not plan and kernels.ocr_band_plan_for(*args) is new
    got, want = kernels.ocr_band(*args), kernels.ocr_band_plain(*args)
    assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def test_a_wrong_tensor_raises_with_a_plan_cached():
    text, sbits, ocr, band = _band_inputs()
    kernels.ocr_band(text, sbits, ocr, "gray", band)
    bad = [
        (text.to(torch.int32), sbits, ocr, "gray", band),
        (text, sbits[:, :3], ocr, "gray", band),
        (text, sbits, ocr[:-1], "gray", band),
        (text, sbits, ocr, "gray", text.shape[0] + 1),
        (text, sbits, ocr, "gray", None),
        (text, sbits.to("meta"), ocr, "gray", band),
        (text.to("meta"), sbits.to("meta"), ocr.to("meta"), "gray", band),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            kernels.ocr_band(*args)


def test_the_plan_of_a_strided_batch_on_the_card():
    """ocr_band_plan, as ocr_band_plan_for builds it for CUDA inputs: the
    frame strides given, the sections' bytes, the output row padded to 4
    bytes (banded) or the keep mask's bytes (unbanded)."""
    plan = kernels.ocr_band_plan((1, 411, 493), "gray", 51, (411 * 493, 0, 0))
    assert (plan.out_shape, plan.nb, plan.nx, plan.band, plan.binary, plan.bsz) == ((1, 28320), 51 * 62, 51 * 493,
                                                                                   51, 0, 1)
    assert plan.pieces == (12, 51 * 62, 51 * 493, 28320 - 12 - 51 * 62 - 51 * 493)
    plan = kernels.ocr_band_plan((8, 411, 493), "binary", None, (202660, 0, 0))
    assert (plan.out_shape, plan.row, plan.nx, plan.band, plan.binary, plan.stride) == ((8, 411 * 62), 411 * 62,
                                                                                         411 * 62, 0, 1, 202660)


@pytest.mark.parametrize("build", sorted(probe.variants_of((CSRC / "ocr_band.cu").read_text())))
def test_the_probe_patches_apply(build):
    """Each build of probe_ocr_band applies to the kernel source as it is
    (its design is this one), and changes it (but the unpatched build)."""
    src = (CSRC / "ocr_band.cu").read_text()
    assert probe.design_of(src) == next(iter(probe.DESIGNS))
    text, keeps = probe.variants_of(src)[build]
    assert (text == src) == (build == "as built")
    assert keeps == (not build.startswith(("ablation", "chain")))
    compile(probe.CALLS_CHILD, "calls", "exec")
