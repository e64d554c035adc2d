"""Kernel 10 (csrc/window_crop.cu) on the CPU: its wrapper's plain twin
against the JAX package's window crop (smh_tpu/ops/pipeline.py::
_pack_outputs: `jnp.clip` of the bbox less LSD_CROP_MARGIN,
`jax.lax.dynamic_slice` of the bool mask, the meta and `pack_bits`) at the
edges the kernel must get right -- an empty mask, the bbox at each border,
the origin's column at every value mod 8, ragged crop widths, one full
dimension, 1-row and 1-column planes -- on random planes at the 1080p map,
and on batches cut from the rows of one buffer with an origin per frame.
All comparisons are exact. Also: the wrapper takes the twin on a CPU
tensor, refuses what the kernel does not take (with a plan cached too),
builds its plan once per key and launches nothing on the CPU; the probe's
patches apply to the source. (The CUDA kernel itself is held against the twin on the card by
chip_smoke.py.)"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import pipeline as opp
from smh_tpu_torch import _build, testing
from smh_tpu_torch import probe_window_crop as probe
from smh_tpu_torch.ops import kernels
from smh_tpu_torch.ops import pipeline as tpp

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
MARGIN = int(tpp.LSD_CROP_MARGIN)
CASES = testing.window_crop_cases(MARGIN)


def _words(bits: np.ndarray, w: int) -> np.ndarray:
    """Kernel 7's i32 lanes before its idx and dat, from JAX's _mask_bbox of
    the unpacked mask (nz left 0: kernel 10 reads the bbox only)."""
    m = jnp.asarray(opp.unpack_bits_host(bits, w).astype(bool))
    return np.array([int(v) for v in opp._mask_bbox(m)] + [0, 0, 0], np.int32)


def _want(bits: np.ndarray, w: int, crop_h: int, crop_w: int) -> tuple:
    """JAX's meta bytes and window bits."""
    m = jnp.asarray(opp.unpack_bits_host(bits, w).astype(bool))
    y0, y1, x0, x1 = opp._mask_bbox(m)
    margin = jnp.int32(MARGIN)
    cy0 = jnp.clip(y0 - margin, 0, m.shape[0] - crop_h)
    cx0 = jnp.clip(x0 - margin, 0, w - crop_w)
    crop = jax.lax.dynamic_slice(m, (cy0, cx0), (crop_h, crop_w))
    meta = np.array([int(v) for v in (y0, y1, x0, x1, cy0, cx0)], np.int32)
    return meta.view(np.uint8), np.asarray(opp.pack_bits(crop)).reshape(-1)


def _crop(bits: np.ndarray, w: int, crop_h: int, crop_w: int, words=None) -> tuple:
    words = _words(bits, w) if words is None else words
    meta, crop = kernels.window_crop(torch.from_numpy(bits), torch.from_numpy(words), w, crop_h, crop_w, MARGIN)
    assert meta.dtype == crop.dtype == torch.uint8
    assert meta.shape == (kernels.WINDOW_META,) and crop.shape == (crop_h * ((crop_w + 7) // 8),)
    return meta.numpy(), crop.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_twin_matches_jax(name):
    bits, w, crop_h, crop_w = CASES[name]
    meta, crop = _crop(bits, w, crop_h, crop_w)
    want_meta, want_crop = _want(bits, w, crop_h, crop_w)
    np.testing.assert_array_equal(meta, want_meta)
    np.testing.assert_array_equal(crop, want_crop)


def test_the_edge_cases_reach_their_edges():
    """The cases hold what they are named for: every origin column mod 8,
    the empty mask's clamped origin, the row's last byte under the window."""
    mods = set()
    for name, (bits, w, crop_h, crop_w) in CASES.items():
        y0, y1, x0, x1, cy0, cx0 = _crop(bits, w, crop_h, crop_w)[0].view(np.int32)
        if name.startswith("cx0_mod8_"):
            mods.add(int(cx0) % 8)
            assert int(name[-1]) == cx0 % 8
        if name == "empty":
            h = bits.shape[0]
            assert (y0, y1, x0, x1) == (h, 0, w, 0)
            assert (cy0, cx0) == (min(h - MARGIN, h - crop_h), min(w - MARGIN, w - crop_w))
        if name == "last_byte":
            assert cx0 == w - crop_w and cx0 % 8 != 0 and (cx0 + crop_w + 7) // 8 == (w + 7) // 8
    assert mods == set(range(8))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_planes_at_the_map_shape(seed):
    """822x986 (the 1080p map) at the ladder's half-size window and a
    ragged one, the bbox anywhere."""
    rng = np.random.default_rng(seed)
    h, w = 822, 986
    m = np.zeros((h, w), bool)
    y, x = rng.integers(0, h - 100), rng.integers(0, w - 150)
    m[y : y + 100, x : x + 150] = rng.random((100, 150)) < 0.05
    bits = np.packbits(m, axis=1)
    for crop_h, crop_w in ((411, 493), (205, 247)):
        meta, crop = _crop(bits, w, crop_h, crop_w)
        want_meta, want_crop = _want(bits, w, crop_h, crop_w)
        np.testing.assert_array_equal(meta, want_meta)
        np.testing.assert_array_equal(crop, want_crop)


@pytest.mark.parametrize("bsz", [1, 3, 8])
def test_a_batch_cut_from_strided_rows_has_an_origin_per_frame(bsz):
    """Frames one buffer apart (a stride that is no multiple of 4), each
    with its own bbox and origin: each frame equals JAX's crop of it."""
    h, w, crop_h, crop_w = 97, 203, 41, 61
    bpr = (w + 7) // 8
    rows = torch.zeros((bsz, h * bpr + 5), dtype=torch.uint8)
    bits = rows[:, : h * bpr].view(bsz, h, bpr)
    words = torch.zeros((bsz, kernels.MASK_META + 6), dtype=torch.int32)
    origins = set()
    for i in range(bsz):
        m = np.zeros((h, w), bool)
        if i != 1:  # frame 1 empty
            m[5 + 9 * i, 3 + 21 * i] = m[40 + 5 * i, 60 + 13 * i] = True
        bits[i] = torch.from_numpy(np.packbits(m, axis=1))
        words[i, :7] = torch.from_numpy(_words(bits[i].numpy(), w))
    meta, crop = kernels.window_crop(bits, words, w, crop_h, crop_w, MARGIN)
    assert meta.shape == (bsz, kernels.WINDOW_META) and crop.shape == (bsz, crop_h * ((crop_w + 7) // 8))
    for i in range(bsz):
        want_meta, want_crop = _want(bits[i].numpy(), w, crop_h, crop_w)
        np.testing.assert_array_equal(meta[i].numpy(), want_meta, err_msg=f"frame {i}")
        np.testing.assert_array_equal(crop[i].numpy(), want_crop, err_msg=f"frame {i}")
        origins.add(tuple(meta[i].numpy().view(np.int32)[4:]))
    assert len(origins) == bsz


def test_wrapper_takes_the_twin_on_the_cpu(monkeypatch):
    bits, w, crop_h, crop_w = CASES["random_0.01"]
    calls = []
    twin = kernels.window_crop_plain
    monkeypatch.setattr(kernels, "window_crop_plain", lambda *a: calls.append(a) or twin(*a))
    kernels.reset_launches()
    _crop(bits, w, crop_h, crop_w)
    assert len(calls) == 1 and kernels.LAUNCHES["window_crop"] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    bits = torch.zeros((20, 4), dtype=torch.uint8)
    words = torch.zeros(7, dtype=torch.int32)
    bad = [
        (bits.to(torch.int32), words, 30, 5, 5),  # not u8
        (bits, words, 40, 5, 5),  # 40 columns take 5 bytes a row
        (bits[None, None], words, 30, 5, 5),  # rank 4
        (bits[:0], words, 30, 5, 5),  # empty
        (bits, words.to(torch.int64), 30, 5, 5),  # not i32
        (bits, words[:3], 30, 5, 5),  # no bbox
        (bits[None].expand(2, 20, 4), words, 30, 5, 5),  # words of another batch shape
        (bits, words, 30, 21, 5),  # a window taller than the plane
        (bits, words, 30, 5, 31),  # wider
        (bits, words, 30, 0, 5),  # empty window
        (bits.to("meta"), words.to("meta"), 30, 5, 5),  # neither the CPU nor a card
    ]
    for b, wd, w, ch, cw in bad:
        with pytest.raises(ValueError):
            kernels.window_crop(b, wd, w, ch, cw, MARGIN)
    with pytest.raises(ValueError):
        kernels.window_crop(bits, words, 30, 5, 5, -1)


def test_the_entry_point_and_layout_match_the_cuda_source():
    src = (CSRC / "window_crop.cu").read_text()
    assert 4 * int(re.search(r"constexpr int META = (\d+);", src).group(1)) == kernels.WINDOW_META
    assert "window_crop_kernel" in src  # the profiler counts kernels by "<LAUNCHES key>_kernel"
    assert (CSRC / "window_crop.cu") in _build.sources() and "smh_window_crop" in _build._SIGNATURES
    assert re.search(r'extern "C" int smh_window_crop\(', src)
    assert kernels.WINDOW_PASS == ("window_crop",) and "window_crop" in kernels.LAUNCHES


def test_the_fused_pass_takes_the_kernel_on_a_window_route_only():
    """The window route calls kernel 10 once a pass; the sparse and the
    full-plane routes do not."""
    g = tpp.C.map_geometry(960, 540)
    frame = testing.make_frame(960, 540, marker_lines=[((60, 75), (190, 160))])
    from smh_tpu_torch.vision import cuda_backend as cb

    mr = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
    br = frame[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
    packed = torch.from_numpy(cb._pack_rois_bgr(mr, br, cb._DELTA_CHUNK))
    kw = dict(map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w, grayscale=True, with_ocr=False)
    seen = []
    real = kernels.window_crop
    try:
        kernels.window_crop = lambda *a: seen.append(a[3:5]) or real(*a)
        tpp.analyze_packed_flat(packed, crop_h=g.map_h // 2, crop_w=g.map_w // 2, **kw)
        tpp.analyze_packed_flat(packed, sparse_budget=256, **kw)
        tpp.analyze_packed_flat(packed, **kw)
    finally:
        kernels.window_crop = real
    assert seen == [(g.map_h // 2, g.map_w // 2)]


def test_the_right_border_cases_reach_every_origin_mod_8():
    """The row_end cases put the window at the plane's right border (cx0 =
    W - crop_w) at every value of cx0 mod 8."""
    mods = set()
    for name, (bits, w, crop_h, crop_w) in CASES.items():
        if name.startswith("row_end_"):
            cx0 = int(_crop(bits, w, crop_h, crop_w)[0].view(np.int32)[5])
            assert cx0 == w - crop_w
            mods.add(cx0 % 8)
    assert mods == set(range(8))


def _key_inputs():
    bits, w, crop_h, crop_w = CASES["random_0.01"]
    return torch.from_numpy(bits), torch.from_numpy(_words(bits, w)), w, crop_h, crop_w


def test_a_second_call_with_the_same_key_reuses_the_plan():
    bits, words, w, crop_h, crop_w = _key_inputs()
    plan = kernels.window_crop_plan_for(bits, words, w, crop_h, crop_w, MARGIN)
    n = len(kernels._WINDOW_PLANS)
    assert kernels.window_crop_plan_for(bits.clone(), words.clone(), w, crop_h, crop_w, MARGIN) is plan
    _crop(bits.numpy(), w, crop_h, crop_w, words.numpy())
    assert len(kernels._WINDOW_PLANS) == n
    assert plan.n == crop_h * ((crop_w + 7) // 8) and plan.out_shape == (plan.row,) and plan.row % 4 == 0


@pytest.mark.parametrize("change", ["shape", "stride", "crop_h", "crop_w", "margin", "batch"])
def test_a_new_shape_stride_or_crop_builds_a_new_plan(change):
    bits, words, w, crop_h, crop_w = _key_inputs()
    plan = kernels.window_crop_plan_for(bits, words, w, crop_h, crop_w, MARGIN)
    args = [bits, words, w, crop_h, crop_w, MARGIN]
    if change == "shape":
        args[0] = bits[:-1]
    elif change == "stride":  # the same frames, a frame stride of 4 more bytes
        rows = torch.zeros((2, bits.numel() + 4), dtype=torch.uint8)
        rows[:, : bits.numel()] = bits.reshape(-1)
        args[0] = rows[:, : bits.numel()].view(2, *bits.shape)
        args[1] = words.expand(2, -1).contiguous()
        plan = kernels.window_crop_plan_for(bits.expand(2, -1, -1).contiguous(), args[1], w, crop_h, crop_w, MARGIN)
    elif change == "crop_h":
        args[3] = crop_h - 1
    elif change == "crop_w":
        args[4] = crop_w - 1
    elif change == "margin":
        args[5] = MARGIN + 1
    else:
        args[0], args[1] = bits[None], words[None]
    new = kernels.window_crop_plan_for(*args)
    assert new is not plan and kernels.window_crop_plan_for(*args) is new
    meta, crop = kernels.window_crop(*args)
    want = kernels.window_crop_plain(*args)
    assert torch.equal(meta, want[0]) and torch.equal(crop, want[1])


def test_a_wrong_tensor_raises_with_a_plan_cached():
    bits, words, w, crop_h, crop_w = _key_inputs()
    kernels.window_crop(bits, words, w, crop_h, crop_w, MARGIN)
    for b, wd in ((bits.to(torch.int32), words), (bits, words.to(torch.int64)), (bits, words[:3]),
                  (bits[None].expand(2, -1, -1), words), (bits.to("meta"), words.to("meta"))):
        with pytest.raises(ValueError):
            kernels.window_crop(b, wd, w, crop_h, crop_w, MARGIN)
    with pytest.raises(ValueError):
        kernels.window_crop(bits, words, w, crop_h, w + 1, MARGIN)


def test_the_plan_of_a_strided_batch_on_the_card():
    """window_crop_plan, as window_crop_plan_for builds it for CUDA inputs:
    the frame stride given, the words' frame stride, the output row padded
    to 4 bytes."""
    plan = kernels.window_crop_plan((8, 822, 124), (2055, 1), 411, 493, 822 * 124 + 5)
    assert plan == kernels.WindowPlan(out_shape=(8, 25508), row=25508, n=25482, pieces=(24, 25482, 2), h=822,
                                      stride=822 * 124 + 5, words_stride=2055, bsz=8)
    one = kernels.window_crop_plan((822, 124), (1,), 411, 493, 822 * 124)
    assert one.out_shape == (25508,) and one.words_stride == 0 and one.bsz == 1


@pytest.mark.parametrize("build", sorted(probe.variants_of((CSRC / "window_crop.cu").read_text())))
def test_the_probe_patches_apply(build):
    """Each build of probe_window_crop applies to the kernel source as it is
    (its design is this one), and changes it (but the unpatched build)."""
    src = (CSRC / "window_crop.cu").read_text()
    assert probe.design_of(src) == next(iter(probe.DESIGNS))
    text, keeps = probe.variants_of(src)[build]
    assert (text == src) == (build == "as built")
    assert keeps == (not build.startswith("ablation"))
    compile(probe.CALLS_CHILD, "calls", "exec")
