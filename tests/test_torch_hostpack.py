"""Kernel 9, the fused pass's tail (csrc/hostpack.cu), on the CPU: its
plain twin `hostpack_tail_plain` (which the wrapper takes for CPU tensors)
against the JAX package's _weighted_check of the ui plane (the luma, r + g
+ b in colour; all-255 at the 4K map, where the weighted u32 sum wraps;
1-row and 1-column planes) and _red_gate_roi of the close button (the button shapes
of the seven screen sizes with 0, 1, n - 1 and n button-red pixels), a
batch's rows against per-frame calls, and the fused pass's hostpacks on
every route against _analyze_packed_flat with kernel 9 reached once a pass.
The hostpacks of the batch routes are held to _analyze_batch_packed in
test_torch_batch.py, the window and band routes at the 960x540 buckets in
test_torch_transports.py. The kernel itself runs only on the card
(chip_smoke.py's hostpack phase holds it to this twin). All comparisons
are exact."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import pipeline as jpp
from smh_tpu_torch import _probe, probe_hostpack
from smh_tpu_torch import consts as C
from smh_tpu_torch import testing
from smh_tpu_torch.ops import kernels as K
from smh_tpu_torch.ops import pipeline as tpp
from smh_tpu_torch.ops import scales_device as sd
from smh_tpu_torch.vision import cuda_backend as cb

torch.set_num_threads(1)

CSRC = pathlib.Path(K.__file__).resolve().parent.parent / "csrc"
BUTTON_RED = (49, 67, 217)  # BGR of CLOSE_DEPLOYMENT_BUTTON_COLOR


def _planes(kind: str, rng) -> tuple:
    """(ui planes, the JAX _weighted_check input) of a named case."""
    shapes = {"wrap": (1644, 1972), "gray": (822, 986), "colour": (822, 986), "row": (1, 997), "row colour": (1, 997),
              "column": (613, 1), "column colour": (613, 1), "colour wrap": (1644, 1972)}
    h, w = shapes[kind]
    if "wrap" in kind:
        planes = [np.full((h, w), 255, np.uint8)] * (3 if "colour" in kind else 1)
    else:
        planes = [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3 if "colour" in kind else 1)]
    flat = planes[0] if len(planes) == 1 else sum(p.astype(np.uint32) for p in planes)
    return [torch.from_numpy(p) for p in planes], flat


@pytest.mark.parametrize("kind", ["wrap", "colour wrap", "gray", "colour", "row", "row colour", "column",
                                  "column colour"])
def test_ui_check_matches_jax(kind):
    """Bytes 4 .. 12 of the tail (0 .. 8 with no button) are JAX's u32
    checksum; an all-255 4K plane wraps the weighted sum."""
    planes, flat = _planes(kind, np.random.default_rng(len(kind)))
    want = np.asarray(jpp._weighted_check(jnp.asarray(flat))).astype(np.uint32).tobytes()
    btn = torch.zeros((41, 255, 3), dtype=torch.uint8)
    assert K.hostpack_tail_plain(planes, btn).numpy()[4:12].tobytes() == want
    assert K.hostpack_tail(planes, None).numpy().tobytes() == want  # CPU: the twin
    if "wrap" in kind:
        h, w = flat.shape
        weights = np.outer(np.arange(1, h + 1, dtype=np.uint64), np.arange(7, w + 7, dtype=np.uint64))
        assert int((flat.astype(np.uint64) * weights).sum()) >= 2**32  # the weighted sum wrapped
    got = tpp._ui_check(planes).numpy()
    assert got.dtype == np.int64 and got.astype(np.uint32).tobytes() == want


@pytest.mark.parametrize("size", testing.RESOLUTIONS + ((3840, 2160),))
@pytest.mark.parametrize("red", ["none", "one", "all but one", "all"])
def test_red_gate_matches_jax(size, red):
    """Bytes 0 .. 4 of the tail are JAX's f32 red share of the close
    button at each screen size's button shape."""
    g = C.map_geometry(*size)
    n = g.btn_h * g.btn_w
    rng = np.random.default_rng(n)
    btn = rng.integers(0, 256, (g.btn_h, g.btn_w, 3), dtype=np.uint8)
    btn[np.all(np.abs(btn.astype(int) - BUTTON_RED) <= C.CLOSE_DEPLOYMENT_BUTTON_TOLERANCE, axis=-1)] = 0
    k = {"none": 0, "one": 1, "all but one": n - 1, "all": n}[red]
    btn.reshape(-1, 3)[rng.permutation(n)[:k]] = BUTTON_RED
    want = np.asarray(jpp._red_gate_roi(jnp.asarray(btn)))
    luma = torch.zeros((5, 7), dtype=torch.uint8)
    got = K.hostpack_tail((luma,), torch.from_numpy(btn))
    assert got.numpy()[:4].tobytes() == want.tobytes()
    assert float(got.numpy()[:4].view(np.float32)[0]) == np.float32(k) * (np.float32(1) / np.float32(n))


def test_batch_rows_equal_per_frame_calls():
    """B = 3 frames as views of one buffer's rows (planes, button and
    sections with odd frame strides): row i is frame i's tail, each section
    at its offset."""
    rng = np.random.default_rng(3)
    bsz, h, w, bh, bw = 3, 37, 53, 5, 7
    rows = torch.from_numpy(rng.integers(0, 256, (bsz, 3 * h * w + 3 * bh * bw + 5), dtype=np.uint8))
    planes = rows[:, : 3 * h * w].view(bsz, 3, h, w)
    btn = rows[:, 3 * h * w : 3 * h * w + 3 * bh * bw].view(bsz, bh, bw, 3)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (bsz, 11), dtype=np.int32))
    sections = [words.view(torch.uint8)[:, :24], rows[:, -5:], words.view(torch.uint8)[:, 24:]]
    for ui in ((planes[:, 2],), (planes[:, 2], planes[:, 1], planes[:, 0])):
        got = K.hostpack_tail(ui, btn, sections)
        assert got.shape == (bsz, 12 + 24 + 5 + 20)
        for i in range(bsz):
            one = K.hostpack_tail(tuple(p[i] for p in ui), btn[i], [s[i] for s in sections])
            assert torch.equal(got[i], one)
            assert torch.equal(got[i, 12:], torch.cat([s[i] for s in sections]))


def test_rejects_bad_inputs():
    luma = torch.zeros((4, 6), dtype=torch.uint8)
    btn = torch.zeros((2, 3, 3), dtype=torch.uint8)
    for args in (
        ((luma, luma), btn, ()),  # two planes
        ((luma.to(torch.int16),), btn, ()),
        ((luma,), btn[..., :2], ()),  # not BGR
        ((luma,), btn[None], ()),  # a batch of buttons for one frame
        ((luma,), btn, (torch.zeros((2, 4), dtype=torch.uint8),)),  # a section of another batch shape
        ((luma.to("meta"),), btn.to("meta"), ()),  # neither the CPU nor a card
    ):
        with pytest.raises(ValueError):
            K.hostpack_tail(*args)


# -- the fused pass's hostpack on every route ----------------------------------------

FW, FH = 641, 361  # map 275 x 329
G = C.map_geometry(FW, FH)
# (scales transport, sparse budget, window crop, scales band): the device read
# with sparse words, the window crop with the binary images, the gray and
# binary row bands with sparse words, checksum-only scales on the full plane.
ROUTES = {
    "device + sparse": ("device", 256, None, None),
    "window": ("binary", None, (96, 160), None),
    "binary band": ("binary", 256, None, 40),
    "gray band": ("gray", 256, None, 40),
    "none": ("none", None, None, None),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("grayscale", [True, False])
def test_hostpack_matches_jax_on_every_route(route, grayscale, monkeypatch):
    inline, sparse, crop, band = ROUTES[route]
    f = testing.make_frame(FW, FH, marker_lines=[((20, 30), (150, 90))], scale_texts=[("300m", (30, 60))],
                           scale_bars=[(30, 86, 60, 1)])
    mr = f[G.map_y : G.map_y + G.map_h, G.map_x : G.map_x + G.map_w]
    br = f[G.btn_y : G.btn_y + G.btn_h, G.btn_x : G.btn_x + G.btn_w]
    packed = cb._pack_rois_bgr(mr, br, cb._DELTA_CHUNK)
    kw = dict(map_h=G.map_h, map_w=G.map_w, btn_h=G.btn_h, btn_w=G.btn_w, grayscale=grayscale,
              scales_inline=inline, sparse_budget=sparse, crop_h=crop and crop[0], crop_w=crop and crop[1],
              scales_band=band)
    want = np.asarray(jax.device_get(jpp._analyze_packed_flat(packed, channels=3, **kw))["hostpack"])
    calls = []
    tail = K.hostpack_tail
    monkeypatch.setattr(K, "hostpack_tail", lambda *a: calls.append(a) or tail(*a))
    got = tpp.analyze_packed_flat(torch.from_numpy(packed), templates=sd.templates_to_device(sd.device_templates(),
                                                                                              "cpu"), **kw)
    assert len(calls) == 1  # one tail a pass
    layout = tpp.hostpack_layout(G.map_h, G.map_w, scales_inline=inline, sparse_budget=sparse,
                                 crop_h=kw["crop_h"], crop_w=kw["crop_w"], scales_band=band)
    assert got["hostpack"].numel() == layout["__total__"] == want.size
    np.testing.assert_array_equal(got["hostpack"].numpy(), want)


@pytest.mark.parametrize("variant", sorted(probe_hostpack.VARIANTS))
def test_probe_patches_apply(variant):
    """Each variant and ablation of probe_hostpack applies to the kernel
    source as it is, each of its texts exactly once, and changes it (except
    the unpatched build); the source names what it replaces."""
    text = (CSRC / "hostpack.cu").read_text()
    patches = probe_hostpack.VARIANTS[variant][0]
    src = text
    for old, new in patches:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert src == _probe.patched(CSRC, ("hostpack.cu",), {"hostpack.cu": list(patches)})["hostpack.cu"]
    assert (src == text) == (not patches)
    assert "smh_hostpack" in src and "_weighted_check" in src and "_red_gate_roi" in src


# -- the plan: what the wrapper builds once per shapes and strides ---------------------


def _recorded_tail(route: str, grayscale: bool, monkeypatch, bsz: int | None = None) -> tuple:
    """The inputs of the pass's one kernel 9 call on ROUTES[route] (a batch
    of bsz frames where given), and the layout its hostpack follows."""
    inline, sparse, crop, band = ROUTES[route]
    f = testing.make_frame(FW, FH, marker_lines=[((20, 30), (150, 90))], scale_texts=[("300m", (30, 60))],
                           scale_bars=[(30, 86, 60, 1)])
    mr = f[G.map_y : G.map_y + G.map_h, G.map_x : G.map_x + G.map_w]
    br = f[G.btn_y : G.btn_y + G.btn_h, G.btn_x : G.btn_x + G.btn_w]
    packed = torch.from_numpy(cb._pack_rois_bgr(mr, br, cb._DELTA_CHUNK))
    kw = dict(map_h=G.map_h, map_w=G.map_w, btn_h=G.btn_h, btn_w=G.btn_w, grayscale=grayscale,
              scales_inline=inline, sparse_budget=sparse, crop_h=crop and crop[0], crop_w=crop and crop[1],
              templates=sd.templates_to_device(sd.device_templates(), "cpu"))
    calls = []
    tail = K.hostpack_tail
    monkeypatch.setattr(K, "hostpack_tail", lambda *a: calls.append(a) or tail(*a))
    if bsz is None:
        tpp.analyze_packed_flat(packed, scales_band=band, **kw)
    else:
        tpp.analyze_batch_packed_flat(packed.repeat(bsz, 1), **kw)
    assert len(calls) == 1
    layout = tpp.hostpack_layout(G.map_h, G.map_w, scales_inline=inline, sparse_budget=sparse,
                                 crop_h=kw["crop_h"], crop_w=kw["crop_w"], scales_band=band)
    return calls[0], layout


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("grayscale", [True, False])
def test_plan_offsets_match_hostpack_layout(route, grayscale, monkeypatch):
    """The plan of the pass's tail on every route puts the red ratio and the
    ui checksum at hostpack_layout's offsets, starts each section on one of
    the layout's section boundaries (a part may hold several sections, as
    the sparse words' nz, idx and dat), and ends the row at its total; its
    table holds each section's offset and bytes with no address."""
    (ui, btn, sections), layout = _recorded_tail(route, grayscale, monkeypatch)
    plan = K.hostpack_plan_for(ui, btn, sections)
    assert (plan.red_off, plan.ui_off) == (layout["red_ratio"][0], layout["ui_check"][0])
    assert plan.row == layout["__total__"]
    starts = {v[0] for name, v in layout.items() if name != "__total__"}
    assert set(plan.offsets) <= starts and plan.offsets[0] == layout["lsd_meta"][0]
    assert plan.n_ui == len(ui) and (plan.h, plan.w) == tuple(ui[0].shape[-2:])
    assert plan.btn_px == G.btn_h * G.btn_w and plan.bsz == 1 and plan.lead == ()
    for k, i in enumerate(plan.keep):
        assert plan.table[4 * k : 4 * k + 4] == (0, 0, plan.offsets[k], sections[i].shape[-1])


@pytest.mark.parametrize("bsz", [2, 3])
def test_plan_of_a_batch(bsz, monkeypatch):
    """A batch's plan: the sections' and the button's frame strides, the ui
    planes' frame stride, the row the per-frame layout's."""
    (ui, btn, sections), layout = _recorded_tail("device + sparse", True, monkeypatch, bsz=bsz)
    plan = K.hostpack_plan_for(ui, btn, sections)
    assert plan.bsz == bsz and plan.lead == (bsz,) and plan.row == layout["__total__"]
    assert plan.stride == ui[0].stride(0) and plan.btn_stride == btn.stride(0)
    for k, i in enumerate(plan.keep):
        assert plan.table[4 * k + 1] == sections[i].stride(0)


def test_plan_is_reused_and_rebuilt_on_a_shape_change():
    """The same shapes and strides find the same plan; another section size,
    plane shape, plane stride or button shape builds another, whose offsets
    follow the new sizes (none is stale), and hostpack_plan is a pure
    function of the shapes and strides."""
    rng = np.random.default_rng(9)

    def inputs(h, w, sizes, bh=5, pad=0):
        plane = torch.from_numpy(rng.integers(0, 256, (h, w + pad), dtype=np.uint8))[:, :w]
        btn = torch.zeros((bh, 7, 3), dtype=torch.uint8)
        return (plane,), btn, [torch.zeros(n, dtype=torch.uint8) for n in sizes]

    a = K.hostpack_plan_for(*inputs(37, 53, (24, 16, 5)))
    assert K.hostpack_plan_for(*inputs(37, 53, (24, 16, 5))) is a
    assert a.offsets == (12, 36, 52) and a.row == 57
    b = K.hostpack_plan_for(*inputs(37, 53, (24, 17, 5)))
    assert b is not a and b.offsets == (12, 36, 53) and b.row == 58
    c = K.hostpack_plan_for(*inputs(38, 53, (24, 16, 5)))
    assert c is not a and (c.h, c.pitch) == (38, 53)
    d = K.hostpack_plan_for(*inputs(37, 53, (24, 16, 5), pad=3))
    assert d is not a and d.pitch == 56
    e = K.hostpack_plan_for(*inputs(37, 53, (24, 16, 5), bh=6))
    assert e is not a and e.btn_px == 42
    f = K.hostpack_plan_for(inputs(37, 53, ())[0], None, [torch.zeros(n, dtype=torch.uint8) for n in (0, 4)])
    assert (f.red_off, f.ui_off, f.keep, f.offsets, f.row) == (-1, 0, (1,), (8,), 12)
    args = ((37, 53), (53, 1), 1, (5, 7, 3), (21, 3, 1), (((24,), (1,)), ((16,), (1,))))
    assert K.hostpack_plan(*args) == K.hostpack_plan(*args) == a._replace(offsets=(12, 36), row=52, table=a.table[:8],
                                                                         keep=(0, 1))


def test_plan_rejects_what_the_kernel_does_not_take():
    luma = torch.zeros((4, 6), dtype=torch.uint8)
    btn = torch.zeros((2, 3, 3), dtype=torch.uint8)
    one = torch.zeros((1,), dtype=torch.uint8)
    for args in (
        ((luma,), btn, [torch.zeros((8,), dtype=torch.uint8)[::2]]),  # a section's bytes not contiguous
        ((luma,), btn, [one] * (K.HOSTPACK_MAX_SECTIONS + 1)),  # too many sections
        ((luma,), btn.transpose(0, 1), []),  # the button's pixels not BGR rows
        ((luma, luma.t().contiguous().t(), luma), btn, []),  # planes of other strides
        ((luma.to(torch.int16),), btn, []),  # not u8 (as _tail_inputs)
        ((torch.zeros((0, 6), dtype=torch.uint8),), btn, []),  # empty
    ):
        with pytest.raises(ValueError):
            K.hostpack_plan_for(*args)
