"""The kernel wrappers of smh_tpu_torch/ops/kernels.py on CPU tensors: the
plain twins against the JAX package, a numpy restatement of the quiet-walk
kernel (its cleared-bit run words and index-reduction walks) against the
plain twin and the Pallas kernel in interpret mode, the launch counters,
and the wrappers' input checks. (The CUDA kernels themselves are held
against these twins on the card by chip_smoke.py.)"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import pallas_kernels as pk
from smh_tpu.ops import pipeline as opp
from smh_tpu_torch import probe_classify
from smh_tpu_torch import probe_ray_march
from smh_tpu_torch import probe_scales_read
from smh_tpu_torch import probe_quiet_walk as probe
from smh_tpu_torch.ops import kernels
from smh_tpu_torch.ops import pipeline as tpp

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
TH = kernels.QUIET_TILE_H


def _views(rng, bsz: int, h: int, w: int, trial: int) -> np.ndarray:
    """Random BGR maps: a quiet box over the centre, a smaller quiet box,
    and a minimap-like layout (edgy centre inside a quiet surround)."""
    views = rng.integers(0, 256, (bsz, h, w, 3), dtype=np.uint8)
    for i in range(bsz):
        kind = (trial + i) % 3
        if kind == 0:
            views[i, h // 8 : h // 8 + 3 * h // 4, w // 8 : w // 8 + 3 * w // 4] = 120 + trial
        elif kind == 1:
            views[i, h // 4 : h // 4 + h // 2, w // 4 : w // 4 + w // 2] = 121 + trial
        else:
            inner = views[i, h // 5 : h - h // 5, w // 5 : w - w // 5].copy()
            views[i] = 90 + trial
            views[i, h // 5 : h - h // 5, w // 5 : w - w // 5] = inner
    return views


def _planes(views):
    return [torch.from_numpy(np.ascontiguousarray(views[..., c])) for c in range(3)]


_jax_rects = jax.jit(jax.vmap(lambda p0, p1, p2: opp._minimap_rect(opp._edgy_quiet_planes(p0, p1, p2))))


def _jax_rect_batch(views):
    """JAX reference rects [B, 4] (XLA path) for BGR views [B, H, W, 3]."""
    return np.asarray(_jax_rects(*(jnp.asarray(views[..., c]) for c in range(3))))


def _schedule(t: int) -> list:
    """The height schedule of tests/test_scales_device.py:202-207 around a
    tile height t."""
    return [int(0.7 * t), t + 3, int(2.4 * t) + 1, 4 * t - 5]


# Around the first CUDA kernel's 8-row tiles, the TPU kernel's bands and the
# CUDA kernel's tile height.
HEIGHTS = _schedule(8) + _schedule(pk.QBAND_H) + _schedule(TH)


@pytest.mark.parametrize("trial,h", list(enumerate(HEIGHTS)))
def test_plain_minimap_rect_matches_jax(trial, h):
    rng = np.random.default_rng(100 + trial)
    w = int(rng.integers(40, 260)) | 1  # odd widths
    views = _views(rng, 3, h, w, trial)
    before = dict(kernels.LAUNCHES)
    got = kernels.minimap_rect_planes(*_planes(views))
    assert kernels.LAUNCHES == before  # CPU tensors never launch
    assert got.dtype == torch.int32 and got.shape == (3, 4)
    assert got.tolist() == _jax_rect_batch(views).tolist(), (h, w)


def _gate_zero(lo: int, hi: int, dim: int) -> bool:
    """The walk's run-bound rule: a non-empty run outside [3, dim-3]
    qualifies nothing."""
    return hi > lo and (lo < 3 or hi - 1 > dim - 3)


def _kernel_restatement(views: np.ndarray) -> np.ndarray:
    """numpy restatement of csrc/quiet_walk.cu on BGR views [B, H, W, 3]:
    the channel-summed SAD saturates at 255 (byte SIMD), the run words hold
    the CLEARED bits (a non-quiet pixel inside a range), merged with OR from
    zero; the walks are index reductions over the gated qualifiers. -> i32
    [B, 4] (left, top, right, bottom)."""
    bsz, h, w, _ = views.shape
    v = views.astype(np.int32)
    quiet = np.zeros((bsz, h, w), dtype=bool)
    if h >= 3 and w >= 3:
        m = np.zeros((bsz, h - 2, w - 2), dtype=np.int32)  # bytewise max of the saturated SADs
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    d = np.abs(v[:, 1:-1, 1:-1] - v[:, 1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx])
                    m = np.maximum(m, np.minimum(np.minimum(d[..., 0] + d[..., 1], 255) + d[..., 2], 255))
        quiet[:, 1:-1, 1:-1] = m <= 7
    cy, cx = h // 2, w // 2
    lv, lh = (h - cy) // 2 - 1, (w - cx) // 2 - 1
    ys, xs = np.arange(h)[None, :, None], np.arange(w)[None, None, :]

    def cleared(in_range, axis):
        return (~quiet & in_range).any(axis=axis).astype(np.int32)

    col = (cleared((ys >= cy + 1) & (ys < cy + 1 + lv), 1) | 2 * cleared((ys >= cy - lv) & (ys < cy), 1)
           | 4 * cleared(ys == cy, 1))  # [B, W]
    row = (cleared((xs >= cx + 1) & (xs < cx + 1 + lh), 2) | 2 * cleared((xs >= cx - lh) & (xs < cx), 2)
           | 4 * cleared(xs == cx, 2))  # [B, H]
    down0, up0 = _gate_zero(cy + 1, cy + 1 + lv, h), _gate_zero(cy - lv, cy, h)
    right0, left0 = _gate_zero(cx + 1, cx + 1 + lh, w), _gate_zero(cx - lh, cx, w)
    x, y = np.arange(w), np.arange(h)
    out = []
    for cw, rw in zip(col, row):
        cq, rq = (cw & 4) == 0, (rw & 4) == 0
        left = x[cq & ((cw & 1) == 0) & (not down0) & (x >= 3) & (x < cx)]
        right = x[cq & ((cw & 2) == 0) & (not up0) & (x >= cx + 1) & (x <= w - 3)]
        top = y[rq & ((rw & 1) == 0) & (not right0) & (y >= 3) & (y < cy)]
        bottom = y[rq & ((rw & 2) == 0) & (not left0) & (y >= cy + 1) & (y <= h - 3)]
        out.append([
            max(left.tolist(), default=-1) + 1, max(top.tolist(), default=-1) + 1,
            min(right.tolist(), default=w) - 1, min(bottom.tolist(), default=h) - 1,
        ])
    return np.asarray(out, dtype=np.int32).reshape(bsz, 4)


def _pallas_rects(views: np.ndarray) -> np.ndarray:
    """JAX's quiet-walk Pallas kernel in interpret mode, one map at a time."""
    return np.stack([
        np.asarray(pk.minimap_rect_pallas_planes(*(jnp.asarray(m[..., c]) for c in range(3)), interpret=True))
        for m in views
    ])


@pytest.mark.parametrize("trial,h", list(enumerate([11, 27, 151, 822])))
def test_rect_from_kernel_words_matches_jax(trial, h):
    """The kernel's cleared-bit words and index-reduction walks (restated in
    numpy) give the JAX rect and the plain twin's."""
    rng = np.random.default_rng(200 + trial)
    w = 986 if h == 822 else int(rng.integers(40, 300)) | 1
    views = _views(rng, 2, h, w, trial)
    got = _kernel_restatement(views)
    assert got.tolist() == _jax_rect_batch(views).tolist(), (h, w)
    assert got.tolist() == kernels.minimap_rect_planes_plain(*_planes(views)).tolist(), (h, w)


def _edge_case(name: str) -> np.ndarray:
    """BGR views [2, H, W, 3] for the walk's gate edge cases."""
    rng = np.random.default_rng(300 + EDGE_CASES.index(name))
    shapes = {
        "h_below_8": (5, 40), "w_below_8": (40, 6), "tiny": (3, 3), "one_row": (1, 9),
        "up_run_lo_below_3": (7, 50), "runs_empty": (6, 33), "all_quiet": (45, 70), "all_edgy": (45, 70),
        "tile_seams": (TH + 1, kernels.QUIET_TILE_W + 1),
    }
    h, w = shapes[name]
    if name == "all_quiet":
        views = np.empty((2, h, w, 3), np.uint8)
        views[0], views[1] = 77, 200
    elif name == "all_edgy":
        views = np.zeros((2, h, w, 3), np.uint8)
        views[:, ::2, ::2] = views[:, 1::2, 1::2] = 255  # every neighbourhood holds a 765 SAD
    else:
        views = _views(rng, 2, h, w, 0)
        views[1] = 120  # a quiet map of the same shape
    return views


EDGE_CASES = ["h_below_8", "w_below_8", "tiny", "one_row", "up_run_lo_below_3", "runs_empty",
              "all_quiet", "all_edgy", "tile_seams"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_kernel_restatement_gate_edge_cases(name):
    """Maps smaller than 8 px, a run range that starts below 3, empty run
    ranges (hi <= lo), an all-quiet and an all-edgy map: the restatement is
    bit-equal to the plain twin and to the Pallas kernel in interpret mode."""
    views = _edge_case(name)
    h, w = views.shape[1:3]
    cy, cx = h // 2, w // 2
    lv, lh = (h - cy) // 2 - 1, (w - cx) // 2 - 1
    if name == "up_run_lo_below_3":
        assert _gate_zero(cy - lv, cy, h) and cy - lv < 3
    if name == "runs_empty":
        assert lv <= 0 < lh
    got = _kernel_restatement(views)
    assert got.tolist() == kernels.minimap_rect_planes_plain(*_planes(views)).tolist()
    assert got.tolist() == _pallas_rects(views).tolist()
    if name == "all_edgy":
        assert got.tolist() == [[0, 0, w - 1, h - 1]] * 2
    if name == "all_quiet":
        assert got.tolist() == [[cx, cy, cx, cy]] * 2


def test_build_command_compiles_the_csrc_files_for_sm90a():
    """One nvcc per source (started together), each for sm_90a with the
    csrc headers on the include path, then one link into the .so."""
    from smh_tpu_torch import _build

    srcs = _build.sources()
    assert {p.name for p in srcs} == {
        "classify_luma.cu", "quiet_walk.cu", "fused_mask.cu", "ray_march.cu", "scales_read.cu",
        "brq_preprocess.cu", "mask_words.cu", "delta_apply.cu", "hostpack.cu", "window_crop.cu", "ocr_band.cu",
    }
    assert {p.name for p in _build.headers()} == {"classify.cuh"}
    assert all(p.parent == CSRC for p in srcs)
    objdir = pathlib.Path("obj")
    cmds = _build.compile_commands(objdir)
    assert len(cmds) == len(srcs)
    for src, cmd in zip(srcs, cmds):
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-O3" in cmd and "-c" in cmd and str(src) in cmd
        assert cmd[cmd.index("-I") + 1] == str(CSRC)
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    link = _build.link_command(pathlib.Path("x.so"), objdir)
    assert "-shared" in link
    assert all(str(objdir / f"{p.stem}.o") in link for p in srcs)
    lib = _build.lib_path()
    assert lib.parent.parent == _build.BUILD_ROOT and lib.parent.name == _build.source_hash()


def test_quiet_tile_height_matches_the_cuda_source():
    src = (CSRC / "quiet_walk.cu").read_text()
    assert int(re.search(r"constexpr int TH = (\d+);", src).group(1)) == TH
    assert int(re.search(r"constexpr int TW = (\d+);", src).group(1)) == kernels.QUIET_TILE_W


@pytest.mark.parametrize("variant", sorted(probe.VARIANTS))
def test_quiet_walk_probe_patches_apply(variant):
    """Each ablation of the probe applies to the kernel source as it is, and
    changes it (except the unpatched build)."""
    src = probe.patched(probe.VARIANTS[variant])
    assert (src == (CSRC / "quiet_walk.cu").read_text()) == (not probe.VARIANTS[variant])
    assert "smh_quiet_walk" in src and "__global__" in src


@pytest.mark.parametrize("variant", sorted(probe_classify.VARIANTS))
def test_classify_probe_patches_apply(variant):
    """Each variant of the classify / fused mask probe applies to the
    sources as they are, and changes them (except the unpatched build)."""
    texts = probe_classify.patched(CSRC, probe_classify.VARIANTS[variant])
    same = all(texts[name] == (CSRC / name).read_text() for name in texts)
    assert same == (not probe_classify.VARIANTS[variant])
    assert "smh_classify_luma" in texts["classify_luma.cu"] and "smh_fused_mask" in texts["fused_mask.cu"]


@pytest.mark.parametrize("variant", sorted(probe_ray_march.VARIANTS))
def test_ray_march_probe_patches_apply(variant):
    """Each variant, check and ablation of the ray march probe applies to
    the source as it is, and changes it (except the unpatched build)."""
    src = probe_ray_march.patched(CSRC, probe_ray_march.VARIANTS[variant])["ray_march.cu"]
    assert (src == (CSRC / "ray_march.cu").read_text()) == (not probe_ray_march.VARIANTS[variant])
    assert "smh_ray_march" in src and "__global__" in src


@pytest.mark.parametrize("variant", sorted(probe_scales_read.VARIANTS))
def test_scales_read_probe_patches_apply(variant):
    """Each variant and ablation of the scales read probe applies to the
    source as it is, each of its texts exactly once in the text the patches
    before it left, and changes it (except the unpatched build)."""
    text = (CSRC / "scales_read.cu").read_text()
    src = text
    for old, new in probe_scales_read.VARIANTS[variant]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert src == probe_scales_read.patched(CSRC, probe_scales_read.VARIANTS[variant])["scales_read.cu"]
    assert (src == text) == (not probe_scales_read.VARIANTS[variant])
    assert "smh_scales_read" in src and "__global__" in src


def test_scales_read_probe_phases_open_at_top_level():
    """The cumulative ablations stop the kernel where each phase opens: one
    top-level comment per phase, in order, in the kernel's body."""
    text = (CSRC / "scales_read.cu").read_text()
    body = text[text.index("scales_read_kernel("):]
    at = [body.index(f"\n  // {k}. ") for k in sorted(probe_scales_read.PHASES)]
    assert at == sorted(at) and all(text.count(f"\n  // {k}. ") == 1 for k in probe_scales_read.PHASES)


def test_sources_note_the_kernels_they_replace():
    assert "_classify_luma_kernel" in (CSRC / "classify_luma.cu").read_text()
    assert "_quiet_walk_kernel_factory" in (CSRC / "quiet_walk.cu").read_text()
    assert "_march_span" in (CSRC / "ray_march.cu").read_text()


def test_classify_launch_counter_untouched_on_cpu():
    kernels.reset_launches()
    p = torch.zeros((5, 7), dtype=torch.uint8)
    kernels.classify_luma_planes(p, p, p)
    kernels.minimap_rect_planes(p[None], p[None], p[None])
    kernels.fused_mask_bits(p, p, p)
    from smh_tpu_torch.ops import lsd as tlsd

    cos_t, sin_t = tlsd.theta_tables("cpu")
    tlsd.ray_march(p, torch.tensor([[2.0, 3.0]]), 2, tlsd.SPAN0, cos_t, sin_t)
    from smh_tpu_torch.ops import scales_device as tsd

    tsd.scales_records(p != 0, p != 0, torch.zeros((1, tsd.GLYPH_H * tsd.GLYPH_W)))
    kernels.brq_preprocess(p, p, p, p)
    kernels.mask_bbox_sparse(p[:, :1], 7, 4)
    kernels.delta_apply(torch.zeros(64, dtype=torch.uint8), torch.zeros(16 * 36, dtype=torch.uint8), 16, 32)
    kernels.hostpack_tail((p,), torch.zeros((2, 3, 3), dtype=torch.uint8), [p[0]])
    kernels.window_crop(p[:, :1], torch.zeros(7, dtype=torch.int32), 7, 3, 4, 2)
    kernels.ocr_band(p, p[:, :1], p, "binary", 3)
    assert kernels.LAUNCHES == {
        "classify_luma": 0, "quiet_walk": 0, "fused_mask": 0, "ray_march": 0, "scales_read": 0,
        "brq_preprocess": 0, "mask_words": 0, "delta_apply": 0, "hostpack": 0, "window_crop": 0, "ocr_band": 0,
    }


def test_wrappers_reject_bad_inputs():
    u8 = torch.zeros((4, 6), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.classify_luma_planes(u8, u8, u8.to(torch.int32))
    with pytest.raises(ValueError):
        kernels.classify_luma_planes(u8, u8, u8[:3])
    with pytest.raises(ValueError):
        kernels.minimap_rect_planes(u8, u8, u8)  # needs [B, H, W]
    meta = torch.zeros((4, 6), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        kernels.classify_luma_planes(meta, meta, meta)


def test_source_hash_moves_with_a_shared_header(tmp_path, monkeypatch):
    """A change to csrc/*.cuh alone must select a new build directory, or
    the kernels would load a stale library."""
    from smh_tpu_torch import _build

    for src in _build.sources() + _build.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.source_hash()
    header = tmp_path / "classify.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.source_hash() != before
    assert _build.lib_path().parent.name == _build.source_hash()
