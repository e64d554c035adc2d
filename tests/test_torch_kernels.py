"""The kernel wrappers of smh_tpu_torch/ops/kernels.py on CPU tensors: the
plain twins against the JAX package, the quiet-walk kernel's bit-word tail,
the launch counters, and the wrappers' input checks. (The CUDA kernels
themselves are held against these twins on the card by chip_smoke.py.)"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import pallas_kernels as pk
from smh_tpu.ops import pipeline as opp
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


# The height schedule of tests/test_scales_device.py:202-207, on the CUDA
# kernel's tile height and on the TPU kernel's band height.
HEIGHTS = [int(0.7 * TH), TH + 3, int(2.4 * TH) + 1, 4 * TH - 5] + [
    int(0.7 * pk.QBAND_H), pk.QBAND_H + 3, int(2.4 * pk.QBAND_H) + 1, 4 * pk.QBAND_H - 5,
]


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


def _kernel_words(quiet: torch.Tensor):
    """What csrc/quiet_walk.cu writes for a quiet mask [B, H, W]: the 3-bit
    column and row words (AND identity 7 for empty ranges)."""
    bsz, h, w = quiet.shape
    cy, lv, cx, lh = kernels._run_lengths(h, w)

    def all_or_true(t, dim):
        if t.shape[dim] == 0:
            shape = list(t.shape)
            del shape[dim]
            return torch.ones(shape, dtype=torch.bool)
        return t.all(dim=dim)

    col = (
        all_or_true(quiet[:, cy + 1 : cy + 1 + lv], 1).int()
        + 2 * all_or_true(quiet[:, max(cy - lv, 0) : cy], 1).int()
        + 4 * quiet[:, cy].int()
    )
    row = (
        all_or_true(quiet[:, :, cx + 1 : cx + 1 + lh], 2).int()
        + 2 * all_or_true(quiet[:, :, max(cx - lh, 0) : cx], 2).int()
        + 4 * quiet[:, :, cx].int()
    )
    return col, row


@pytest.mark.parametrize("trial,h", list(enumerate([TH + 3, 4 * TH - 5, 151, 822])))
def test_rect_from_kernel_words_matches_jax(trial, h):
    """The wrapper's PyTorch tail (bound_gate + walks) on the bit words the
    kernel produces gives the JAX rect."""
    rng = np.random.default_rng(200 + trial)
    w = 986 if h == 822 else int(rng.integers(40, 300)) | 1
    views = _views(rng, 2, h, w, trial)
    quiet = tpp._edgy_quiet_planes(*_planes(views))
    col, row = _kernel_words(quiet)
    got = kernels.rect_from_bits(col, row, h, w)
    assert got.tolist() == _jax_rect_batch(views).tolist(), (h, w)


def test_build_command_compiles_the_csrc_files_for_sm90a():
    """One nvcc per source (started together), each for sm_90a with the
    csrc headers on the include path, then one link into the .so."""
    from smh_tpu_torch import _build

    srcs = _build.sources()
    assert {p.name for p in srcs} == {"classify_luma.cu", "quiet_walk.cu", "fused_mask.cu", "ray_march.cu"}
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
    assert kernels.LAUNCHES == {"classify_luma": 0, "quiet_walk": 0, "fused_mask": 0, "ray_march": 0}


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
