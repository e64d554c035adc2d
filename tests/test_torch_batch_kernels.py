"""The batched entries of kernels 1-3 (ops/kernels.py on [B, H, W] planes)
on the CPU: their plain paths against the JAX package's Pallas kernels in
interpret mode (classify, and the quiet walk under jax.vmap, the batch
pipeline's route) and against the port's per-frame calls, frame by frame, on
planes cut from the rows of a [B, padded] buffer as the batched pass cuts
them: at B = 1 and 3, with even and odd frame strides. Then the wrappers'
checks of a batch's layout. (The CUDA kernels are held against these plain
paths on the card by chip_smoke.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smh_tpu.ops import pallas_kernels as pk
from smh_tpu_torch.ops import kernels
from smh_tpu_torch.vision import pixmath

torch.set_num_threads(1)

# (B, H, W, bytes past the 3 planes in each row: the frame stride is
# 3 * H * W + extra, odd where extra is odd)
CASES = [(1, 37, 50, 0), (3, 37, 50, 0), (3, 37, 50, 37), (3, 45, 70, 128), (2, 6, 33, 5)]


def _rows(rng, bsz: int, h: int, w: int, extra: int) -> np.ndarray:
    """u8 [B, 3 * H * W + extra] rows: B, G, R planes of maps with a quiet
    box (the minimap walk finds edges) and marker-coloured pixels."""
    views = rng.integers(0, 256, (bsz, h, w, 3), dtype=np.uint8)
    for i in range(bsz):
        views[i, h // 4 : h - h // 4, w // 4 : w - w // 4] = 100 + 10 * i
        views[i, rng.random((h, w)) < 0.08] = (64, 255, 0)  # the alpha fireteam's BGR
    rows = rng.integers(0, 256, (bsz, 3 * h * w + extra), dtype=np.uint8)
    rows[:, : 3 * h * w] = np.moveaxis(views, -1, 1).reshape(bsz, -1)
    return rows


def _planes(rows: np.ndarray, h: int, w: int):
    """(b, g, r) [B, H, W] views of the rows, strided by frame."""
    t = torch.from_numpy(rows)
    planes = t[:, : 3 * h * w].view(t.shape[0], 3, h, w)
    return planes[:, 0], planes[:, 1], planes[:, 2]


@pytest.mark.parametrize("bsz,h,w,extra", CASES)
def test_batched_classify_equals_per_frame_and_pallas(bsz, h, w, extra):
    rng = np.random.default_rng(bsz * 100 + extra)
    rows = _rows(rng, bsz, h, w, extra)
    b8, g8, r8 = _planes(rows, h, w)
    assert b8.stride(0) == 3 * h * w + extra
    marker, luma = kernels.classify_luma_planes(r8, g8, b8)
    assert marker.shape == luma.shape == (bsz, h, w)
    jm, jl = jax.vmap(lambda r, g, b: pk.classify_luma_pallas_planes(r, g, b, interpret=True))(
        *(jnp.asarray(p.numpy()) for p in (r8, g8, b8))
    )
    for i in range(bsz):
        m1, l1 = kernels.classify_luma_planes(r8[i], g8[i], b8[i])
        assert torch.equal(marker[i], m1) and torch.equal(luma[i], l1)
        rgb = np.stack([p[i].numpy() for p in (r8, g8, b8)], axis=-1)
        np.testing.assert_array_equal(marker[i].numpy().astype(bool), pixmath.is_any_map_marker_color(rgb))
        np.testing.assert_array_equal(luma[i].numpy(), pixmath.luma8(rgb))
        # The Pallas kernel may flip a truncated value through FMA
        # contraction (tests/test_pallas.py:21-26); the port is exact.
        assert (marker[i].numpy() == np.asarray(jm[i])).mean() > 0.999
        assert (np.abs(luma[i].numpy().astype(int) - np.asarray(jl[i]).astype(int)) <= 1).all()
    assert marker.numpy().any()


@pytest.mark.parametrize("bsz,h,w,extra", CASES)
def test_batched_fused_mask_equals_per_frame(bsz, h, w, extra):
    rows = _rows(np.random.default_rng(7 + extra), bsz, h, w, extra)
    b8, g8, r8 = _planes(rows, h, w)
    bits = kernels.fused_mask_bits(r8, g8, b8)
    assert bits.shape == (bsz, h, (w + 7) // 8)
    for i in range(bsz):
        assert torch.equal(bits[i], kernels.fused_mask_bits(r8[i], g8[i], b8[i]))
        assert torch.equal(bits[i], kernels.fused_mask_bits_plain(r8[i].clone(), g8[i].clone(), b8[i].clone()))
    assert bits.numpy().any()


@pytest.mark.parametrize("bsz,h,w,extra", CASES)
def test_batched_quiet_walk_equals_per_frame_and_vmapped_pallas(bsz, h, w, extra):
    rows = _rows(np.random.default_rng(11 + extra), bsz, h, w, extra)
    b8, g8, r8 = _planes(rows, h, w)
    rects = kernels.minimap_rect_planes(b8, g8, r8)
    assert rects.shape == (bsz, 4) and rects.dtype == torch.int32
    for i in range(bsz):
        assert torch.equal(rects[i : i + 1], kernels.minimap_rect_planes(b8[i : i + 1], g8[i : i + 1], r8[i : i + 1]))
    # smh_tpu's batch pipeline vmaps the per-frame pass: custom_vmap sends
    # the quiet walk to its natively batched kernel.
    want = jax.vmap(lambda p0, p1, p2: pk.minimap_rect_pallas_planes(p0, p1, p2, interpret=True))(
        *(jnp.asarray(p.numpy()) for p in (b8, g8, r8))
    )
    np.testing.assert_array_equal(rects.numpy(), np.asarray(want))


def test_batched_calls_launch_nothing_on_the_cpu():
    rows = _rows(np.random.default_rng(3), 3, 20, 24, 9)
    planes = _planes(rows, 20, 24)
    kernels.reset_launches()
    kernels.classify_luma_planes(*planes)
    kernels.fused_mask_bits(*planes)
    kernels.minimap_rect_planes(*planes)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_frame_stride_takes_strided_frames_and_refuses_bad_layouts():
    """A batch's frames may lie any stride >= H * W apart (what a CUDA
    wrapper passes its kernel), but each frame must be contiguous and the
    three planes must share the stride."""
    rows = np.zeros((3, 3 * 20 * 24 + 9), dtype=np.uint8)
    b8, g8, r8 = _planes(rows, 20, 24)
    assert kernels._frame_stride((r8, g8, b8)) == 3 * 20 * 24 + 9
    assert kernels._frame_stride((r8[:1], g8[:1], b8[:1])) == 20 * 24
    assert kernels._frame_stride((r8[0], g8[0], b8[0])) == 20 * 24
    with pytest.raises(ValueError, match="contiguous"):
        kernels._frame_stride((r8[:, :, ::2],) * 3)
    with pytest.raises(ValueError, match="stride"):
        kernels._frame_stride((r8, g8, torch.zeros((3, 20, 24), dtype=torch.uint8)))
    overlapping = torch.zeros(20 * 24 + 100, dtype=torch.uint8).as_strided((3, 20, 24), (50, 24, 1))
    with pytest.raises(ValueError, match="stride"):
        kernels._frame_stride((overlapping,) * 3)
    with pytest.raises(ValueError):
        kernels.classify_luma_planes(r8, g8, b8[:2])
    with pytest.raises(ValueError):
        kernels.fused_mask_bits(r8[None], g8[None], b8[None])  # rank 4
    meta = torch.zeros((2, 4, 6), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        kernels.minimap_rect_planes(meta, meta, meta)
